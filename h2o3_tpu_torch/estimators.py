"""h2o-py estimator names (counterpart of h2o3_tpu/estimators.py).

Reference: h2o-py/h2o/estimators/*.py, one class per algo whose
constructor takes the algo's parameters and whose train(x, y,
training_frame) launches the build. The port's builders already follow
that contract, so each name is its builder class. Resolution is lazy:
naming one estimator imports only its own algo module.
"""

from __future__ import annotations

import importlib

# estimator name -> (module, class)
_MAP = {
    "H2OAggregatorEstimator": ("h2o3_tpu_torch.models.aggregator",
                               "Aggregator"),
    "H2OCoxProportionalHazardsEstimator": ("h2o3_tpu_torch.models.coxph",
                                           "CoxPH"),
    "H2ODeepLearningEstimator": ("h2o3_tpu_torch.models.deeplearning",
                                 "DeepLearning"),
    "H2OStackedEnsembleEstimator": ("h2o3_tpu_torch.models.ensemble",
                                    "StackedEnsemble"),
    "H2OExtendedIsolationForestEstimator": (
        "h2o3_tpu_torch.models.extended_isofor", "ExtendedIsolationForest"),
    "H2OGeneralizedAdditiveEstimator": ("h2o3_tpu_torch.models.gam", "GAM"),
    "H2OGeneralizedLinearEstimator": ("h2o3_tpu_torch.models.glm", "GLM"),
    "H2OGeneralizedLowRankEstimator": ("h2o3_tpu_torch.models.glrm", "GLRM"),
    "H2OGenericEstimator": ("h2o3_tpu_torch.models.generic", "Generic"),
    "H2OIsotonicRegressionEstimator": ("h2o3_tpu_torch.models.isotonic",
                                       "IsotonicRegression"),
    "H2OKMeansEstimator": ("h2o3_tpu_torch.models.kmeans", "KMeans"),
    "H2ONaiveBayesEstimator": ("h2o3_tpu_torch.models.naive_bayes",
                               "NaiveBayes"),
    "H2OPrincipalComponentAnalysisEstimator": ("h2o3_tpu_torch.models.pca",
                                               "PCA"),
    "H2OSupportVectorMachineEstimator": ("h2o3_tpu_torch.models.psvm",
                                         "PSVM"),
    "H2ORuleFitEstimator": ("h2o3_tpu_torch.models.rulefit", "RuleFit"),
    "H2OSingularValueDecompositionEstimator": ("h2o3_tpu_torch.models.svd",
                                               "SVD"),
    "H2OTargetEncoderEstimator": ("h2o3_tpu_torch.models.target_encoder",
                                  "TargetEncoder"),
    "H2ORandomForestEstimator": ("h2o3_tpu_torch.models.tree.drf", "DRF"),
    "H2OGradientBoostingEstimator": ("h2o3_tpu_torch.models.tree.gbm",
                                     "GBM"),
    "H2OIsolationForestEstimator": ("h2o3_tpu_torch.models.tree.isofor",
                                    "IsolationForest"),
    "H2OWord2vecEstimator": ("h2o3_tpu_torch.models.word2vec", "Word2Vec"),
    "H2OXGBoostEstimator": ("h2o3_tpu_torch.models.xgboost", "XGBoost"),
}


def __getattr__(name: str):
    if name == "H2OAutoEncoderEstimator":
        base = __getattr__("H2ODeepLearningEstimator")

        class H2OAutoEncoderEstimator(base):
            """DeepLearning with autoencoder=True (h2o-py parity)."""

            def __init__(self, **params):
                params.setdefault("autoencoder", True)
                super().__init__(**params)

        globals()[name] = H2OAutoEncoderEstimator
        return H2OAutoEncoderEstimator
    entry = _MAP.get(name)
    if entry is None:
        raise AttributeError(
            f"module 'h2o3_tpu_torch.estimators' has no attribute {name!r}")
    mod, cls_name = entry
    cls = getattr(importlib.import_module(mod), cls_name)
    globals()[name] = cls      # cached for the next access
    return cls


def __dir__():
    return sorted(list(globals()) + list(_MAP) + ["H2OAutoEncoderEstimator"])
