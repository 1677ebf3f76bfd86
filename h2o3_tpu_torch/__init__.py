"""h2o3_tpu_torch — the PyTorch/CUDA port of h2o3_tpu for one NVIDIA H100.

    import h2o3_tpu_torch as h2o
    h2o.init()                      # the CUDA device; device="cpu" on a CPU
    fr = h2o.import_file("data.csv")   # an H2OFrame in the DKV
    fr["x"].mean(); fr["x"].median(); fr[fr["x"] > 0]
    fr.group_by("g").count().mean("x").get_frame()
    tr, te = fr.split_frame([0.8], seed=1)
    fr.sort("x"); fr.merge(other); fr.impute("x", method="median")
    h2o.exec_rapids("(+ (cols fr.hex [0]) 5)")   # Rapids statements
    h2o.H2OFrame({"a": [1.0, 2.0]}); h2o.create_frame(rows=100, seed=1)
    m = h2o.GBM(ntrees=20, max_depth=5).train(y="y", training_frame=fr)
    m.predict(fr); m.model_performance()
    h2o.DRF(ntrees=50).train(y="y", training_frame=fr, validation_frame=va)
    h2o.XGBoost(ntrees=20, booster="dart", rate_drop=0.1).train(y="y", ...)
    h2o.IsolationForest(ntrees=50).train(training_frame=fr).predict(fr)
    h2o.ExtendedIsolationForest(extension_level=1).train(training_frame=fr)
    m = h2o.GLM(family="binomial", lambda_=0).train(y="y", training_frame=fr)
    m.coef(); h2o.GLM(lambda_search=True, alpha=0.5).train(y="y", ...)
    h2o.GAM(gam_columns=["x"], bs=[0]).train(y="y", training_frame=fr)
    h2o.RuleFit(max_rule_length=3).train(y="y", training_frame=fr)
    m = h2o.DeepLearning(hidden=[200, 200], epochs=1).train(y="y", ...)
    h2o.DeepLearning(autoencoder=True).train(training_frame=fr).anomaly(fr)
    h2o.GBM(nfolds=5, keep_cross_validation_predictions=True).train(...)
    h2o.GBM(calibrate_model=True, calibration_frame=cal).train(...)
    h2o.GBM(ntrees=20, checkpoint=m10).train(y="y", training_frame=fr)
    m.save("m.bin"); h2o.load_model("m.bin")
    m.gains_lift(); m.kolmogorov_smirnov()
    m.predict_leaf_node_assignment(fr, type="Path")
    km = h2o.KMeans(k=10, init="Furthest").train(training_frame=fr)
    h2o.PCA(k=5, pca_method="Randomized").train(training_frame=fr)
    h2o.SVD(nv=5).train(training_frame=fr); h2o.GLRM(k=5).train(...)
    h2o.NaiveBayes(laplace=1).train(y="y", training_frame=fr)
    w2v = h2o.Word2Vec(vec_size=100).train(training_frame=words)
    w2v.find_synonyms("king", 10)
    base = [h2o.GBM(nfolds=5, seed=1,
                    keep_cross_validation_predictions=True).train(...), ...]
    h2o.StackedEnsemble(base_models=base).train(y="y", training_frame=fr)
    te = h2o.TargetEncoder(data_leakage_handling="KFold",
                           fold_column="fold").train(y="y", ...)
    te.transform(fr, as_training=True)
    h2o.CoxPH(stop_column="t").train(y="event", training_frame=surv)
    h2o.PSVM(hyper_param=1.0).train(y="y", training_frame=fr)
    h2o.Aggregator(target_num_exemplars=1000).train(training_frame=fr)
    h2o.IsotonicRegression().train(x=["x"], y="y", training_frame=fr)
    h2o.train_segments(h2o.GLM, {}, fr, ["c0"], y="y").as_frame()

Importing the package builds nothing: each CUDA kernel is compiled on
its first launch (or all at once by ``kernels.build_all``), and the C++
CSV parser of ``import_file`` on its first parse (``native.build``).
"""

from h2o3_tpu_torch.core.dkv import DKV, Scope
from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.core.runtime import cluster, init
from h2o3_tpu_torch.frame_factory import H2OFrame, create_frame
from h2o3_tpu_torch.ingest.parser import (import_file, parse_setup,
                                          upload_file)
from h2o3_tpu_torch.ingest.sql import import_sql_select, import_sql_table
from h2o3_tpu_torch.models import BUILDERS
from h2o3_tpu_torch.models.aggregator import Aggregator, AggregatorModel
from h2o3_tpu_torch.models.coxph import CoxPH, CoxPHModel
from h2o3_tpu_torch.models.deeplearning import DeepLearning, DeepLearningModel
from h2o3_tpu_torch.models.ensemble import (StackedEnsemble,
                                            StackedEnsembleModel)
from h2o3_tpu_torch.models.extended_isofor import (
    ExtendedIsolationForest, ExtendedIsolationForestModel)
from h2o3_tpu_torch.models.gam import GAM, GAMModel
from h2o3_tpu_torch.models.glm import GLM, GLMModel
from h2o3_tpu_torch.models.glrm import GLRM, GLRMModel
from h2o3_tpu_torch.models.isotonic import (IsotonicRegression,
                                            IsotonicRegressionModel)
from h2o3_tpu_torch.models.kmeans import KMeans, KMeansModel
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.models.naive_bayes import NaiveBayes, NaiveBayesModel
from h2o3_tpu_torch.models.pca import PCA, PCAModel
from h2o3_tpu_torch.models.psvm import PSVM, PSVMModel
from h2o3_tpu_torch.models.rulefit import RuleFit, RuleFitModel
from h2o3_tpu_torch.models.segments import SegmentModels, train_segments
from h2o3_tpu_torch.models.svd import SVD, SVDModel
from h2o3_tpu_torch.models.target_encoder import (TargetEncoder,
                                                  TargetEncoderModel)
from h2o3_tpu_torch.models.tree.drf import DRF, DRFModel
from h2o3_tpu_torch.models.tree.gbm import GBM, GBMModel
from h2o3_tpu_torch.models.tree.isofor import (IsolationForest,
                                               IsolationForestModel)
from h2o3_tpu_torch.models.word2vec import Word2Vec, Word2VecModel
from h2o3_tpu_torch.models.xgboost import XGBoost, XGBoostModel
from h2o3_tpu_torch.rapids import Session, exec_rapids

load_model = Model.load


def ls():
    """The DKV's keys (h2o.ls)."""
    return sorted(DKV.keys())


__all__ = ["Aggregator", "AggregatorModel", "BUILDERS", "Column", "CoxPH",
           "CoxPHModel", "DKV", "DRF", "DRFModel", "DeepLearning",
           "DeepLearningModel", "ExtendedIsolationForest",
           "ExtendedIsolationForestModel", "Frame", "GAM", "GAMModel", "GBM",
           "GBMModel", "GLM", "GLMModel", "GLRM", "GLRMModel", "H2OFrame",
           "IsolationForest", "IsolationForestModel", "IsotonicRegression",
           "IsotonicRegressionModel", "KMeans", "KMeansModel", "Model",
           "NaiveBayes", "NaiveBayesModel", "PCA", "PCAModel", "PSVM",
           "PSVMModel", "RuleFit", "RuleFitModel", "SVD", "SVDModel",
           "Scope", "SegmentModels", "Session", "StackedEnsemble",
           "StackedEnsembleModel", "TargetEncoder", "TargetEncoderModel",
           "Word2Vec", "Word2VecModel", "XGBoost", "XGBoostModel", "cluster",
           "create_frame", "exec_rapids", "import_file", "import_sql_select",
           "import_sql_table", "init", "load_model", "ls", "parse_setup",
           "train_segments", "upload_file"]
