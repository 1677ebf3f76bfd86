"""h2o3_tpu_torch — the PyTorch/CUDA port of h2o3_tpu for one NVIDIA H100.

    import h2o3_tpu_torch as h2o
    h2o.init()                      # the CUDA device; device="cpu" on a CPU
    fr = h2o.Frame(); fr.add("x", h2o.Column.from_numpy(x)); ...
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

Importing the package builds no kernel: each CUDA kernel is compiled on
its first launch (or all at once by ``kernels.build_all``).
"""

from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.core.runtime import cluster, init
from h2o3_tpu_torch.models.extended_isofor import (
    ExtendedIsolationForest, ExtendedIsolationForestModel)
from h2o3_tpu_torch.models.gam import GAM, GAMModel
from h2o3_tpu_torch.models.glm import GLM, GLMModel
from h2o3_tpu_torch.models.rulefit import RuleFit, RuleFitModel
from h2o3_tpu_torch.models.tree.drf import DRF, DRFModel
from h2o3_tpu_torch.models.tree.gbm import GBM, GBMModel
from h2o3_tpu_torch.models.tree.isofor import (IsolationForest,
                                               IsolationForestModel)
from h2o3_tpu_torch.models.xgboost import XGBoost, XGBoostModel

__all__ = ["Column", "DRF", "DRFModel", "ExtendedIsolationForest",
           "ExtendedIsolationForestModel", "Frame", "GAM", "GAMModel", "GBM",
           "GBMModel", "GLM", "GLMModel", "IsolationForest",
           "IsolationForestModel", "RuleFit", "RuleFitModel", "XGBoost",
           "XGBoostModel", "cluster", "init"]
