"""Carry a trained model's state across into the port.

A model trained elsewhere (for example by the JAX package) is handed over
as numpy arrays and plain values, never as that package's objects:

  forest: feat, thresh_bin, na_left, left, right, leaf_val, cat_split,
          cat_table, tree_class, na_bins, max_depth, init_f, nclasses
          (and init_class, the per-class priors of a multinomial GBM)
  spec:   names, is_cat, nbins, edges, cards
  output: names, domains, response_domain, model_category
          (and optionally response_name, distribution)

GBM, DRF and XGBoost models (per-class forests included) come across
this way. An IsolationForest adds `cnorm` (c(sample_size), the score's
normaliser) beside its forest and spec. An Extended Isolation Forest
comes as {"normals", "offsets", "lefts", "rights", "values",
"max_depth", "cnorm", "data_info", "output"}: the packed (T, M, d) and
(T, M) arrays, and the DataInfo state `DataInfo.from_state` reads.
A GLM comes as {"beta", "link", "link_power", "data_info", "output",
"parms"} (and optionally "null_deviance", "residual_deviance", "aic",
"iterations", "distribution", "p_values", "std_errors"): beta (p+1,),
(p+1, K) for a multinomial or (p + K-1,) for an ordinal fit, "parms"
the parameters scoring reads (offset_column, weights_column,
interactions). A GAM adds {"knots", "bs_types", "glm"} to its output,
and a RuleFit {"tree_models", "rules", "linear_names", "glm"}, each
inner model in its own form above.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.distribution import get_distribution
from h2o3_tpu_torch.models.extended_isofor import \
    ExtendedIsolationForestModel
from h2o3_tpu_torch.models.gam import GAMModel
from h2o3_tpu_torch.models.glm import GLMModel
from h2o3_tpu_torch.models.model import ModelCategory
from h2o3_tpu_torch.models.rulefit import RuleFitModel
from h2o3_tpu_torch.models.tree.binning import BinSpec
from h2o3_tpu_torch.models.tree.compressed import CompressedForest
from h2o3_tpu_torch.models.tree.drf import DRFModel
from h2o3_tpu_torch.models.tree.gbm import GBMModel
from h2o3_tpu_torch.models.tree.isofor import IsolationForestModel
from h2o3_tpu_torch.models.tree.shared_tree import SharedTreeModel
from h2o3_tpu_torch.models.xgboost import XGBoostModel

_FOREST_ARRAYS = {"feat": np.int32, "thresh_bin": np.int32, "na_left": bool,
                  "left": np.int32, "right": np.int32,
                  "leaf_val": np.float32, "cat_split": np.int32,
                  "cat_table": bool, "tree_class": np.int32,
                  "na_bins": np.int32}


def forest_from_numpy(d: Dict[str, Any]) -> CompressedForest:
    arrays = {k: np.asarray(d[k], dt) for k, dt in _FOREST_ARRAYS.items()}
    forest = CompressedForest(**arrays, max_depth=int(d["max_depth"]),
                              init_f=float(d["init_f"]),
                              nclasses=int(d["nclasses"]))
    if d.get("init_class") is not None:
        forest.init_class = np.asarray(d["init_class"], np.float32)
    return forest


def binspec_from_numpy(d: Dict[str, Any]) -> BinSpec:
    return BinSpec(list(d["names"]), np.asarray(d["is_cat"], bool),
                   np.asarray(d["nbins"], np.int64),
                   [np.asarray(e, np.float32) for e in d["edges"]],
                   np.asarray(d["cards"], np.int64))


def gbm_model_from_numpy(d: Dict[str, Any]) -> GBMModel:
    """A scoring-ready GBMModel from {"forest": ..., "spec": ...,
    "output": ...}. The model scores on the device of the frame it is
    given, so no device is fixed here."""
    return _tree_model_from_numpy(GBMModel(), d)


def drf_model_from_numpy(d: Dict[str, Any]) -> DRFModel:
    """A scoring-ready DRFModel, as gbm_model_from_numpy."""
    return _tree_model_from_numpy(DRFModel(), d)


def xgboost_model_from_numpy(d: Dict[str, Any]) -> XGBoostModel:
    """A scoring-ready XGBoostModel (a GBM forest), as
    gbm_model_from_numpy."""
    return _tree_model_from_numpy(XGBoostModel(), d)


def isofor_model_from_numpy(d: Dict[str, Any]) -> IsolationForestModel:
    """A scoring-ready IsolationForestModel from {"forest", "spec",
    "output", "cnorm"}."""
    model = _tree_model_from_numpy(IsolationForestModel(), d)
    model._parms["_cnorm"] = float(d["cnorm"])
    return model


def eif_model_from_numpy(d: Dict[str, Any]) -> ExtendedIsolationForestModel:
    """A scoring-ready ExtendedIsolationForestModel from its packed
    arrays, depth, score normaliser and DataInfo state."""
    model = ExtendedIsolationForestModel()
    model.normals = np.asarray(d["normals"], np.float32)
    model.offsets = np.asarray(d["offsets"], np.float32)
    model.lefts = np.asarray(d["lefts"], np.int32)
    model.rights = np.asarray(d["rights"], np.int32)
    model.values = np.asarray(d["values"], np.float32)
    model.max_depth = int(d["max_depth"])
    model.cnorm = float(d["cnorm"])
    model.data_info = DataInfo.from_state(d["data_info"])
    _set_output(model, d["output"])
    return model


def glm_model_from_numpy(d: Dict[str, Any]) -> GLMModel:
    """A scoring-ready GLMModel from its coefficients, link and DataInfo
    state. Coefficients stay on the host until the first predict moves
    them to the frame's device."""
    model = GLMModel(parms=dict(d.get("parms") or {}))
    model.beta = torch.from_numpy(np.array(d["beta"], np.float32))
    model.linkname = str(d["link"])
    model.link_power = float(d.get("link_power", 0.0))
    model.dinfo = DataInfo.from_state(d["data_info"])
    for k in ("null_deviance", "residual_deviance", "aic"):
        setattr(model, k, float(d.get(k, float("nan"))))
    model.iterations = int(d.get("iterations", 0))
    for k in ("p_values", "std_errors"):
        if d.get(k) is not None:
            setattr(model, k, np.asarray(d[k], np.float64))
    _set_output(model, d["output"])
    if d.get("distribution"):
        model._distribution = get_distribution(
            d["distribution"], tweedie_power=float(d.get("tweedie_power",
                                                         1.5)))
    return model


def gam_model_from_numpy(d: Dict[str, Any]) -> GAMModel:
    """A scoring-ready GAMModel from its knots, basis types and inner
    GLM."""
    model = GAMModel(parms=dict(d.get("parms") or {}))
    model.knots = {k: np.asarray(v, np.float64)
                   for k, v in dict(d["knots"]).items()}
    model.bs_types = {k: int(v) for k, v in dict(d["bs_types"]).items()}
    model.glm_model = glm_model_from_numpy(d["glm"])
    _set_output(model, d["output"])
    return model


def rulefit_model_from_numpy(d: Dict[str, Any]) -> RuleFitModel:
    """A scoring-ready RuleFitModel from its rule generators (each as
    drf_ or gbm_model_from_numpy takes it, with "algo" "drf" or "gbm"),
    rule table, linear terms and inner GLM."""
    model = RuleFitModel(parms=dict(d.get("parms") or {}))
    model.tree_models = [
        (gbm_model_from_numpy if t.get("algo") == "gbm"
         else drf_model_from_numpy)(t) for t in d["tree_models"]]
    model.rules = [dict(r) for r in d["rules"]]
    model.linear_names = list(d.get("linear_names") or [])
    model.glm_model = glm_model_from_numpy(d["glm"])
    _set_output(model, d["output"])
    return model


def _set_output(model, o: Dict[str, Any]) -> None:
    out = model._output
    out.names = list(o["names"])
    out.domains = {k: list(v) for k, v in dict(o["domains"]).items()}
    rd = o.get("response_domain")
    out.response_domain = list(rd) if rd is not None else None
    out.model_category = str(o["model_category"])
    out.response_name = o.get("response_name")


def _tree_model_from_numpy(model: SharedTreeModel, d: Dict[str, Any]):
    model.forest = forest_from_numpy(d["forest"])
    model.spec = binspec_from_numpy(d["spec"])
    o = d["output"]
    _set_output(model, o)
    out = model._output
    if out.model_category == ModelCategory.AnomalyDetection:
        return model
    dist = o.get("distribution") or {
        ModelCategory.Binomial: "bernoulli",
        ModelCategory.Multinomial: "multinomial"}.get(out.model_category,
                                                      "gaussian")
    model._distribution = get_distribution(dist)
    return model
