"""Model base: trained artifact and scoring (counterpart of
h2o3_tpu/models/model.py: `ModelOutput` :38, `Model` :79, `_raw_to_frame`
:192, `_calibrated_p1` :230, `gains_lift` :289, `save`/`load` :340-388).

Scoring adapts the test frame to the training columns on the host
(column order, NA fill of missing predictors, categorical domain remap)
and runs the per-algo `_predict_raw` on the frame's device. A model has
a key (its `model_id`, or one made from its class name) and lives in the
DKV under it from construction on, as in the reference. `save` writes
an 8-byte magic, a u16 format version and a pickle of the model's state
in which every tensor is a numpy array; `load` reads it back through a
restricted unpickler (utils/unpickle.py) and puts the tensors on the
booted device, and installs the model under its key.
"""

from __future__ import annotations

import io
import pickle
import struct
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.dkv import Keyed
from h2o3_tpu_torch.core.frame import Column, Frame, NA_CAT, T_CAT, T_NUM
from h2o3_tpu_torch.models import metrics as M


class ModelCategory:
    Regression = "Regression"
    Binomial = "Binomial"
    Multinomial = "Multinomial"
    Clustering = "Clustering"
    DimReduction = "DimReduction"
    AnomalyDetection = "AnomalyDetection"
    AutoEncoder = "AutoEncoder"
    WordEmbedding = "WordEmbedding"
    CoxPH = "CoxPH"
    Unknown = "Unknown"


class ModelOutput:
    """What the trained model knows about its world."""

    def __init__(self):
        self.names: List[str] = []          # predictor columns, in order
        self.domains: Dict[str, List[str]] = {}
        self.response_name: Optional[str] = None
        self.response_domain: Optional[List[str]] = None
        self.model_category: str = ModelCategory.Unknown
        self.training_metrics: Optional[M.ModelMetrics] = None
        self.validation_metrics: Optional[M.ModelMetrics] = None
        # cross-validation: the mean of the fold metrics, each fold's, the
        # fold models (unless keep_cross_validation_models=False), the
        # (n,) or (n, K) holdout predictions (with
        # keep_cross_validation_predictions) and a digest of the fold
        # assignment
        self.cross_validation_metrics: Optional[M.ModelMetrics] = None
        self.cv_fold_metrics: List[M.ModelMetrics] = []
        self.cross_validation_models: Optional[List["Model"]] = None
        self.cross_validation_holdout_predictions = None
        self.fold_assignment_digest: Optional[str] = None
        self.variable_importances: Optional[Dict[str, float]] = None
        self.scoring_history: List[dict] = []
        self.run_time_ms: int = 0

    @property
    def nclasses(self) -> int:
        return len(self.response_domain) if self.response_domain else 1


def _remap_to_domain(data, from_dom: List[str], to_dom: List[str]):
    """Categorical codes from one domain's numbering onto another's; levels
    absent from to_dom (and NAs) map to NA."""
    lut_map = {v: i for i, v in enumerate(to_dom)}
    lut = torch.as_tensor([lut_map.get(v, NA_CAT) for v in from_dom]
                          or [NA_CAT], dtype=torch.int32, device=data.device)
    return torch.where(data >= 0, lut[torch.clamp_min(data, 0).long()],
                       NA_CAT)


def _tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A saved tensor back on the booted device (the one callable a
    model file may name, utils/unpickle.REBUILD)."""
    from h2o3_tpu_torch.core.runtime import cluster

    return torch.from_numpy(np.array(arr)).to(cluster().device)


class _ModelPickler(pickle.Pickler):
    """Writes every tensor as its numpy array, rebuilt by
    _tensor_from_numpy: a pickled torch tensor would name torch's own
    rebuild callables, which the restricted loader refuses."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return _tensor_from_numpy, (obj.detach().cpu().numpy(),)
        return NotImplemented


class Model(Keyed):
    """Base trained model. Subclasses implement `_predict_raw(frame)` and
    set `_output.model_category`."""

    algo_name = "model"
    _SAVE_MAGIC = b"H2OTORCH"
    _SAVE_VERSION = 1

    def __init__(self, parms: Optional[dict] = None,
                 key: Optional[str] = None):
        self._parms: dict = dict(parms or {})
        self._output = ModelOutput()
        # a plain str, so that a saved model names no key class
        self._key = str(key or self._parms.get("model_id")
                        or f"{type(self).__name__}_{uuid.uuid4().hex[:12]}")
        # probability calibrator: ("platt", (a, b)) or ("isotonic",
        # (knots x, knots y))
        self._calibrator = None
        self.install()

    def _predict_raw(self, frame: Frame) -> Dict[str, Any]:
        """Regression: {"value": (N,)}; Binomial: {"probs": (N, 2)};
        Multinomial: {"probs": (N, K)}; Clustering: {"cluster": (N,)};
        AnomalyDetection: {"score": (N,)} and optionally "mean_length"."""
        raise NotImplementedError

    # -- adaptation -------------------------------------------------------
    def adapt_test(self, test: Frame) -> Frame:
        """Align a test frame to the training columns: reorder, fill
        missing predictors with NA, remap categorical codes onto the
        training domains (unseen level -> NA)."""
        err = self.check_test_compat(test)
        if err:
            raise ValueError(err)
        out = Frame()
        n = test.nrows
        dev = next(test.col(c).data.device for c in test.names
                   if test.col(c).data is not None)
        for name in self._output.names:
            train_dom = self._output.domains.get(name)
            if name not in test:
                if train_dom is not None:
                    data = torch.full((n,), NA_CAT, dtype=torch.int32,
                                      device=dev)
                    out.add(name, Column(data, T_CAT, n, domain=train_dom))
                else:
                    data = torch.full((n,), float("nan"), device=dev)
                    out.add(name, Column(data, T_NUM, n))
                continue
            c = test.col(name)
            if train_dom is not None and (c.domain or []) != train_dom:
                c = Column(_remap_to_domain(c.data, c.domain or [],
                                            train_dom),
                           T_CAT, n, domain=train_dom)
            out.add(name, c)
        # the special columns scoring and metrics read (model.py:144-150)
        for pname in ("offset_column", "weights_column", "fold_column"):
            cn = self._parms.get(pname)
            if cn and cn in test and cn not in out:
                out.add(cn, test.col(cn))
        return out

    @staticmethod
    def _remap_col(c: Column, train_dom: Optional[List[str]]) -> Column:
        """One categorical column on a training domain (itself when
        already aligned; model.py:152)."""
        if train_dom is None or not c.is_categorical \
                or (c.domain or []) == train_dom:
            return c
        return Column(_remap_to_domain(c.data, c.domain or [], train_dom),
                      T_CAT, c.nrows, domain=list(train_dom))

    def _adapt_response(self, c: Column) -> Column:
        """Remap a categorical response onto the training response domain."""
        return self._remap_col(c, self._output.response_domain)

    def check_test_compat(self, test: Frame) -> Optional[str]:
        """The error adapt_test would raise for categorical/numeric column
        mismatches, or None."""
        for name in self._output.names:
            if name not in test:
                continue
            c = test.col(name)
            train_dom = self._output.domains.get(name)
            if train_dom is not None and not c.is_categorical:
                return (f"column {name} was categorical in training, "
                        "numeric in test")
            if train_dom is None and c.ctype == T_CAT:
                return (f"column {name} was numeric in training, "
                        "enum in test")
        return None

    # -- scoring ----------------------------------------------------------
    def predict(self, frame: Frame) -> Frame:
        raw = self._predict_raw(self.adapt_test(frame))
        return self._raw_to_frame(raw, frame.nrows)

    def _raw_to_frame(self, raw: Dict[str, Any], n: int) -> Frame:
        out = Frame()
        cat = self._output.model_category
        if cat in (ModelCategory.Binomial, ModelCategory.Multinomial):
            probs = raw["probs"]
            dom = self._output.response_domain or []
            tm = self._output.training_metrics
            if cat == ModelCategory.Binomial and tm is not None \
                    and getattr(tm, "auc_data", None) is not None:
                thr = tm.auc_data.max_f1_threshold
                label = (probs[:, 1] >= thr).int()
            else:
                label = torch.argmax(probs, dim=-1).int()
            out.add("predict", Column(label, T_CAT, n, domain=list(dom)))
            for k, lvl in enumerate(dom):
                out.add(str(lvl), Column(probs[:, k].contiguous(), T_NUM, n))
            if self._calibrator is not None and cat == ModelCategory.Binomial:
                pc = self._calibrated_p1(probs[:, 1])
                out.add(f"cal_{dom[0]}", Column(1.0 - pc, T_NUM, n))
                out.add(f"cal_{dom[1]}", Column(pc, T_NUM, n))
        elif cat == ModelCategory.Clustering:
            cl = raw["cluster"].int()
            k = int(self._parms.get("k", 0)) or int(cl.max()) + 1
            out.add("predict", Column(cl, T_CAT, n,
                                      domain=[str(i) for i in range(k)]))
        elif cat == ModelCategory.AnomalyDetection:
            out.add("predict", Column(raw["score"], T_NUM, n))
            if "mean_length" in raw:
                out.add("mean_length", Column(raw["mean_length"], T_NUM, n))
        else:
            out.add("predict", Column(raw["value"], T_NUM, n))
        return out

    def _calibrated_p1(self, p1: torch.Tensor) -> torch.Tensor:
        """Calibrated P(class 1): Platt's sigmoid(a·logit(p) + b), or the
        isotonic knots' interpolation clipped to [0, 1]."""
        kind, parms = self._calibrator
        if kind == "platt":
            a, b = parms
            pc = torch.clamp(p1, 1e-7, 1 - 1e-7)
            z = torch.log(pc / (1 - pc))
            return 1.0 / (1.0 + torch.exp(-(a * z + b)))
        from h2o3_tpu_torch.models.isotonic import interpolate

        tx, ty = parms
        return torch.clamp(interpolate(tx, ty, p1), 0.0, 1.0)

    def model_performance(self, test_data: Optional[Frame] = None):
        """Training metrics, or metrics on `test_data`."""
        if test_data is None:
            return self._output.training_metrics
        raw = self._predict_raw(self.adapt_test(test_data))
        return self._make_metrics(test_data, raw)

    def _make_metrics(self, frame: Frame, raw: Dict[str, Any],
                      extra_weight=None):
        """extra_weight: optional (N,) multiplier; rows it zeroes drop out
        (DRF's out-of-bag training metrics)."""
        from h2o3_tpu_torch.models.data_info import DataInfo

        resp = self._output.response_name
        if resp is None or resp not in frame:
            return None
        y = self._adapt_response(frame.col(resp)).data
        wname = self._parms.get("weights_column")
        w = frame.col(wname).data if wname and wname in frame else None
        if extra_weight is not None:
            w = extra_weight if w is None else w * extra_weight
        wts = DataInfo.response_weight(y, w)
        cat = self._output.model_category
        if cat == ModelCategory.Binomial:
            yf = DataInfo.clean_response(y).float()
            return M.make_binomial_metrics(
                yf, raw["probs"][:, 1], wts,
                domain=self._output.response_domain)
        if cat == ModelCategory.Multinomial:
            return M.make_multinomial_metrics(
                DataInfo.clean_response(y), raw["probs"], wts,
                domain=self._output.response_domain)
        if cat == ModelCategory.Regression:
            return M.make_regression_metrics(
                DataInfo.clean_response(y), raw["value"], wts,
                distribution=getattr(self, "_distribution", None))
        return None

    def gains_lift(self, test_data: Optional[Frame] = None):
        """The binomial gains/lift TwoDimTable: the training metrics'
        when no frame is given."""
        return getattr(self.model_performance(test_data),
                       "gains_lift_table", None)

    def kolmogorov_smirnov(self) -> float:
        return float(getattr(self._output.training_metrics, "ks",
                             float("nan")))

    def varimp(self) -> Optional[Dict[str, float]]:
        return self._output.variable_importances

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> str:
        """Write the model to `path` (magic, u16 version, pickled state
        with tensors as numpy arrays)."""
        buf = io.BytesIO()
        _ModelPickler(buf, protocol=4).dump((type(self), self.__dict__))
        with open(path, "wb") as f:
            f.write(self._SAVE_MAGIC)
            f.write(struct.pack("<H", self._SAVE_VERSION))
            f.write(buf.getvalue())
        return path

    @staticmethod
    def load(path: str) -> "Model":
        """Read a model `save` wrote; its tensors land on the booted
        device. A file of another format, a newer version, or one that
        names anything but the port's classes and numeric types raises
        ValueError."""
        from h2o3_tpu_torch.utils.unpickle import restricted_load

        with open(path, "rb") as f:
            if f.read(8) != Model._SAVE_MAGIC:
                raise ValueError(f"{path!r} is not an h2o3_tpu_torch model "
                                 "file")
            (ver,) = struct.unpack("<H", f.read(2))
            if ver > Model._SAVE_VERSION:
                raise ValueError(
                    f"model file version {ver} is newer than this build "
                    f"reads ({Model._SAVE_VERSION})")
            try:
                cls, state = restricted_load(f, what="model file")
            except pickle.UnpicklingError as e:
                raise ValueError(str(e)) from e
        if not (isinstance(cls, type) and issubclass(cls, Model)):
            raise ValueError(f"{path!r} holds a {cls!r}, not a model")
        obj = cls.__new__(cls)
        obj.__dict__.update(state)
        obj.install()
        return obj

    def __repr__(self):
        return (f"<{type(self).__name__} {self._key} "
                f"{self._output.model_category}>")
