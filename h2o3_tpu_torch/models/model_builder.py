"""ModelBuilder: parameters, train entry, training and validation
metrics (counterpart of h2o3_tpu/models/model_builder.py `random_seed`
:27, `supervised` :43, `_out_of_time` :101, `_seed` :105, `train` :110,
`_train_impl` :249, `_score_on` :460, `_init_output` :465).

A builder trains on one frame, optionally watching a validation frame
(in-training scoring, early stopping, validation metrics), under an
optional wall-clock budget (max_runtime_secs). Cross-validation,
calibration, checkpoint continuation, durable job progress and model
export are not ported yet: their parameters are accepted at the
reference's default values, and any other value raises
NotImplementedError. `stopping_metric` and `categorical_encoding` are
accepted at any value, as in the reference, which reads neither on a
ported path.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.model import Model, ModelCategory


def random_seed() -> int:
    """A fresh 31-bit seed (what seed=-1 trains with)."""
    return int(np.random.SeedSequence().entropy % (2 ** 31))


class ModelBuilder:
    """Base estimator. Subclasses set `algo_name`, `model_class` and
    implement `_fit(train) -> Model`."""

    algo_name = "base"
    model_class = Model
    # False for builders that train without a response (anomaly
    # detection): no response is asked for and no metrics are made
    supervised = True
    # parameters of the reference builder this port does not implement
    # yet, with the value that means "off" (the reference's default)
    not_ported: Dict[str, Any] = {
        "nfolds": 0, "fold_column": None, "fold_assignment": "AUTO",
        "keep_cross_validation_models": True,
        "keep_cross_validation_predictions": False,
        "calibrate_model": False, "calibration_frame": None,
        "calibration_method": "AUTO",
        "checkpoint": None, "export_checkpoints_dir": None,
    }

    def __init__(self, **params):
        self.params: Dict[str, Any] = self.default_params()
        self._set_params(params)
        self.model: Optional[Model] = None

    @classmethod
    def default_params(cls) -> Dict[str, Any]:
        return {"response_column": None, "ignored_columns": [],
                "weights_column": None, "offset_column": None,
                "seed": -1, "max_runtime_secs": 0.0,
                "stopping_rounds": 0, "stopping_metric": "AUTO",
                "stopping_tolerance": 1e-3, "categorical_encoding": "AUTO",
                "model_id": None,
                "validation_frame": None, "training_frame": None}

    def _out_of_time(self) -> bool:
        d = getattr(self, "_deadline", None)
        return d is not None and time.time() > d

    def _seed(self) -> int:
        """The seed to draw with: the user's when it is positive; 0 and
        -1 both mean a fresh random one, as in the reference."""
        s = int(self.params.get("seed", -1) or -1)
        return s if s >= 0 else random_seed()

    def _set_params(self, params: Dict[str, Any]) -> None:
        for k, v in params.items():
            if k in self.not_ported:
                if v not in (None, self.not_ported[k]):
                    raise NotImplementedError(
                        f"{self.algo_name}: parameter {k!r} is not ported "
                        "to h2o3_tpu_torch yet")
            elif k not in self.params:
                raise ValueError(f"unknown {self.algo_name} parameter {k!r}")
            elif v is not None:
                self.params[k] = v

    def train(self, x: Optional[Sequence[str]] = None, y: Optional[str] = None,
              training_frame: Optional[Frame] = None,
              validation_frame: Optional[Frame] = None, **kw) -> Model:
        """Synchronous train. x = predictor names (default: every column
        but the response, the weights and the offset)."""
        self._set_params(kw)
        train = training_frame or self.params.get("training_frame")
        if train is None:
            raise ValueError("training_frame required")
        if y is not None:
            self.params["response_column"] = y
        valid = validation_frame or self.params.get("validation_frame")
        resp = self.params.get("response_column")
        if self.supervised and not resp:
            raise ValueError(f"{self.algo_name}: response_column required")
        if self.supervised and resp not in train:
            raise ValueError(f"response column {resp!r} not in training "
                             "frame")
        if x is not None:
            keep = list(x) + [c for c in (resp,
                                          self.params.get("weights_column"),
                                          self.params.get("offset_column"))
                              if c]
            train = train.subframe([c for c in train.names if c in keep])
        t0 = time.time()
        # wall-clock budget: fit loops poll _out_of_time() and keep the
        # model built so far
        mrt = float(self.params.get("max_runtime_secs") or 0.0)
        self._deadline = (t0 + mrt) if mrt > 0 else None
        self._valid_frame_ref = valid
        try:
            model = self._fit(train)
        finally:
            self._valid_frame_ref = None
        model._output.training_metrics = self._score_on(model, train)
        if valid is not None:
            model._output.validation_metrics = self._score_on(model, valid)
        # fit-time scratch refs would pin the training frame's buffers
        self._train_frame_ref = None
        self._oob_raw = None
        model._output.run_time_ms = int((time.time() - t0) * 1000)
        self.model = model
        return model

    def _score_on(self, model: Model, frame: Frame):
        if model._output.response_name is None:
            return None          # metrics need a response; skip the scoring
        raw = model._predict_raw(model.adapt_test(frame))
        return model._make_metrics(frame, raw)

    def _init_output(self, model: Model, train: Frame):
        resp = self.params.get("response_column")
        out = model._output
        skip = {resp, self.params.get("weights_column"),
                self.params.get("offset_column")}
        skip |= set(self.params.get("ignored_columns") or [])
        out.names = [c for c in train.names if c not in skip
                     and not train.col(c).is_string]
        out.domains = {c: list(train.col(c).domain) for c in out.names
                       if train.col(c).is_categorical}
        if not resp:
            return out
        rc = train.col(resp)
        out.response_name = resp
        if rc.is_categorical:
            out.response_domain = list(rc.domain or [])
            out.model_category = (ModelCategory.Binomial
                                  if len(out.response_domain) == 2
                                  else ModelCategory.Multinomial)
        else:
            out.model_category = ModelCategory.Regression
        return out

    def _fit(self, train: Frame) -> Model:
        raise NotImplementedError
