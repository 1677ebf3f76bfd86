"""ModelBuilder: parameters, train entry, training metrics (counterpart of
h2o3_tpu/models/model_builder.py `train` :110, `_train_impl` :249,
`_score_on` :460, `_init_output` :465).

This slice trains on one frame and scores the training metrics.
Cross-validation, calibration, checkpoint continuation, durable job
progress and model export are not ported yet: asking for them raises
NotImplementedError.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.model import Model, ModelCategory


class ModelBuilder:
    """Base estimator. Subclasses set `algo_name`, `model_class` and
    implement `_fit(train) -> Model`."""

    algo_name = "base"
    model_class = Model
    # parameters of the reference builder this port does not implement
    # yet, with the value that means "off"
    not_ported: Dict[str, Any] = {
        "nfolds": 0, "fold_column": None, "calibrate_model": False,
        "checkpoint": None, "export_checkpoints_dir": None,
        "offset_column": None, "validation_frame": None,
    }

    def __init__(self, **params):
        self.params: Dict[str, Any] = self.default_params()
        self._set_params(params)
        self.model: Optional[Model] = None

    @classmethod
    def default_params(cls) -> Dict[str, Any]:
        # `seed` is accepted for the reference's signature; nothing this
        # slice ports draws random numbers (row/column sampling is not
        # ported), so it changes no result yet
        return {"response_column": None, "ignored_columns": [],
                "weights_column": None, "seed": -1, "model_id": None,
                "training_frame": None}

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
              training_frame: Optional[Frame] = None, **kw) -> Model:
        """Synchronous train. x = predictor names (default: every column
        but the response and the weights)."""
        self._set_params(kw)
        train = training_frame or self.params.get("training_frame")
        if train is None:
            raise ValueError("training_frame required")
        if y is not None:
            self.params["response_column"] = y
        resp = self.params.get("response_column")
        if not resp:
            raise ValueError(f"{self.algo_name}: response_column required")
        if resp not in train:
            raise ValueError(f"response column {resp!r} not in training "
                             "frame")
        if x is not None:
            keep = list(x) + [c for c in (resp,
                                          self.params.get("weights_column"))
                              if c]
            train = train.subframe([c for c in train.names if c in keep])
        t0 = time.time()
        model = self._fit(train)
        model._output.training_metrics = self._score_on(model, train)
        model._output.run_time_ms = int((time.time() - t0) * 1000)
        self.model = model
        return model

    def _score_on(self, model: Model, frame: Frame):
        raw = model._predict_raw(model.adapt_test(frame))
        return model._make_metrics(frame, raw)

    def _init_output(self, model: Model, train: Frame):
        resp = self.params.get("response_column")
        out = model._output
        skip = {resp, self.params.get("weights_column")}
        skip |= set(self.params.get("ignored_columns") or [])
        out.names = [c for c in train.names if c not in skip
                     and not train.col(c).is_string]
        out.domains = {c: list(train.col(c).domain) for c in out.names
                       if train.col(c).is_categorical}
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
