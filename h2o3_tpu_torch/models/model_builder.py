"""ModelBuilder: parameters, the train entry, cross-validation,
calibration, checkpoints and metrics (counterpart of
h2o3_tpu/models/model_builder.py: `random_seed` :27, `supervised` :43,
`default_params` :74, `_out_of_time` :101, `_seed` :105, `train` :110,
`_train_impl` :249, `_maybe_calibrate` :312, `_CHECKPOINT_MODIFIABLE`
:346, `_resolve_checkpoint` :355, `_cross_validate` :385, `_score_on`
:460, `_init_output` :465, `_fit_platt` :490, `_mean_metrics` :515,
`BUILDERS`/`register` :535-541).

A builder trains on one frame, optionally watching a validation frame
(in-training scoring, early stopping, validation metrics), under an
optional wall-clock budget (max_runtime_secs). With `nfolds` > 1 or a
`fold_column` it first trains one model per fold on the other folds'
rows and scores it on its own (the mean of the fold metrics becomes the
cross-validation metrics; the holdout predictions are kept on request).
A tree builder may calibrate its binomial probabilities on a
calibration frame (Platt scaling or isotonic regression), and a builder
that supports it continues training from a checkpoint model. The
preconditions of all three raise before anything trains. A checkpoint
may be the Model or its DKV key. Durable job progress waits for the
cross-process DKV (ROADMAP A14).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Type

import numpy as np

from h2o3_tpu_torch.core.dkv import DKV
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
    # builders that implement training continuation set this; the rest
    # refuse a checkpoint rather than train from scratch
    supports_checkpoint = False

    def __init__(self, **params):
        self.params: Dict[str, Any] = self.default_params()
        self._set_params(params)
        self.model: Optional[Model] = None

    @classmethod
    def default_params(cls) -> Dict[str, Any]:
        return {"response_column": None, "ignored_columns": [],
                "weights_column": None, "offset_column": None,
                "fold_column": None, "nfolds": 0, "fold_assignment": "AUTO",
                "keep_cross_validation_models": True,
                "keep_cross_validation_predictions": False,
                "seed": -1, "max_runtime_secs": 0.0,
                "stopping_rounds": 0, "stopping_metric": "AUTO",
                "stopping_tolerance": 1e-3, "model_id": None,
                "validation_frame": None, "training_frame": None,
                "categorical_encoding": "AUTO",
                "checkpoint": None, "export_checkpoints_dir": None}

    def _out_of_time(self) -> bool:
        d = getattr(self, "_deadline", None)
        return d is not None and time.time() > d

    def _seed(self) -> int:
        """The seed to draw with: the user's when it is positive; 0 and
        -1 both mean a fresh random one, as in the reference."""
        s = int(self.params.get("seed", -1) or -1)
        return s if s >= 0 else random_seed()

    def _set_params(self, params: Dict[str, Any]) -> None:
        unknown = [k for k in params if k not in self.params]
        if unknown:
            raise ValueError(f"unknown {self.algo_name} parameters: "
                             f"{unknown}")
        self.params.update({k: v for k, v in params.items()
                            if v is not None})

    def train(self, x: Optional[Sequence[str]] = None, y: Optional[str] = None,
              training_frame: Optional[Frame] = None,
              validation_frame: Optional[Frame] = None, **kw) -> Model:
        """Synchronous train. x = predictor names (default: every column
        but the response, the weights, the offset and the fold column)."""
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
                                          self.params.get("offset_column"),
                                          self.params.get("fold_column"))
                              if c]
            train = train.subframe([c for c in train.names if c in keep])
        t0 = time.time()
        # wall-clock budget: fit loops poll _out_of_time() and keep the
        # model built so far
        mrt = float(self.params.get("max_runtime_secs") or 0.0)
        self._deadline = (t0 + mrt) if mrt > 0 else None
        model = self._train_impl(train, valid)
        model._output.run_time_ms = int((time.time() - t0) * 1000)
        self.model = model
        return model

    def _train_impl(self, train: Frame, valid: Optional[Frame]) -> Model:
        nfolds = int(self.params.get("nfolds") or 0)
        fold_col = self.params.get("fold_column")
        if self.params.get("calibrate_model"):
            # fail before training: these read only the parameters and
            # the response's type
            if self.params.get("calibration_frame") is None:
                raise ValueError("calibrate_model=True requires a "
                                 "calibration_frame")
            rc = train.col(self.params.get("response_column"))
            if not (rc.is_categorical and len(rc.domain or []) == 2):
                raise ValueError("model calibration supports binomial models")
        if self.params.get("checkpoint"):
            if not self.supports_checkpoint:
                raise ValueError(
                    f"{self.algo_name} does not support checkpoint "
                    "continuation")
            # before CV: fold models resuming from a full-data checkpoint
            # would have seen every holdout
            if nfolds > 1 or fold_col:
                raise ValueError(
                    "checkpoint cannot be combined with cross-validation")
        cv_models: List[Model] = []
        cv_metrics: List = []
        cv_preds, fold_digest = None, None
        if nfolds > 1 or fold_col:
            cv_models, cv_metrics, cv_preds, fold_digest = \
                self._cross_validate(train, nfolds, fold_col)

        self._valid_frame_ref = valid       # in-training validation scoring
        try:
            model = self._fit(train)
        finally:
            self._valid_frame_ref = None
        out = model._output
        if cv_preds is not None:
            out.cross_validation_holdout_predictions = cv_preds
        if fold_digest is not None:
            out.fold_assignment_digest = fold_digest
        out.training_metrics = self._score_on(model, train)
        if valid is not None:
            out.validation_metrics = self._score_on(model, valid)
        if cv_metrics:
            out.cv_fold_metrics = cv_metrics
            out.cross_validation_metrics = _mean_metrics(cv_metrics)
            if self.params.get("keep_cross_validation_models", True):
                out.cross_validation_models = cv_models
        # fit-time scratch refs would pin the training frame's buffers
        self._train_frame_ref = None
        self._oob_raw = None
        self._maybe_calibrate(model)
        ed = self.params.get("export_checkpoints_dir")
        if ed:
            os.makedirs(ed, exist_ok=True)
            model.save(os.path.join(ed, f"{model.key}.bin"))
        return model

    # -- probability calibration -------------------------------------------
    def _maybe_calibrate(self, model: Model) -> None:
        """Platt scaling or isotonic regression of P(class 1) on the
        calibration frame's rows of positive weight; the preconditions
        were checked in _train_impl."""
        if not self.params.get("calibrate_model"):
            return
        from h2o3_tpu_torch.models.data_info import DataInfo

        frame = self.params.get("calibration_frame")
        raw = model._predict_raw(model.adapt_test(frame))
        p = raw["probs"][:, 1].cpu().numpy().astype(np.float64)
        y_col = model._adapt_response(frame.col(model._output.response_name))
        y = DataInfo.clean_response(y_col.data).cpu().numpy()
        wc = self.params.get("weights_column")
        w_user = frame.col(wc).data if wc and wc in frame else None
        w = DataInfo.response_weight(y_col.data, w_user).cpu().numpy()
        ok = w > 0
        method = str(self.params.get("calibration_method")
                     or "PlattScaling").lower()
        if method in ("auto", "plattscaling", "platt"):
            model._calibrator = ("platt", _fit_platt(p[ok], y[ok], w=w[ok]))
        elif method in ("isotonicregression", "isotonic"):
            from h2o3_tpu_torch.models.isotonic import pava

            model._calibrator = ("isotonic",
                                 pava(p[ok], y[ok].astype(float), w[ok]))
        else:
            raise ValueError(f"unknown calibration_method {method!r}")
        # the frame itself stays out of the model (and of its file)
        model._parms["calibration_frame"] = str(frame.key or "")

    # -- checkpoint (training continuation) --------------------------------
    # parameters a continuation may change; the rest must equal the
    # checkpoint model's
    _CHECKPOINT_MODIFIABLE = frozenset({
        "checkpoint", "model_id", "training_frame", "validation_frame",
        "ntrees", "epochs", "max_runtime_secs", "seed",
        "stopping_rounds", "stopping_metric", "stopping_tolerance",
        "score_each_iteration", "score_tree_interval",
        "export_checkpoints_dir", "keep_cross_validation_models",
        "keep_cross_validation_predictions",
    })

    def _resolve_checkpoint(self) -> Optional[Model]:
        """The checkpoint model, checked: same algorithm, and every
        parameter outside _CHECKPOINT_MODIFIABLE as the original run had
        it. None when training fresh."""
        ck = self.params.get("checkpoint")
        if not ck:
            return None
        if int(self.params.get("nfolds") or 0) > 1 \
                or self.params.get("fold_column"):
            raise ValueError("checkpoint cannot be combined with "
                             "cross-validation")
        prev = ck if isinstance(ck, Model) else DKV.get(str(ck))
        if prev is None:
            raise ValueError(f"checkpoint model {ck!r} not found")
        if prev.algo_name != self.algo_name:
            raise ValueError(f"checkpoint model is a {prev.algo_name}, not "
                             f"a {self.algo_name}")
        for k, v in self.params.items():
            if k in self._CHECKPOINT_MODIFIABLE or k not in prev._parms:
                continue
            pv = prev._parms[k]
            if isinstance(pv, (list, tuple)) or isinstance(v, (list, tuple)):
                same = list(pv or []) == list(v or [])
            else:
                same = pv == v
            if not same:
                raise ValueError(f"checkpoint: parameter {k!r} cannot be "
                                 f"modified (was {pv!r}, now {v!r})")
        return prev

    # -- cross-validation ---------------------------------------------------
    def _fold_assignment(self, train: Frame, nfolds: int,
                         fold_col: Optional[str]):
        """-> (per-row fold ids, the folds): the fold column's values,
        or AUTO/Random (uniform draws), Stratified (per class, a
        round-robin over shuffled rows from a random start) or Modulo
        (row index mod nfolds)."""
        n = train.nrows
        if fold_col:
            assign = train.col(fold_col).to_numpy().astype(int)
            return assign, sorted(set(assign.tolist()))
        scheme = (self.params.get("fold_assignment") or "AUTO").lower()
        if scheme in ("auto", "random"):
            rng = np.random.default_rng(self._seed())
            assign = rng.integers(0, nfolds, n)
        elif scheme == "stratified":
            rng = np.random.default_rng(self._seed())
            resp = self.params.get("response_column")
            if not resp or not train.col(resp).is_categorical:
                raise ValueError("fold_assignment='Stratified' requires a "
                                 "categorical response")
            y = train.col(resp).to_numpy()
            assign = rng.integers(0, nfolds, n)  # NA responses: random fold
            for cls in np.unique(y[y >= 0]):
                idx = np.nonzero(y == cls)[0]
                rng.shuffle(idx)
                assign[idx] = ((np.arange(len(idx)) + rng.integers(nfolds))
                               % nfolds)
        elif scheme == "modulo":
            assign = np.arange(n) % nfolds
        else:
            raise ValueError(f"unknown fold_assignment {scheme!r}")
        return assign, list(range(nfolds))

    def _cross_validate(self, train: Frame, nfolds: int,
                        fold_col: Optional[str]):
        """One model per fold, trained on the other folds' rows and scored
        on its own: -> (fold models, fold metrics, holdout predictions or
        None, digest of the fold assignment)."""
        from h2o3_tpu_torch.ops.filters import take_rows

        assign, folds = self._fold_assignment(train, nfolds, fold_col)
        n = train.nrows
        keep_preds = bool(self.params.get("keep_cross_validation_predictions"))
        models, mets = [], []
        preds_buf = None
        drop = ("nfolds", "fold_column", "training_frame", "validation_frame",
                "model_id", "checkpoint", "export_checkpoints_dir")
        for f in folds:
            ho_idx = np.nonzero(assign == f)[0]
            tr = take_rows(train, np.nonzero(assign != f)[0])
            ho = take_rows(train, ho_idx)
            sub = type(self)(**{k: v for k, v in self.params.items()
                                if k not in drop})
            # fold fits bypass train(): hand the budget down
            sub._deadline = getattr(self, "_deadline", None)
            m = sub._fit(tr)
            # one scoring pass serves the fold metrics and the holdout
            # predictions
            raw = m._predict_raw(m.adapt_test(ho))
            mets.append(m._make_metrics(ho, raw))
            if keep_preds:
                vals = (raw["probs"] if "probs" in raw
                        else raw["value"]).cpu().numpy()
                if preds_buf is None:
                    preds_buf = np.zeros((n,) + vals.shape[1:], np.float32)
                preds_buf[ho_idx] = vals
            models.append(m)
        digest = hashlib.sha1(np.ascontiguousarray(assign, np.int64)
                              ).hexdigest()
        return models, mets, preds_buf, digest

    def _score_on(self, model: Model, frame: Frame):
        out = model._output
        if out.response_name is None and out.model_category not in (
                ModelCategory.AutoEncoder, ModelCategory.Clustering):
            return None          # metrics need a response; skip the scoring
        raw = model._predict_raw(model.adapt_test(frame))
        return model._make_metrics(frame, raw)

    def _init_output(self, model: Model, train: Frame):
        resp = self.params.get("response_column")
        out = model._output
        skip = {resp, self.params.get("weights_column"),
                self.params.get("offset_column"),
                self.params.get("fold_column")}
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


def _fit_platt(p: np.ndarray, y: np.ndarray,
               w: Optional[np.ndarray] = None, iters: int = 30):
    """Platt scaling: sigmoid(a·z + b) on z = logit(p), fit by Newton's
    method on the weighted two-parameter logistic log-likelihood."""
    pc = np.clip(p, 1e-7, 1 - 1e-7)
    z = np.log(pc / (1 - pc))
    if w is None:
        w = np.ones_like(z)
    a, b = 1.0, 0.0
    for _ in range(iters):
        mu = 1.0 / (1.0 + np.exp(-(a * z + b)))
        g = np.array([np.sum(w * (mu - y) * z), np.sum(w * (mu - y))])
        s = np.maximum(mu * (1 - mu), 1e-9) * w
        H = np.array([[np.sum(s * z * z), np.sum(s * z)],
                      [np.sum(s * z), np.sum(s)]])
        try:
            step = np.linalg.solve(H + 1e-9 * np.eye(2), g)
        except np.linalg.LinAlgError:
            break
        a, b = a - step[0], b - step[1]
        if np.abs(step).max() < 1e-10:
            break
    return float(a), float(b)


def _mean_metrics(mets: List):
    """The cross-validation metrics: each numeric field the mean of the
    folds' (NaNs left out), the rest the first fold's."""
    mets = [m for m in mets if m is not None]
    if not mets:
        return None
    out = copy.copy(mets[0])
    for f in dataclasses.fields(type(mets[0])):
        vals = [getattr(m, f.name) for m in mets]
        if all(isinstance(v, (int, float)) for v in vals):
            valid = [v for v in vals if v == v]
            if valid:
                setattr(out, f.name, float(np.mean(valid)))
    out.description = f"{len(mets)}-fold cross-validation (mean of folds)"
    return out


# algo name -> builder class, filled by @register as the algorithm modules
# import (models/__init__._register_all)
BUILDERS: Dict[str, Type[ModelBuilder]] = {}


def register(cls):
    BUILDERS[cls.algo_name] = cls
    return cls
