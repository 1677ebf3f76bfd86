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
On a row-sharded cloud the folds are drawn over all n rows on every
rank (one seed), so the assignment and its digest are one process's,
and a fold column is read from each rank's own block; each rank
selects its rows of a fold and the fold frames move through the row
exchange, the fold metrics are the cloud's, the holdout predictions are
each rank's block of rows, and the fold ticks are published to the
cloud's KV (`Job.publish_progress`). A
tree builder may calibrate its binomial probabilities on a
calibration frame (Platt scaling or isotonic regression), and a builder
that supports it continues training from a checkpoint model. The
preconditions of all three raise before anything trains. A checkpoint
may be the Model or its DKV key.

Durable job progress (reference :167-246): a builder whose fit loop can
continue from saved loop state sets `supports_iteration_resume`. When
``H2O_TPU_JOB_CKPT_ITERS`` is set and the builder holds a
`_progress_job` with a `resume_spec` (the REST train handler attaches
both), the loop saves its state every that many iterations
(`_tick_job_progress`, parallel/ckpt.py); a completed train deletes it
(`_clear_job_progress`), unless an external FAILED won the race. A
fresh builder given the saved state as `_resume_state` continues the
run where it stopped (`_take_resume_state`).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Type

import numpy as np
import torch

from h2o3_tpu_torch.core.dkv import DKV
from h2o3_tpu_torch.core.frame import Frame, widen
from h2o3_tpu_torch.core.job import Job, JobCancelled
from h2o3_tpu_torch.core.runtime import in_full_float32
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
    # trains over a row-sharded frame (GBM, DRF, GLM, XGBoost,
    # DeepLearning, StackedEnsemble): the others are ROADMAP A14.6c part
    # 4 and refuse one
    row_sharded = False
    # builders that implement training continuation set this; the rest
    # refuse a checkpoint rather than train from scratch
    supports_checkpoint = False
    # builders whose fit loops save durable per-iteration progress and
    # continue from it (_tick_job_progress / _take_resume_state); the
    # REST train handler reads this before it arms job progress
    supports_iteration_resume = False

    def __init__(self, **params):
        self.params: Dict[str, Any] = self.default_params()
        self._set_params(params)
        # the Job of the running (or last) train; None for the fold
        # builders of cross-validation, which bypass train()
        self.job: Optional[Job] = None
        self.model: Optional[Model] = None
        # the job durable progress is saved against (None: library-mode
        # training saves nothing) and the loop state a resumed train
        # continues from
        self._progress_job: Optional[Job] = None
        self._resume_state: Optional[dict] = None

    def __init_subclass__(cls, **kw):
        # a subclass's own train() runs in full float32 too (C26)
        super().__init_subclass__(**kw)
        fn = cls.__dict__.get("train")
        if fn is not None and not getattr(fn, "_full_float32", False):
            cls.train = in_full_float32(fn)

    @classmethod
    def translate_param(cls, name: str) -> str:
        """A parameter's external spelling -> its canonical name
        (XGBoost overrides it for eta, n_estimators, ...)."""
        return name

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

    @in_full_float32
    def train(self, x: Optional[Sequence[str]] = None, y: Optional[str] = None,
              training_frame: Optional[Frame] = None,
              validation_frame: Optional[Frame] = None, **kw) -> Model:
        """Synchronous train under a Job (`self.job`: DONE with progress
        1.0, FAILED on an exception, CANCELLED when `self.job.cancel()`
        stopped it at a progress tick), in full float32 matmul precision
        whatever the caller's TF32 setting (ROADMAP C26). x = predictor
        names (default: every column but the response, the weights, the
        offset and the fold column)."""
        self._set_params(kw)
        train = training_frame or self.params.get("training_frame")
        if train is None:
            raise ValueError("training_frame required")
        from h2o3_tpu_torch.core.sharded_frame import refuse

        if not self.row_sharded:
            refuse(train, f"a {self.algo_name} train")
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
        self.job = Job(description=f"{self.algo_name} train",
                       dest=self.params.get("model_id"))
        t0 = time.time()
        # wall-clock budget: fit loops poll _out_of_time() and keep the
        # model built so far
        mrt = float(self.params.get("max_runtime_secs") or 0.0)
        self._deadline = (t0 + mrt) if mrt > 0 else None
        self.job.begin()
        try:
            model = self._train_impl(train, valid)
        except JobCancelled:
            self.job.cancelled_local()
            raise
        except Exception:
            self.job.fail_local(traceback.format_exc())
            raise
        if self.job.complete():
            # only a completion that won the verdict supersedes the
            # durable progress: after an external FAILED the progress is
            # what a resume needs
            self._clear_job_progress()
        model._output.run_time_ms = int((time.time() - t0) * 1000)
        model._output.start_time = t0
        self.model = model
        return model

    # -- durable job progress ------------------------------------------------
    def _job_ckpt_every(self) -> int:
        """The save interval in completed iterations; 0 when the knob is
        off or the builder cannot resume. It reads only the env and the
        capability: the value shapes the loop itself (chunked IRLS and
        Lloyd), whether or not this train saves."""
        if not self.supports_iteration_resume:
            return 0
        from h2o3_tpu_torch.parallel import ckpt

        return max(ckpt.job_ckpt_iters(), 0)

    def _tick_job_progress(self, done: int, state_fn) -> None:
        """Called by a fit loop after `done` completed iterations; every
        ``H2O_TPU_JOB_CKPT_ITERS`` saves `state_fn()` when the builder
        holds a progress job with a resume spec. A failed save is logged
        and training goes on. On a row-sharded cloud the train's
        collectives keep its ranks in step, so every rank is at the same
        iteration here."""
        every = self._job_ckpt_every()
        if every <= 0 or done <= 0 or done % every != 0:
            return
        if done == getattr(self, "_jp_last", 0):
            return
        self._jp_last = done
        from h2o3_tpu_torch.parallel import ckpt

        job = self._progress_job
        if job is not None and getattr(job, "resume_spec", None):
            try:
                ckpt.save_job_progress(str(job.key), done, job.resume_spec,
                                       state_fn())
            except Exception as e:   # noqa: BLE001 — best effort by
                from h2o3_tpu_torch.utils.log import get_logger  # contract

                get_logger().warning(
                    "job %s: progress save at iteration %d failed "
                    "(training goes on): %s", job.key, done, e)

    def _clear_job_progress(self) -> None:
        """Delete the progress of a completed train, under the progress
        job's status lock: an external FAILED already recorded there
        keeps it."""
        job = self._progress_job
        if job is None or not getattr(job, "resume_spec", None):
            return
        from h2o3_tpu_torch.parallel import ckpt

        try:
            with job._status_lock:
                if job.status == Job.FAILED and job.failed_externally:
                    return
                ckpt.delete_job_progress(str(job.key))
        except Exception:   # noqa: BLE001 — clean-up stays best effort
            pass

    def _take_resume_state(self, phase: str) -> Optional[dict]:
        """The saved loop state for the loop tagged `phase`, once: a
        second call (a CV fold's builder, another loop) gets None."""
        rs = self._resume_state
        if isinstance(rs, dict) and rs.get("phase") == phase:
            self._resume_state = None
            return rs
        return None

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
        y = widen(DataInfo.clean_response(y_col.data)).cpu().numpy()
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
        """-> (the fold id of each row this process holds, the folds, the
        assignment's digest): the fold column's values, or AUTO/Random
        (uniform draws), Stratified (per class, a round-robin over
        shuffled rows from a random start) or Modulo (row index mod
        nfolds). On a row-sharded cloud the ids are this rank's block:
        the draws are made over all n rows on every rank with one seed
        (rank 0's when it is fresh), so they and their digest are one
        process's; Stratified reads the rank's own response codes and
        the class counts of the ranks before it, and its digest is
        chained through the ranks (`_digest`); a fold column is read
        from the rank's own block, its folds are the union of the ranks'
        ids, and its digest is `fold_fingerprint`'s, which needs no rank
        to hold every id (ROADMAP C49)."""
        from h2o3_tpu_torch.core import sharded_frame as SF

        n = train.nrows
        mesh = SF.mesh_of(train) if SF._is_sharded(train) else None
        lo, hi = train.shard if mesh is not None else (0, n)
        if fold_col:
            c = train.col(fold_col)
            if mesh is None:
                assign = c.to_numpy().astype(int)
                return assign, sorted(set(assign.tolist())), _digest(assign)
            mine = widen(c.data).cpu().numpy().astype(int)
            folds = sorted(set().union(*SF.all_gather_object(
                mesh, sorted(set(mine.tolist())))))
            return mine, folds, fold_fingerprint(mine, lo, mesh)
        scheme = (self.params.get("fold_assignment") or "AUTO").lower()
        seed = self._seed()
        if mesh is not None:
            seed = SF.agreed_int(mesh, seed)
        if scheme in ("auto", "random"):
            rng = np.random.default_rng(seed)
            assign = rng.integers(0, nfolds, n)
        elif scheme == "stratified":
            from h2o3_tpu_torch.ops.filters import stratified_fold_ids

            resp = self.params.get("response_column")
            if not resp or not train.col(resp).is_categorical:
                raise ValueError("fold_assignment='Stratified' requires a "
                                 "categorical response")
            # NA responses keep their uniform draw; on a row-sharded
            # cloud each rank draws its own block's ids from the class
            # counts of the ranks before it, and the digest is chained
            # through the ranks: both are one process's
            yc = train.col(resp)
            codes = (yc.to_numpy() if mesh is None
                     else widen(yc.data).cpu().numpy())
            ids = stratified_fold_ids(codes, nfolds,
                                      np.random.default_rng(seed), n,
                                      lo=lo, mesh=mesh)
            return ids, list(range(nfolds)), _digest(ids, mesh)
        elif scheme == "modulo":
            assign = np.arange(n) % nfolds
        else:
            raise ValueError(f"unknown fold_assignment {scheme!r}")
        return assign[lo:hi], list(range(nfolds)), _digest(assign)

    def _cross_validate(self, train: Frame, nfolds: int,
                        fold_col: Optional[str]):
        """One model per fold, trained on the other folds' rows and scored
        on its own: -> (fold models, fold metrics, holdout predictions or
        None, digest of the fold assignment). On a row-sharded cloud each
        rank selects its own rows of a fold and the fold frames are placed
        through the row exchange, the metrics are the cloud's, and the
        holdout predictions are this rank's block of rows (a tensor),
        placed there once after the last fold."""
        from h2o3_tpu_torch.core import sharded_frame as SF
        from h2o3_tpu_torch.ops.filters import keep_rows

        assign, folds, digest = self._fold_assignment(train, nfolds,
                                                      fold_col)
        n = train.nrows
        mesh = SF.mesh_of(train) if SF._is_sharded(train) else None
        keep_preds = bool(self.params.get("keep_cross_validation_predictions"))
        models, mets = [], []
        preds_buf = None
        held_pos, held_vals = [], []
        drop = ("nfolds", "fold_column", "training_frame", "validation_frame",
                "model_id", "checkpoint", "export_checkpoints_dir")
        for fi, f in enumerate(folds):
            tr = keep_rows(train, torch.from_numpy(np.nonzero(assign != f)[0]))
            held = torch.from_numpy(np.nonzero(assign == f)[0])
            ho, ho_ids = keep_rows(train, held, with_ids=True)
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
                vals = raw["probs"] if "probs" in raw else raw["value"]
                if mesh is not None:
                    held_pos.append(ho_ids)
                    held_vals.append(vals.float())
                else:
                    vals = vals.cpu().numpy()
                    if preds_buf is None:
                        preds_buf = np.zeros((n,) + vals.shape[1:],
                                             np.float32)
                    preds_buf[ho_ids.numpy()] = vals
            models.append(m)
            if self.job:
                self.job.update(progress=0.5 * (fi + 1) / len(folds),
                                msg=f"CV fold {fi + 1}/{len(folds)}")
                if mesh is not None:
                    self.job.publish_progress()
        if held_pos:
            # every row is in one fold: the folds' rows cover the frame
            (preds_buf,), _ = SF.place_rows(
                mesh, torch.cat([p.to(held_vals[0].device) for p in held_pos]),
                n, [torch.cat([v.to(held_vals[0].device)
                               for v in held_vals])])
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


def _digest(assign: np.ndarray, mesh=None) -> str:
    """The fold assignment's digest: sha1 of its int64 ids, as the
    reference computes it; on a row-sharded cloud `assign` is this
    rank's block of ids, chained through the ranks in row order
    (native.chained_sha1), so no rank needs the others' ids."""
    ids = np.ascontiguousarray(assign, np.int64)
    if mesh is None:
        return hashlib.sha1(ids).hexdigest()
    from h2o3_tpu_torch import native

    return native.chained_sha1(ids.tobytes(), mesh)


_FP_PRIME = 2 ** 31 - 1
_FP_BASES = (1_000_003, 998_244_353)


def _powers(base: int, lo: int, m: int) -> np.ndarray:
    """base**(lo + t) mod the fingerprint's prime, t = 0..m-1."""
    out = np.ones(m, np.int64)
    if m:
        out[0] = pow(base, lo, _FP_PRIME)
    step, k = base % _FP_PRIME, 1
    while k < m:
        w = min(k, m - k)
        out[k:k + w] = out[:w] * step % _FP_PRIME
        step, k = step * step % _FP_PRIME, k + w
    return out


def fold_fingerprint(ids: np.ndarray, lo: int = 0, mesh=None) -> str:
    """A digest of a fold column's ids that no process needs every id
    for: two polynomial hashes, sum_i id_i * b**i mod 2**31 - 1 over the
    global row index i, each rank summing its rows [lo, lo + len(ids))
    and the ranks' sums added. It depends on the ids alone, not on how
    many ranks hold them."""
    v = np.asarray(ids, np.int64) % _FP_PRIME
    sums = [int(np.sum(v * _powers(b, lo, len(v)) % _FP_PRIME)) % _FP_PRIME
            for b in _FP_BASES]
    n = len(v)
    if mesh is not None:
        every = mesh.all_gather(torch.tensor([[n] + sums],
                                             dtype=torch.int64)).tolist()
        n = sum(r[0] for r in every)
        sums = [sum(r[1 + j] for r in every) % _FP_PRIME
                for j in range(len(_FP_BASES))]
    return hashlib.sha1(f"fold_column:{n}:{sums[0]}:{sums[1]}".encode()
                        ).hexdigest()


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
