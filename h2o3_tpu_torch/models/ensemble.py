"""StackedEnsemble: a metalearner over the base models' cross-validated
predictions (counterpart of h2o3_tpu/models/ensemble.py: `_resolve` :26,
`_level_one_columns` :34, `StackedEnsembleModel._predict_raw` :66,
`_fit` :86, the level-one frame :86-118, the metalearners :121-151).

The base models (Models or their DKV keys) must have been
cross-validated with one fold assignment and have kept their holdout
predictions. The level-one frame holds, per base model, its holdout
P(class 1) (binomial), every class's holdout probability (multinomial)
or its holdout value (regression), plus the response and the weights.
The metalearner trains on it: AUTO is a non-negative GLM without
regularisation; GLM, GBM, DRF and DeepLearning are the port's builders.
Scoring runs each base model's scoring on the frame's device and the
metalearner's on their stacked outputs.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from h2o3_tpu_torch.core.dkv import DKV
from h2o3_tpu_torch.core.frame import Column, Frame, T_NUM
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.models.model_builder import (BUILDERS, ModelBuilder,
                                                 register)


def _resolve(m) -> Model:
    if isinstance(m, Model):
        return m
    got = DKV.get(str(m))
    if got is None:
        raise ValueError(f"base model {m!r} not found")
    return got


def _level_one_columns(raw: dict, prefix: str):
    """A base model's predictions -> its level-one columns: P(class 1)
    of a binomial, each class's probability of a multinomial, the value
    of a regression."""
    if "probs" in raw:
        probs = raw["probs"]
        k = probs.shape[1]
        if k == 2:
            return {prefix: probs[:, 1]}
        return {f"{prefix}_p{j}": probs[:, j] for j in range(k)}
    return {prefix: raw["value"]}


class StackedEnsembleModel(Model):
    algo_name = "stackedensemble"

    def __init__(self, parms=None, key=None):
        super().__init__(parms, key)
        self.base_keys: List[str] = []
        self.metalearner: Optional[Model] = None

    def _level_one(self, frame: Frame) -> Frame:
        lf = Frame()
        n = frame.nrows
        for bk in self.base_keys:
            bm = _resolve(bk)
            raw = bm._predict_raw(bm.adapt_test(frame))
            for name, arr in _level_one_columns(raw, bk).items():
                lf.add(name, Column(arr.contiguous(), T_NUM, n))
        return lf

    def _predict_raw(self, frame: Frame):
        lf = self._level_one(frame)
        return self.metalearner._predict_raw(self.metalearner.adapt_test(lf))


METALEARNERS = ("glm", "gbm", "drf", "deeplearning")


def _metalearner(algo: str, mparams: dict, y_col: Column) -> ModelBuilder:
    """The metalearner's builder; AUTO is a non-negative, unpenalised
    GLM of the response's family."""
    if algo in ("auto", "glm"):
        if y_col.is_categorical:
            fam = "binomial" if y_col.cardinality == 2 else "multinomial"
        else:
            fam = "gaussian"
        mparams.setdefault("family", fam)
        if algo == "auto":
            mparams.setdefault("non_negative", True)
            mparams.setdefault("lambda_", 0.0)
            algo = "glm"
    if algo not in METALEARNERS:
        raise ValueError(f"unknown metalearner_algorithm {algo!r}")
    return BUILDERS[algo](**mparams)


@register
class StackedEnsemble(ModelBuilder):
    algo_name = "stackedensemble"
    model_class = StackedEnsembleModel

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "base_models": [],
            # AUTO (a GLM), glm, gbm, drf or deeplearning
            "metalearner_algorithm": "AUTO",
            "metalearner_nfolds": 0,
            "metalearner_params": {},
        })
        return p

    def _fit(self, train: Frame) -> StackedEnsembleModel:
        p = self.params
        resp = p["response_column"]
        bases = [_resolve(b) for b in (p.get("base_models") or [])]
        if len(bases) < 1:
            raise ValueError("stackedensemble requires base_models")
        # the level-one rows mix in-fold and out-of-fold predictions
        # unless every base model used the same folds
        digests = {bm._output.fold_assignment_digest for bm in bases
                   if bm._output.fold_assignment_digest is not None}
        if len(digests) > 1:
            raise ValueError(
                "base models were cross-validated with different fold "
                "assignments; train them with the same nfolds/"
                f"fold_assignment/seed (saw {len(digests)} distinct "
                "assignments)")
        lf = Frame()
        n = train.nrows
        dev = train.col(resp).device
        for bm in bases:
            cvp = bm._output.cross_validation_holdout_predictions
            if cvp is None:
                raise ValueError(
                    f"base model {bm.key} lacks cross-validation predictions "
                    "(train with nfolds>1 and "
                    "keep_cross_validation_predictions=True)")
            if len(cvp) != n:
                raise ValueError(f"base model {bm.key} was trained on a "
                                 "different frame")
            raw = {"probs": cvp} if cvp.ndim == 2 else {"value": cvp}
            for name, arr in _level_one_columns(raw, str(bm.key)).items():
                lf.add(name, Column.from_numpy(np.ascontiguousarray(arr),
                                               device=dev))
        lf.add(resp, train.col(resp))
        if p.get("weights_column"):
            lf.add(p["weights_column"], train.col(p["weights_column"]))

        algo = (p.get("metalearner_algorithm") or "AUTO").lower()
        mparams = dict(p.get("metalearner_params") or {})
        mparams.setdefault("seed", self._seed())
        builder = _metalearner(algo, mparams, train.col(resp))
        nfolds = int(p.get("metalearner_nfolds", 0) or 0)
        extra = {"nfolds": nfolds} if nfolds > 1 else {}
        if p.get("weights_column"):
            extra["weights_column"] = p["weights_column"]
        meta = builder.train(y=resp, training_frame=lf, **extra)

        model = StackedEnsembleModel(parms=dict(p))
        self._init_output(model, train)
        model.base_keys = [str(b.key) for b in bases]
        model.metalearner = meta
        # the metalearner's CV metrics are the ensemble's own estimate of
        # how it generalises
        if meta._output.cross_validation_metrics is not None:
            model._output.cross_validation_metrics = \
                meta._output.cross_validation_metrics
        return model
