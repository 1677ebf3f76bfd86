"""TargetEncoder: per-level target means of categorical columns
(counterpart of h2o3_tpu/models/target_encoder.py: `_level_sums` :31,
`TargetEncoderModel._blend` :84, `transform` :90, `_fit` :218).

Training sums, per encoded column and level, the response weight (den)
and the weighted response (num) on the frame's device, and with
data_leakage_handling="KFold" the same per (fold, level). The sums are
core/ops.fixed_point_segment_sum's (order-free, so the card and the
CPU agree bit for bit; ROADMAP C14 bounds them against the reference's
scatter-add). `transform` appends `<col>_te` columns on the host:
num/den per level, blended toward the prior with λ(n) = 1/(1 +
e^((k−n)/f)) when `blending`, out-of-fold (KFold) or leaving the row
out (LeaveOneOut) on training data, plus uniform noise drawn with the
reference's numpy Generator.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.core.ops import fixed_point_segment_sum
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import (ModelBuilder, random_seed,
                                                 register)


def _level_sums(codes, y, w, card: int, folds=None, nfolds: int = 0):
    """Per-level (num, den) float64 host arrays; with folds also the
    (nfolds, card) per-fold tables, else None for both."""
    valid = codes >= 0
    c = torch.clamp_min(codes.long(), 0)
    wv = torch.where(valid, w, 0.0).float()
    num = fixed_point_segment_sum(c, wv * y, card)
    den = fixed_point_segment_sum(c, wv, card)
    host = lambda t: t.cpu().numpy().astype(np.float64)  # noqa: E731
    if folds is None:
        return host(num), host(den), None, None
    idx = torch.clamp(folds.long(), 0, nfolds - 1) * card + c
    fn = fixed_point_segment_sum(idx, wv * y, nfolds * card)
    fd = fixed_point_segment_sum(idx, wv, nfolds * card)
    return (host(num), host(den), host(fn).reshape(nfolds, card),
            host(fd).reshape(nfolds, card))


class TargetEncoderModel(Model):
    algo_name = "targetencoder"

    def __init__(self, parms=None, key=None):
        super().__init__(parms, key)
        # per encoded column: domain, (card,) num and den, and the
        # per-fold tables or None
        self.encodings: Dict[str, dict] = {}
        self.prior: float = 0.0
        self.nfolds: int = 0

    def _predict_raw(self, frame: Frame):
        from h2o3_tpu_torch.errors import CapabilityGate

        raise CapabilityGate("TargetEncoder has no predict; use transform()")

    def predict(self, frame: Frame, key: Optional[str] = None) -> Frame:
        return self.transform(frame, key=key)

    def _blend(self, post, prior, n, blending, k, f):
        if not blending:
            return np.where(n > 0, post, prior)
        lam = 1.0 / (1.0 + np.exp((k - n) / max(f, 1e-12)))
        return np.where(n > 0, lam * post + (1 - lam) * prior, prior)

    def transform(self, frame: Frame, *, as_training: bool = False,
                  blending: Optional[bool] = None,
                  inflection_point: Optional[float] = None,
                  smoothing: Optional[float] = None,
                  noise: Optional[float] = None,
                  key: Optional[str] = None) -> Frame:
        """`frame` with a `<col>_te` encoding appended per encoded column
        (and the encoded originals dropped unless
        keep_original_categorical_columns)."""
        p = self._parms
        blending = bool(p.get("blending")) if blending is None else blending
        k = float(inflection_point if inflection_point is not None
                  else p.get("inflection_point", 10.0) or 10.0)
        f = float(smoothing if smoothing is not None
                  else p.get("smoothing", 20.0) or 20.0)
        noise = (float(p.get("noise", 0.01) if noise is None else noise)
                 or 0.0)
        leakage = str(p.get("data_leakage_handling")
                      or "None").lower().replace("_", "")
        seed = int(p.get("seed") or -1)
        rng = np.random.default_rng(seed if seed >= 0 else random_seed())

        keep_orig = bool(p.get("keep_original_categorical_columns", True))
        out = Frame(key=key)
        for n in frame.names:
            if keep_orig or n not in self.encodings:
                out.add(n, frame.col(n))
        resp = self._output.response_name
        y_np = w_np = None
        if as_training and resp in frame:
            yc = frame.col(resp)
            yv = yc.to_numpy()
            if yc.is_categorical:
                w_np = (yv >= 0).astype(np.float64)
                y_np = np.maximum(yv, 0).astype(np.float32).astype(np.float64)
            else:
                w_np = (~np.isnan(yv)).astype(np.float64)
                y_np = np.where(np.isnan(yv), 0.0, yv).astype(np.float64)
        fold_np = None
        fold_col = p.get("fold_column")
        if as_training and leakage == "kfold" and fold_col \
                and fold_col in frame:
            fold_np = np.clip(frame.col(fold_col).to_numpy().astype(np.int32),
                              0, self.nfolds - 1)

        for col, enc in self.encodings.items():
            if col not in frame or not frame.col(col).is_categorical:
                continue
            c = frame.col(col)
            codes = c.to_numpy().astype(np.int64)
            if (c.domain or []) != enc["domain"]:
                # onto the training domain; unseen levels become NA
                lut_map = {v: i for i, v in enumerate(enc["domain"])}
                lut = np.array([lut_map.get(v, -1) for v in (c.domain or [])]
                               or [-1], np.int64)
                codes = np.where(codes >= 0, lut[np.maximum(codes, 0)], -1)
            ci = np.maximum(codes, 0)
            num, den = enc["num"], enc["den"]
            if as_training and leakage == "kfold" \
                    and enc.get("fold_num") is not None \
                    and fold_np is not None:
                num_t = num[None, :] - enc["fold_num"]    # out of fold
                den_t = den[None, :] - enc["fold_den"]
                post = np.where(den_t > 0, num_t / np.maximum(den_t, 1e-12),
                                self.prior)
                tbl = self._blend(post, self.prior, den_t, blending, k, f)
                vals = np.where(codes >= 0, tbl[fold_np, ci], self.prior)
            elif as_training and leakage == "leaveoneout" \
                    and y_np is not None:
                n_i = np.where(codes >= 0, den[ci] - w_np, 0.0)
                s_i = np.where(codes >= 0, num[ci] - w_np * y_np, 0.0)
                post = np.where(n_i > 0, s_i / np.maximum(n_i, 1e-12),
                                self.prior)
                vals = np.where(codes >= 0,
                                self._blend(post, self.prior, n_i, blending,
                                            k, f),
                                self.prior)
            else:
                post = np.where(den > 0, num / np.maximum(den, 1e-12),
                                self.prior)
                tbl = self._blend(post, self.prior, den, blending, k, f)
                vals = np.where(codes >= 0, tbl[ci], self.prior)
            if as_training and noise > 0:
                vals = vals + rng.uniform(-noise, noise, len(vals))
            out.add(f"{col}_te", Column.from_numpy(vals.astype(np.float64),
                                                   device=c.device))
        return out


@register
class TargetEncoder(ModelBuilder):
    algo_name = "targetencoder"
    model_class = TargetEncoderModel

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "columns_to_encode": None,       # default: every categorical
            "keep_original_categorical_columns": True,
            "blending": False,
            "inflection_point": 10.0,        # k
            "smoothing": 20.0,               # f
            "data_leakage_handling": "None",  # None / LeaveOneOut / KFold
            "noise": 0.01,
        })
        return p

    def _train_impl(self, train: Frame, valid: Optional[Frame]
                    ) -> TargetEncoderModel:
        return self._fit(train)

    def _fit(self, train: Frame) -> TargetEncoderModel:
        model = TargetEncoderModel(parms=dict(self.params))
        out = self._init_output(model, train)
        resp = self.params["response_column"]
        yc = train.col(resp)
        if yc.is_categorical:
            if len(yc.domain or []) > 2:
                raise ValueError("TargetEncoder supports binary or numeric "
                                 "responses")
            y = torch.clamp_min(yc.data, 0).float()
            w = (yc.data >= 0).float()
        else:
            y = torch.where(torch.isnan(yc.data), 0.0, yc.data)
            w = (~torch.isnan(yc.data)).float()
        wname = self.params.get("weights_column")
        if wname and wname in train:
            w = w * train.col(wname).data

        leakage = str(self.params.get("data_leakage_handling")
                      or "None").lower().replace("_", "")
        folds, nfolds = None, 0
        fold_col = self.params.get("fold_column")
        if leakage == "kfold":
            if not fold_col or fold_col not in train:
                raise ValueError("data_leakage_handling='KFold' requires a "
                                 "fold_column")
            folds = train.col(fold_col).data.int()
            nfolds = int(folds.max()) + 1
        model.nfolds = nfolds

        wanted = self.params.get("columns_to_encode")
        cols = [c for c in out.names if train.col(c).is_categorical
                and (not wanted or c in wanted)]
        tot_w = float(torch.sum(w))
        tot_wy = float(torch.sum(w * y))
        model.prior = tot_wy / max(tot_w, 1e-12)
        for cname in cols:
            c = train.col(cname)
            num, den, fnum, fden = _level_sums(
                c.data, y, w, max(c.cardinality, 1), folds=folds,
                nfolds=nfolds)
            model.encodings[cname] = {
                "domain": list(c.domain or []), "num": num, "den": den,
                "fold_num": fnum, "fold_den": fden}
        out.model_category = ModelCategory.Unknown
        return model
