"""DataInfo: columns -> numeric design matrix, and response preparation
(counterpart of h2o3_tpu/models/data_info.py: `_device_mode` :25,
`DataInfo` :45 with its arguments :53-65, `coef_names` :109, `expand` :123, `na_row_mask` :149,
`response_weight` :169, `clean_response` :183).

The layout is the reference's: categoricals first, one-hot with an
optional first-level drop, then numerics, mean/mode-imputed and
optionally standardised with moments from the columns' rollups.
`expand` turns the predictor columns into a dense (rows, fullN) float32
block on their device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame


def _device_mode(col: Column) -> int:
    """Most frequent level of a categorical column (the first on ties),
    counted on the column's device (over every rank of a row mesh)."""
    from h2o3_tpu_torch.core.sharded_frame import mesh_of

    card = max(col.cardinality, 1)
    codes = col.data.long()
    valid = codes >= 0
    counts = torch.zeros(card, dtype=torch.int64, device=codes.device)
    counts.index_add_(0, torch.clamp_min(codes, 0), valid.long())
    mesh = mesh_of(col)
    if mesh is not None:
        mesh.all_reduce(counts, "sum")
    return int(torch.argmax(counts))


def exact_moments(col: Column):
    """(mean, sigma) of a numeric column from the order-free fixed-point
    sums of its float32 values and their squares (core/ops): the same
    bits on every device and for every split of the rows into ranks,
    finished as the rollups finish theirs."""
    from h2o3_tpu_torch.core.frame import widen
    from h2o3_tpu_torch.core.ops import fixed_point_sums
    from h2o3_tpu_torch.core.sharded_frame import mesh_of

    x = widen(col.data).float()
    valid = ~torch.isnan(x)
    x = torch.where(valid, x, 0.0)
    n, s, ss = fixed_point_sums(torch.stack([valid.float(), x, x * x], 1),
                                mesh_of(col)).tolist()
    if not n:
        return float("nan"), 0.0
    mean = s / n
    var = max(ss / n - mean * mean, 0.0)
    return mean, float(np.sqrt(var * n / (n - 1))) if n > 1 else 0.0


class DataInfo:
    """Expansion plan for a predictor set + response.

    use_all_factor_levels: False drops the first level per categorical
    (GLM drops, DL keeps). The weights and offset columns are never
    predictors. missing_values_handling is kept for the caller ("Skip"
    zeroes the weight of rows with an NA predictor, via na_row_mask);
    expand always imputes."""

    def __init__(self, frame: Frame, response: Optional[str] = None,
                 *, ignored: Sequence[str] = (),
                 weights: Optional[str] = None, offset: Optional[str] = None,
                 standardize: bool = True, use_all_factor_levels: bool = False,
                 missing_values_handling: str = "MeanImputation",
                 exact: bool = False):
        self.response_name = response
        self.weights_name = weights
        self.offset_name = offset
        self.standardize = standardize
        self.missing_values_handling = missing_values_handling
        skip = set(ignored) | {response, weights, offset}
        self.cat_names: List[str] = []
        self.num_names: List[str] = []
        for n in frame.names:
            c = frame.col(n)
            if n in skip or c.is_string:
                continue
            (self.cat_names if c.is_categorical else self.num_names).append(n)
        # categoricals first, then numerics (the reference's ordering)
        self.predictor_names = self.cat_names + self.num_names
        self.domains = {n: list(frame.col(n).domain or [])
                        for n in self.cat_names}
        self.cards = [len(self.domains[n]) for n in self.cat_names]
        self._recompute_layout(use_all_factor_levels)

        # `exact`: moments that do not depend on how the rows are split
        # (DeepLearning's weights across ranks are one process's)
        means, sigmas = [], []
        for n in self.num_names:
            if exact:
                mean, sigma = exact_moments(frame.col(n))
            else:
                r = frame.col(n).rollups
                mean, sigma = r.mean, r.sigma
            means.append(mean)
            sigmas.append(sigma if sigma and sigma > 0 else 1.0)
        modes = [_device_mode(frame.col(n)) for n in self.cat_names]
        self.num_means = np.asarray(means, np.float32)
        self.num_sigmas = (np.asarray(sigmas, np.float32) if sigmas
                           else np.ones(0, np.float32))
        self.cat_modes = np.asarray(modes, np.int32)
        # NA fill on the raw scale
        self.impute_values = self.num_means.copy()

    @classmethod
    def from_state(cls, d: dict) -> "DataInfo":
        """A DataInfo from its plain state (the attributes `expand` and
        `coef_names` read), as a model trained elsewhere carries it."""
        di = cls.__new__(cls)
        di.response_name = d.get("response_name")
        di.weights_name = d.get("weights_name")
        di.offset_name = d.get("offset_name")
        di.missing_values_handling = d.get("missing_values_handling",
                                           "MeanImputation")
        di.standardize = bool(d["standardize"])
        di.cat_names = list(d["cat_names"])
        di.num_names = list(d["num_names"])
        di.predictor_names = di.cat_names + di.num_names
        di.domains = {k: list(v) for k, v in dict(d["domains"]).items()}
        di.cards = [int(c) for c in d["cards"]]
        di._recompute_layout(bool(d["use_all_factor_levels"]))
        di.num_means = np.asarray(d["num_means"], np.float32)
        di.num_sigmas = np.asarray(d["num_sigmas"], np.float32)
        di.cat_modes = np.asarray(d["cat_modes"], np.int32)
        di.impute_values = np.asarray(d.get("impute_values", di.num_means),
                                      np.float32)
        return di

    def _recompute_layout(self, use_all_factor_levels: bool) -> None:
        self.use_all_factor_levels = use_all_factor_levels
        base = 0 if use_all_factor_levels else 1
        self.cat_widths = [max(c - base, 1) for c in self.cards]
        self.cat_offsets = np.concatenate(
            [[0], np.cumsum(self.cat_widths)]).astype(int)
        self.num_offset = int(self.cat_offsets[-1])
        self.fullN = self.num_offset + len(self.num_names)

    def set_use_all_factor_levels(self, flag: bool) -> None:
        self._recompute_layout(flag)

    def coef_names(self) -> List[str]:
        out = []
        base = 0 if self.use_all_factor_levels else 1
        for n, card in zip(self.cat_names, self.cards):
            dom = self.domains[n]
            for lvl in range(base, max(card, base + 1)):
                out.append(f"{n}.{dom[lvl] if lvl < len(dom) else lvl}")
        out.extend(self.num_names)
        return out

    def cols(self, frame: Frame) -> List[Column]:
        return [frame.col(n) for n in self.predictor_names]

    def expand(self, *arrays) -> torch.Tensor:
        """Predictor tensors (cats first) -> (rows, fullN) float32: NAs
        imputed (mean for numerics, mode for categorical codes), one-hot
        with optional first-level drop, numerics standardised."""
        dev = arrays[0].device

        def t(a):
            return torch.as_tensor(a, device=dev)

        return expand_columns(
            arrays, t(self.cat_modes.astype(np.int64)),
            t(self.impute_values), t(self.num_means), t(self.num_sigmas),
            cards=tuple(int(c) for c in self.cards),
            use_all_factor_levels=self.use_all_factor_levels,
            standardize=self.standardize, n_cat=len(self.cat_names))

    def na_row_mask(self, *arrays) -> torch.Tensor:
        """1.0 where any predictor is NA, else 0.0."""
        ncat = len(self.cat_names)
        any_na = torch.zeros(arrays[0].shape[0], dtype=torch.bool,
                             device=arrays[0].device)
        for i in range(ncat):
            any_na = any_na | (arrays[i] < 0)
        for j in range(len(self.num_names)):
            any_na = any_na | torch.isnan(arrays[ncat + j])
        return any_na.float()

    @staticmethod
    def response_weight(y, w=None):
        """Effective row weight: user weights x response-valid mask (NA
        responses, NaN or a -1 code, drop out)."""
        valid = (y >= 0) if not torch.is_floating_point(y) \
            else ~torch.isnan(y)
        base = valid.float()
        if w is not None:
            base = base * torch.where(torch.isnan(w), 0.0, w).float()
        return base

    @staticmethod
    def clean_response(y):
        """Replace the NA sentinel with 0 so math stays finite (weights are
        already 0 there)."""
        if not torch.is_floating_point(y):
            return torch.clamp_min(y, 0)
        return torch.where(torch.isnan(y), 0.0, y)


def expand_columns(arrays, cat_modes, impute_values, num_means, num_sigmas,
                   *, cards: tuple, use_all_factor_levels: bool,
                   standardize: bool, n_cat: int) -> torch.Tensor:
    """DataInfo.expand over moments given as tensors on the columns'
    device, so the expansion syncs with the host nowhere: the GLM
    artifact exports it (artifact/glm.py) and the standalone runner
    captures it in a CUDA graph."""
    parts = []
    base = 0 if use_all_factor_levels else 1
    for i in range(n_cat):
        codes = arrays[i].long()
        codes = torch.where(codes < 0, cat_modes[i], codes)
        card = max(cards[i], base + 1)
        oh = torch.nn.functional.one_hot(codes, card).float()
        parts.append(oh[:, base:] if base else oh)
    n_num = len(arrays) - n_cat
    if n_num:
        nums = torch.stack([arrays[n_cat + j].float() for j in range(n_num)],
                           dim=-1)
        nums = torch.where(torch.isnan(nums), impute_values[None, :], nums)
        if standardize:
            nums = (nums - num_means[None, :]) / num_sigmas[None, :]
        parts.append(nums)
    if not parts:
        raise ValueError("no predictors")
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
