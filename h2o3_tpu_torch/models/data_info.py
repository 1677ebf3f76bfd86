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
    counted on the column's device."""
    card = max(col.cardinality, 1)
    codes = col.data.long()
    valid = codes >= 0
    counts = torch.zeros(card, dtype=torch.int64, device=codes.device)
    counts.index_add_(0, torch.clamp_min(codes, 0), valid.long())
    return int(torch.argmax(counts))


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
                 missing_values_handling: str = "MeanImputation"):
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

        means, sigmas = [], []
        for n in self.num_names:
            r = frame.col(n).rollups
            means.append(r.mean)
            sigmas.append(r.sigma if r.sigma and r.sigma > 0 else 1.0)
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
        ncat = len(self.cat_names)
        parts = []
        base = 0 if self.use_all_factor_levels else 1
        for i in range(ncat):
            codes = arrays[i].long()
            codes = torch.where(codes < 0, int(self.cat_modes[i]), codes)
            card = max(self.cards[i], base + 1)
            oh = torch.nn.functional.one_hot(codes, card).float()
            parts.append(oh[:, base:] if base else oh)
        if self.num_names:
            dev = arrays[ncat].device
            nums = torch.stack([arrays[ncat + j].float()
                                for j in range(len(self.num_names))], dim=-1)
            fill = torch.as_tensor(self.impute_values, device=dev)
            nums = torch.where(torch.isnan(nums), fill[None, :], nums)
            if self.standardize:
                mean = torch.as_tensor(self.num_means, device=dev)
                sigma = torch.as_tensor(self.num_sigmas, device=dev)
                nums = (nums - mean[None, :]) / sigma[None, :]
            parts.append(nums)
        if not parts:
            raise ValueError("no predictors")
        return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]

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
