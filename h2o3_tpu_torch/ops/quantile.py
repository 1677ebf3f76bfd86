"""Exact column quantiles by histogram refinement (counterpart of
h2o3_tpu/ops/quantile.py `quantile_column`, `quantile_frame` and `_select_kth`,
`_hist_pass`, `_minmax_in_bin`).

Each order statistic is found by 1024-bin histogram passes over the
column on its device: the pass counts the values in [lo, hi], the host
finds the bin holding the target rank and narrows to it, until the bin
holds one value or is as narrow as float32 allows; then the smallest
value in it is the answer. Quantiles combine order statistics by
interpolation type 7 (H2O's and R's default). The bin of a value is
computed in float32 from float32 bounds, as the reference computes it,
and the counts are exact integers (the reference's float32 counts are
exact below 2^24 a bin), so the same column gives the same quantiles bit
for bit.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

NBINS = 1024


def _hist_pass(data: torch.Tensor, lo: float, hi: float):
    """(counts (NBINS,) int64 on the host, count of values below lo) of
    the non-NaN values in [lo, hi]; lo and hi are float32 values."""
    lo_t = torch.tensor(lo, dtype=torch.float32, device=data.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=data.device)
    ok = ~torch.isnan(data)
    valid = ok & (data >= lo_t) & (data <= hi_t)
    x = torch.where(valid, data, lo_t)
    scale = NBINS / torch.clamp_min(hi_t - lo_t, 1e-38)
    idx = torch.clamp(((x - lo_t) * scale).to(torch.int32), 0, NBINS - 1)
    # invalid rows land in an extra bin that is dropped
    idx = torch.where(valid, idx.long(), NBINS)
    cnt = torch.bincount(idx, minlength=NBINS + 1)[:NBINS]
    below = torch.sum(ok & (data < lo_t))
    out = torch.cat([cnt, below[None]]).cpu().numpy()
    return out[:NBINS], int(out[NBINS])


def _min_in(data: torch.Tensor, lo: float, hi: float) -> float:
    lo_t = torch.tensor(lo, dtype=torch.float32, device=data.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=data.device)
    valid = ~torch.isnan(data) & (data >= lo_t) & (data <= hi_t)
    return float(torch.min(torch.where(valid, data, torch.inf)))


def _f32(v: float) -> float:
    return float(np.float32(v))


def _select_kth(data: torch.Tensor, lo: float, hi: float, k: int) -> float:
    """The 0-based k-th order statistic by histogram descent
    (quantile.py `_select_kth`)."""
    for _ in range(8):
        cnt, base = _hist_pass(data, _f32(lo), _f32(hi))
        cum = base + np.cumsum(cnt)
        b = min(int(np.searchsorted(cum, k + 1)), len(cnt) - 1)
        width = (hi - lo) / NBINS
        blo = lo + b * width
        bhi = blo + width
        if cnt[b] <= 1 or width <= abs(blo) * 1e-7 + 1e-38:
            mn = _min_in(data, _f32(blo), _f32(bhi))
            return mn if np.isfinite(mn) else blo
        lo, hi = blo, bhi
    mn = _min_in(data, _f32(lo), _f32(hi))
    return mn if np.isfinite(mn) else lo


def quantile_column(col, probs: Sequence[float]) -> List[float]:
    """Type-7 quantiles of a numeric column at `probs`."""
    r = col.rollups
    n = r.rows
    if n == 0:
        return [float("nan")] * len(probs)
    out = []
    for p in probs:
        h = (n - 1) * float(p)
        k = int(np.floor(h))
        frac = h - k
        lo, hi = float(r.min), float(r.max)
        if lo == hi:
            out.append(lo)
            continue
        v_k = _select_kth(col.data, lo, hi, k)
        if frac == 0.0:
            out.append(v_k)
        else:
            v_k1 = _select_kth(col.data, lo, hi, k + 1)
            out.append(v_k * (1 - frac) + v_k1 * frac)
    return out


def quantile_frame(frame, probs: Sequence[float]):
    """{name: quantiles} of every numeric column of `frame`."""
    return {n: quantile_column(frame.col(n), probs)
            for n in frame.names if frame.col(n).is_numeric}
