"""Pool-adjacent-violators isotonic regression on one feature, the part
isotonic calibration needs (counterpart of h2o3_tpu/models/isotonic.py:
`pava` :24, `interpolate` :63; the IsotonicRegression builder is still to
port, ROADMAP A12).

The fit is sequential merging over sorted, aggregated host arrays, so it
runs on the host once; scoring is a device searchsorted and a gathered
linear interpolation between the knots, clipped to the knot range.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def pava(x: np.ndarray, y: np.ndarray, w: Optional[np.ndarray] = None):
    """Weighted PAVA: -> (knots x, fitted y), x strictly increasing and
    the fitted values non-decreasing. Tied x collapse to their weighted
    mean first."""
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order]
    ws = w[order] if w is not None else np.ones_like(xs)
    ux, inv = np.unique(xs, return_inverse=True)
    wsum = np.bincount(inv, weights=ws)
    ysum = np.bincount(inv, weights=ws * ys)
    vals = ysum / np.maximum(wsum, 1e-12)
    bv: list = []      # block value
    bw: list = []      # block weight
    bn: list = []      # knots in the block
    for v, wt in zip(vals, wsum):
        bv.append(v)
        bw.append(wt)
        bn.append(1)
        while len(bv) > 1 and bv[-2] > bv[-1]:
            v2, w2, n2 = bv.pop(), bw.pop(), bn.pop()
            bv[-1] = (bv[-1] * bw[-1] + v2 * w2) / (bw[-1] + w2)
            bw[-1] += w2
            bn[-1] += n2
    fitted = np.repeat(bv, bn)
    return ux.astype(np.float64), fitted.astype(np.float64)


def interpolate(thresholds_x, thresholds_y, x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation over the knots (float32, on x's
    device), x clipped to the knot range; NaN x stays NaN."""
    dev = x.device
    tx = torch.as_tensor(np.asarray(thresholds_x, np.float32), device=dev)
    ty = torch.as_tensor(np.asarray(thresholds_y, np.float32), device=dev)
    if len(thresholds_x) == 1:
        out = torch.full(x.shape, float(thresholds_y[0]), dtype=torch.float32,
                         device=dev)
        return torch.where(torch.isnan(x), float("nan"), out)
    xc = torch.clamp(x, tx[0], tx[-1])
    hi = torch.clamp(torch.searchsorted(tx, xc, right=True), 1,
                     len(tx) - 1)
    lo = hi - 1
    x0, x1 = tx[lo], tx[hi]
    t = torch.where(x1 > x0, (xc - x0) / torch.clamp_min(x1 - x0, 1e-12),
                    0.0)
    out = ty[lo] + t * (ty[hi] - ty[lo])
    return torch.where(torch.isnan(x), float("nan"), out)
