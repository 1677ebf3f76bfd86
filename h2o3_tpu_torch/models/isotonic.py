"""Pool-adjacent-violators isotonic regression on one feature: the fit
and scoring isotonic calibration uses, and the IsotonicRegression
builder (counterpart of h2o3_tpu/models/isotonic.py: `pava` :24,
`interpolate` :63, `IsotonicRegressionModel` :73, `IsotonicRegression`
:97).

The fit is sequential merging over sorted, aggregated host arrays, so it
runs on the host once; scoring is a device searchsorted and a gathered
linear interpolation between the knots, clipped to the knot range.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register


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


class IsotonicRegressionModel(Model):
    algo_name = "isotonicregression"

    def __init__(self, parms=None, key=None):
        super().__init__(parms, key)
        self.thresholds_x: Optional[np.ndarray] = None
        self.thresholds_y: Optional[np.ndarray] = None

    def _predict_raw(self, frame: Frame):
        x = frame.col(self._output.names[0]).data
        out = interpolate(self.thresholds_x, self.thresholds_y, x)
        if str(self._parms.get("out_of_bounds", "clip")).lower() == "na":
            # outside the training range -> NA
            out = torch.where((x < float(self.thresholds_x[0]))
                              | (x > float(self.thresholds_x[-1])),
                              float("nan"), out)
        return {"value": out}


@register
class IsotonicRegression(ModelBuilder):
    """A non-decreasing fit of the response on one numeric predictor;
    rows with a non-finite x, y or weight, or a weight of 0, are left
    out."""

    algo_name = "isotonicregression"
    model_class = IsotonicRegressionModel

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({"out_of_bounds": "clip"})
        return p

    def _fit(self, train: Frame) -> IsotonicRegressionModel:
        model = IsotonicRegressionModel(parms=dict(self.params))
        out = self._init_output(model, train)
        numeric = [n for n in out.names if train.col(n).is_numeric]
        if len(numeric) != 1:
            raise ValueError("IsotonicRegression needs exactly one numeric "
                             f"predictor, got {numeric}")
        out.names = numeric
        out.model_category = ModelCategory.Regression
        resp = self.params["response_column"]
        x = train.col(numeric[0]).to_numpy().astype(np.float64)
        y = train.col(resp).to_numpy().astype(np.float64)
        w = None
        if self.params.get("weights_column"):
            w = train.col(self.params["weights_column"]).to_numpy()
        ok = np.isfinite(x) & np.isfinite(y)
        if w is not None:
            ok &= np.isfinite(w) & (w > 0)
            w = w[ok]
        model.thresholds_x, model.thresholds_y = pava(x[ok], y[ok], w)
        return model
