"""GAM: spline bases, then GLM (counterpart of h2o3_tpu/models/gam.py:
the bases `_thinplate_basis` :26, `_bspline_cols` :43, `_mspline_basis`
:82, `_ispline_basis` :99, `_nspline_basis` :118, `GAMModel` :143 with
`_expand_frame` :166, `GAM._fit` :218).

Each gam column gets knots at its quantiles (ops/quantile.py, bitwise
the reference's) and one basis: 0 natural cubic regression splines
(the default), 1 thin plate, 2 monotone I-splines, 3 M-splines. The
basis columns replace the raw column, and the port's GLM fits the
expanded frame with a ridge from `scale` (an explicit `lambda_` wins)
and, when any column is I-spline, non-negative coefficients. Bases are
elementwise float32 maps on the frame's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_NUM
from h2o3_tpu_torch.models.glm import GLM
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register
from h2o3_tpu_torch.ops.quantile import quantile_column


def thinplate_basis(knots: np.ndarray):
    """1-d thin plate (bs=1): x, then |x - k_j|^3 over the knot span."""
    kf = [float(k) for k in np.asarray(knots, np.float32)]
    span = max(float(np.float32(kf[-1] - kf[0])), 1e-12)

    def basis(x):
        cols = [x] + [torch.abs((x - k) / span) ** 3 for k in kf]
        return torch.stack(cols, dim=-1)

    return basis


def bspline_cols(knots: np.ndarray, order: int):
    """Cox-de Boor B-splines of `order` (degree + 1) over the knots with
    clamped ends: fn(x) -> (n, n_basis). Outside the span x is clamped,
    so the basis extrapolates as a constant."""
    t = np.concatenate([[knots[0]] * (order - 1), knots,
                        [knots[-1]] * (order - 1)]).astype(np.float32)
    n_basis = len(t) - order
    tf = [float(v) for v in t]

    def basis(x):
        x = torch.clamp(x, tf[0], tf[-1])
        # order 1: half-open intervals, the last one closed so x equal
        # to the last knot lands in a basis function
        B = [((x >= tf[i]) & ((x < tf[i + 1])
                              | ((i + 1 == len(t) - order)
                                 & (x <= tf[i + 1])))).float()
             for i in range(len(t) - 1)]
        for k in range(2, order + 1):
            Bn = []
            for i in range(len(t) - k):
                d1 = float(t[i + k - 1] - t[i])
                d2 = float(t[i + k] - t[i + 1])
                term = 0.0
                if d1 > 0:
                    term = (x - tf[i]) / d1 * B[i]
                if d2 > 0:
                    term = term + (tf[i + k] - x) / d2 * B[i + 1]
                Bn.append(term if torch.is_tensor(term)
                          else torch.zeros_like(x))
            B = Bn
        return torch.stack(B[:n_basis], dim=-1)

    return basis


def mspline_basis(knots: np.ndarray, order: int = 3):
    """M-splines (bs=3): B-splines scaled to integrate to 1."""
    bs = bspline_cols(knots, order)
    t = np.concatenate([[knots[0]] * (order - 1), knots,
                        [knots[-1]] * (order - 1)]).astype(np.float64)
    norm = np.array([order / max(t[i + order] - t[i], 1e-12)
                     for i in range(len(t) - order)], np.float32)

    def basis(x):
        return bs(x) * torch.as_tensor(norm, device=x.device)[None, :]

    return basis


def ispline_basis(knots: np.ndarray, order: int = 3):
    """I-splines (bs=2): I_i(x) = sum_{j >= i} B_{j, order+1}(x), each
    monotone from 0 to 1; the first (constant 1) column is dropped, the
    intercept covers it."""
    bs = bspline_cols(knots, order + 1)

    def basis(x):
        B = torch.flip(bs(x), [1])
        return torch.flip(torch.cumsum(B, dim=-1), [1])[:, 1:]

    return basis


def nspline_basis(knots: np.ndarray):
    """Natural cubic splines (bs=0; ESL 5.2.1): x, N_1 .. N_{K-2}."""
    K = len(knots)
    kf = [float(k) for k in np.asarray(knots, np.float32)]

    def d(x, j):
        num = (torch.clamp_min(x - kf[j], 0.0) ** 3
               - torch.clamp_min(x - kf[K - 1], 0.0) ** 3)
        return num / max(float(np.float32(kf[K - 1] - kf[j])), 1e-12)

    def basis(x):
        cols = [x]
        dK2 = d(x, K - 2)
        for j in range(K - 2):
            cols.append(d(x, j) - dK2)
        return torch.stack(cols, dim=-1)

    return basis


class GAMModel(Model):
    algo_name = "gam"

    def __init__(self, parms=None):
        super().__init__(parms=parms)
        self.glm_model = None
        self.knots: Dict[str, np.ndarray] = {}
        # 0 cr (the default), 1 thin plate, 2 I-splines, 3 M-splines
        self.bs_types: Dict[str, int] = {}

    def _basis_for(self, gcol: str):
        b = self.bs_types.get(gcol, 0)
        k = self.knots[gcol]
        if b == 1:
            return thinplate_basis(k)
        if b == 2:
            return ispline_basis(k)
        if b == 3:
            return mspline_basis(k)
        return nspline_basis(k)

    def _expand_frame(self, frame: Frame) -> Frame:
        """The frame with each gam column's basis columns appended."""
        out = Frame()
        for nm in frame.names:
            out.add(nm, frame.col(nm))
        for gcol in self.knots:
            B = self._basis_for(gcol)(frame.col(gcol).data)
            for j in range(B.shape[1]):
                out.add(f"{gcol}_gam{j}",
                        Column(B[:, j].contiguous(), T_NUM, frame.nrows))
        return out

    def get_knot_locations(self, gam_column: Optional[str] = None):
        if gam_column is not None:
            return list(map(float, self.knots[gam_column]))
        return {c: list(map(float, k)) for c, k in self.knots.items()}

    def adapt_test(self, test: Frame) -> Frame:
        return self.glm_model.adapt_test(self._expand_frame(test))

    def _predict_raw(self, frame: Frame):
        return self.glm_model._predict_raw(frame)     # already adapted

    def _make_metrics(self, frame: Frame, raw, extra_weight=None):
        return self.glm_model._make_metrics(frame, raw, extra_weight)

    def coef(self):
        return self.glm_model.coef()


def _per_column(v, n: int, default) -> List:
    if v is None:
        return [default] * n
    if isinstance(v, (int, float)):
        return [v] * n
    return list(v)


@register
class GAM(ModelBuilder):
    algo_name = "gam"
    model_class = GAMModel

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "gam_columns": [],
            "num_knots": None,          # per gam column, default 6
            "bs": None,                 # basis type per column
            "scale": None,              # smoothness ridge per column
            "family": "AUTO",
            "alpha": 0.0,
            "lambda_": None,            # None: the ridge comes from scale
            "solver": "AUTO",
            "standardize": True,
        })
        return p

    def _fit(self, train: Frame) -> GAMModel:
        p = self.params
        gam_cols = list(p.get("gam_columns") or [])
        if not gam_cols:
            raise ValueError("gam requires gam_columns")
        n = len(gam_cols)
        # `is None`, not `or`: scale=0 turns the smoothing penalty off
        num_knots = _per_column(p.get("num_knots"), n, 6)
        scales = [float(s) for s in _per_column(p.get("scale"), n, 0.01)]
        bs = _per_column(p.get("bs"), n, 0)
        for nm_, lst in (("num_knots", num_knots), ("bs", bs),
                         ("scale", scales)):
            if len(lst) != n:
                raise ValueError(f"{nm_} has {len(lst)} entries for {n} "
                                 "gam_columns")
        model = GAMModel(parms=dict(p))
        for gcol, nk, b in zip(gam_cols, num_knots, bs):
            if gcol not in train:
                raise ValueError(f"gam column {gcol!r} not in frame")
            if int(b) not in (0, 1, 2, 3):
                raise ValueError(f"bs={b} unsupported (0=cr, 1=thin plate, "
                                 "2=monotone I-splines, 3=M-splines)")
            probs = np.linspace(0.02, 0.98, int(nk))
            qs = quantile_column(train.col(gcol), probs.tolist())
            knots = np.unique(np.asarray(qs, np.float64))
            if len(knots) < 3:
                raise ValueError(f"gam column {gcol!r} has too few distinct "
                                 "values")
            model.knots[gcol] = knots
            model.bs_types[gcol] = int(b)

        expanded = model._expand_frame(train)
        for gcol in gam_cols:         # the basis replaces the raw column
            expanded.drop(gcol)
        # one ridge for the whole GLM (the reference's approximation of
        # per-block penalties): lambda_ if given, else the mean scale
        lam = p.get("lambda_")
        ridge = float(lam) if lam is not None else float(np.mean(scales))
        # I-splines are monotone through non-negative coefficients
        glm = GLM(family=p.get("family", "AUTO"),
                  alpha=float(p.get("alpha", 0.0)), lambda_=ridge,
                  standardize=bool(p.get("standardize", True)),
                  non_negative=any(int(b) == 2 for b in bs),
                  seed=self._seed(),
                  weights_column=p.get("weights_column"))
        inner = glm.train(y=p["response_column"], training_frame=expanded)

        self._init_output(model, train)
        model._output.model_category = inner._output.model_category
        model._output.response_domain = inner._output.response_domain
        model.glm_model = inner
        model._output.variable_importances = \
            inner._output.variable_importances
        return model
