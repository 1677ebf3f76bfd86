"""GLRM: generalized low-rank models by alternating proximal gradient
(counterpart of h2o3_tpu/models/glrm.py: `_loss_grad` :36,
`_composite_loss` :80, `_prox` :148, `GLRMModel.predict` :199,
`_solve_x` :225, `_fit` :286, the SVD init :310-319, the alternating
loop :325-360).

A ≈ X Y with X (n, k) row weights and Y (k, p) archetypes over the
transformed design (pca.make_data_info, every factor level one-hot).
Each numeric column takes `loss` (or its `loss_by_col` override), each
one-hot block `multi_loss`; X and Y have their regularizers' proximal
operators. Y starts from the top-k eigenvectors of the design's Gram
(float64 on the device, numpy's `eigh` on the host) scaled by the root
eigenvalues, X from seeded normal draws (numpy, the reference's order).
A step updates X, then Y, on the device and reads the new objective back:
better, and the step grows 5%; worse, and the step halves and the update
is undone. The loop ends at max_iterations, at min_step_size, or after
30 steps in a row without improvement. Scoring solves for X on the new
rows with Y fixed (30 proximal steps) and returns X Y.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT, T_NUM
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register
from h2o3_tpu_torch.models.pca import gram, make_data_info, top_eigh

LOSSES = ("quadratic", "absolute", "huber", "poisson", "logistic", "hinge",
          "periodic")
MULTI_LOSSES = ("categorical", "ordinal")
REGULARIZERS = ("none", "quadratic", "l1", "nonnegative", "onesparse",
                "unitonesparse", "simplex")


def _loss_grad(name: str, period: float = 1.0):
    """(loss(a, u), dloss/du(a, u)) elementwise, a the data and u the
    approximation X Y."""
    if name == "quadratic":
        return (lambda a, u: (a - u) ** 2,
                lambda a, u: 2.0 * (u - a))
    if name == "absolute":
        return (lambda a, u: torch.abs(a - u),
                lambda a, u: torch.sign(u - a))
    if name == "huber":
        return (lambda a, u: torch.where(torch.abs(a - u) <= 1.0,
                                         0.5 * (a - u) ** 2,
                                         torch.abs(a - u) - 0.5),
                lambda a, u: torch.clamp(u - a, -1.0, 1.0))
    if name == "poisson":
        return (lambda a, u: torch.exp(u) - a * u,
                lambda a, u: torch.exp(u) - a)
    if name == "logistic":   # a in {0, 1} as a ±1 margin
        return (lambda a, u: torch.log1p(torch.exp(-(2 * a - 1) * u)),
                lambda a, u: -(2 * a - 1) * torch.sigmoid(-(2 * a - 1) * u))
    if name == "hinge":
        return (lambda a, u: torch.clamp_min(1.0 - (2 * a - 1) * u, 0.0),
                lambda a, u: torch.where((2 * a - 1) * u < 1.0,
                                         -(2 * a - 1), 0.0))
    if name == "periodic":
        # 1 - cos((a - u)·2π/T)
        w = 2.0 * math.pi / max(float(period), 1e-12)
        return (lambda a, u: 1.0 - torch.cos((a - u) * w),
                lambda a, u: -w * torch.sin((a - u) * w))
    if name == "categorical":
        # over a one-hot block: max(1 - u, 0)² at the level, max(1 + u,
        # 0)² elsewhere
        return (lambda a, u: torch.clamp_min(1.0 - (2 * a - 1) * u, 0.0) ** 2,
                lambda a, u: -2.0 * (2 * a - 1)
                * torch.clamp_min(1.0 - (2 * a - 1) * u, 0.0))
    raise ValueError(f"unknown loss {name!r}")


def _composite_loss(di: DataInfo, p: dict, pdim: int, device,
                    frame_names=None):
    """(loss(A, U), dloss(A, U)): per expanded column, `loss` for a
    numeric column (or its loss_by_col entry; loss_by_col_idx indexes
    the training frame's columns), `multi_loss` for a one-hot block,
    each term masked to its columns."""
    default = (p.get("loss") or "Quadratic").lower()
    if default not in LOSSES:
        raise ValueError(f"unknown loss {p['loss']!r}")
    multi = (p.get("multi_loss") or "Categorical").lower()
    if multi not in MULTI_LOSSES:
        raise ValueError(f"unknown multi_loss {p['multi_loss']!r}")
    if multi == "ordinal":
        raise NotImplementedError(
            "multi_loss='Ordinal' is not implemented; use 'Categorical'")
    by_col = [str(x).lower() for x in (p.get("loss_by_col") or [])]
    by_idx = [int(i) for i in (p.get("loss_by_col_idx") or [])]
    if by_col and not by_idx:
        by_idx = list(range(len(by_col)))
    if len(by_col) != len(by_idx):
        raise ValueError("loss_by_col and loss_by_col_idx length mismatch")
    overrides_frame = dict(zip(by_idx, by_col))
    for nm in overrides_frame.values():
        if nm not in LOSSES and nm not in MULTI_LOSSES:
            raise ValueError(f"unknown loss_by_col entry {nm!r}")
    overrides = {}
    if overrides_frame:
        names = list(frame_names or (di.cat_names + di.num_names))
        for idx, nm in overrides_frame.items():
            if idx >= len(names):
                raise ValueError(f"loss_by_col_idx {idx} out of range")
            overrides[names[idx]] = nm
    # the expansion's layout: the one-hot blocks, then the numerics
    col_loss = []
    for i, cn in enumerate(di.cat_names):
        col_loss.extend([overrides.get(cn, multi)] * int(di.cards[i]))
    for nn in di.num_names:
        col_loss.append(overrides.get(nn, default))
    if len(col_loss) != pdim:
        raise AssertionError((len(col_loss), pdim))
    groups = {}
    for ci, nm in enumerate(col_loss):
        groups.setdefault(nm, []).append(ci)
    period = float(p.get("period") or 1.0)
    terms = []
    for nm, cols in groups.items():
        mask = torch.zeros((1, pdim), dtype=torch.float32, device=device)
        mask[0, cols] = 1.0
        terms.append((mask, *_loss_grad(nm, period=period)))

    def loss(A, U):
        return sum(m * f(A, U) for m, f, _ in terms)

    def dloss(A, U):
        return sum(m * g(A, U) for m, _, g in terms)

    return loss, dloss


def _prox(name: str, gamma: float):
    """The regularizer's proximal operator prox(v, step)."""
    name = name.lower()
    if name == "none":
        return lambda v, step: v
    if name == "quadratic":
        return lambda v, step: v / (1.0 + 2.0 * gamma * step)
    if name == "l1":
        return lambda v, step: torch.sign(v) * torch.clamp_min(
            torch.abs(v) - gamma * step, 0.0)
    if name == "nonnegative":
        return lambda v, step: torch.clamp_min(v, 0.0)

    def _top(v):
        keep = torch.argmax(torch.abs(v), dim=-1, keepdim=True)
        return torch.arange(v.shape[-1], device=v.device)[None, :] == keep

    if name == "onesparse":
        return lambda v, step: torch.where(_top(v), torch.clamp_min(v, 0.0),
                                           0.0)
    if name == "unitonesparse":
        return lambda v, step: _top(v).to(v.dtype)
    if name == "simplex":
        def simplex(v, step):
            # Euclidean projection onto the probability simplex
            u = torch.sort(v, dim=-1, descending=True).values
            css = torch.cumsum(u, dim=-1) - 1.0
            ind = torch.arange(1, v.shape[-1] + 1, dtype=v.dtype,
                               device=v.device)
            rho = torch.sum(u - css / ind > 0, dim=-1, keepdim=True)
            theta = torch.take_along_dim(css, rho - 1, dim=-1) / rho.to(
                v.dtype)
            return torch.clamp_min(v - theta, 0.0)
        return simplex
    raise ValueError(f"unknown regularizer {name!r}")


class GLRMModel(Model):
    algo_name = "glrm"

    def __init__(self, parms=None, key=None):
        super().__init__(parms, key)
        self.archetypes: Optional[np.ndarray] = None    # Y (k, p)
        self.x_key: Optional[str] = None                # X frame in the DKV
        self.data_info: Optional[DataInfo] = None
        self.objective: float = float("nan")
        self.iterations: int = 0
        self.k: int = 0

    def _predict_raw(self, frame: Frame):
        """The reconstruction X Y, X solved on the frame with Y fixed."""
        X = _solve_x(self, frame)
        Y = torch.as_tensor(self.archetypes, dtype=torch.float32,
                            device=X.device)
        return {"reconstruction": X @ Y}

    def predict(self, frame: Frame, key: Optional[str] = None) -> Frame:
        recon = self._predict_raw(self.adapt_test(frame))["reconstruction"]
        di = self.data_info
        out = Frame(key=key)
        no = di.num_offset
        for j, nname in enumerate(di.num_names):
            col = recon[:, no + j]
            if di.standardize:
                col = col * float(di.num_sigmas[j]) + float(di.num_means[j])
            out.add(f"reconstr_{nname}", Column(col.contiguous(), T_NUM,
                                                frame.nrows))
        for i, cname in enumerate(di.cat_names):
            s, e = int(di.cat_offsets[i]), int(di.cat_offsets[i + 1])
            codes = torch.argmax(recon[:, s:e], dim=-1).int()
            out.add(f"reconstr_{cname}",
                    Column(codes, T_CAT, frame.nrows,
                           domain=di.domains[cname]))
        return out

    def _make_metrics(self, frame: Frame, raw, extra_weight=None):
        return None


def _solve_x(model: GLRMModel, frame: Frame) -> torch.Tensor:
    """X for new rows with Y fixed: 30 proximal gradient steps from 0 at
    step 1/(‖Y‖² + 1e-6)."""
    di = model.data_info
    A = di.expand(*(c.data for c in di.cols(frame)))
    Y = torch.as_tensor(model.archetypes, dtype=torch.float32,
                        device=A.device)
    p = model._parms
    _, dloss = _composite_loss(di, p, int(Y.shape[1]), A.device,
                               frame_names=model._output.names)
    prox_x = _prox(p.get("regularization_x", "None"),
                   float(p.get("gamma_x", 0.0)))
    X = torch.zeros((A.shape[0], Y.shape[0]), dtype=torch.float32,
                    device=A.device)
    step = float(1.0 / (torch.linalg.norm(Y) ** 2 + 1e-6))
    for _ in range(30):
        X = prox_x(X - step * (dloss(A, X @ Y) @ Y.T), step)
    return X


@register
class GLRM(ModelBuilder):
    algo_name = "glrm"
    model_class = GLRMModel
    supervised = False

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "k": 1,
            "loss": "Quadratic",
            "multi_loss": "Categorical",
            "loss_by_col": None,
            "loss_by_col_idx": None,
            "period": 1,
            "regularization_x": "None",
            "regularization_y": "None",
            "gamma_x": 0.0, "gamma_y": 0.0,
            "transform": "NONE",
            "max_iterations": 1000,
            "init_step_size": 1.0,
            "min_step_size": 1e-4,
            "init": "SVD",              # SVD/Random/PlusPlus
            "recover_svd": False,
        })
        return p

    def _fit(self, train: Frame) -> GLRMModel:
        p = self.params
        di = make_data_info(train, p)
        di.set_use_all_factor_levels(True)
        k = int(p["k"])
        n = train.nrows
        prox_x = _prox(p.get("regularization_x", "None"),
                       float(p.get("gamma_x", 0.0)))
        prox_y = _prox(p.get("regularization_y", "None"),
                       float(p.get("gamma_y", 0.0)))
        max_iter = int(p.get("max_iterations", 1000))
        min_step = float(p.get("min_step_size", 1e-4))
        A = di.expand(*(c.data for c in di.cols(train)))
        pdim = A.shape[1]
        dev = A.device
        loss, dloss = _composite_loss(di, p, pdim, dev,
                                      frame_names=train.names)

        rng = np.random.default_rng(self._seed())
        if (p.get("init") or "SVD").lower() == "svd":
            V, ev = top_eigh(gram(di, train), k)
            Y0 = (V * np.sqrt(np.maximum(ev, 1e-6))).T
            if Y0.shape[0] < k:
                Y0 = np.vstack([Y0, rng.normal(0, 0.01,
                                               (k - Y0.shape[0], pdim))])
        else:
            Y0 = rng.normal(0, 0.1, (k, pdim))
        Y = torch.as_tensor(Y0, dtype=torch.float32, device=dev)
        X = torch.as_tensor(rng.normal(0, 0.1, (n, k)), dtype=torch.float32,
                            device=dev)

        obj = np.float32(torch.sum(loss(A, X @ Y)).item())
        step = np.float32(np.float32(float(p.get("init_step_size", 1.0)))
                          / np.float32(max(float(torch.linalg.norm(Y)),
                                           1.0)) ** 2)
        i = stall = 0
        while i < max_iter and step > min_step and stall < 30:
            s = float(step)
            GX = dloss(A, X @ Y) @ Y.T
            Xn = prox_x(X - s * GX, s)
            GY = Xn.T @ dloss(A, Xn @ Y)
            Yn = prox_y(Y - s * GY, s)
            new_obj = np.float32(torch.sum(loss(A, Xn @ Yn)).item())
            if new_obj < obj:
                # better: keep it and grow the step 5%
                X, Y, obj = Xn, Yn, new_obj
                step, stall = np.float32(step * np.float32(1.05)), 0
            else:
                # worse: undo it and halve the step
                step, stall = np.float32(step * np.float32(0.5)), stall + 1
            i += 1

        model = GLRMModel(parms=dict(p))
        self._init_output(model, train)
        model._output.model_category = ModelCategory.DimReduction
        model.data_info = di
        model.k = k
        model.archetypes = Y.cpu().numpy().astype(np.float64)
        model.objective = float(obj)
        model.iterations = i
        model._output.scoring_history = [
            {"iterations": i, "objective": float(obj)}]
        xf = Frame()
        for j in range(k):
            xf.add(f"Arch{j+1}", Column(X[:, j].contiguous(), T_NUM, n))
        xf.install()
        model.x_key = str(xf.key)
        return model
