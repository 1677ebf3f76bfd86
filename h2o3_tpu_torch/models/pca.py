"""PCA: principal components of the Gram of the transformed design
(counterpart of h2o3_tpu/models/pca.py: `make_data_info` :29,
`PCAModel._predict_raw` :73, `_fit` :124, GramSVD :148-155, the sign
rule :162-166, `_subspace_iteration` :185).

The design is the DataInfo expansion under the `transform` parameter
(NONE, STANDARDIZE, NORMALIZE, DEMEAN, DESCALE). Its Gram XᵀX is summed
in float64 on the frame's device and brought to the host. GramSVD takes
numpy's `eigh` of it; Power and Randomized run subspace iteration on the
device: Q ← qr(G Q) until no entry of |Q| moves by more than 1e-7, then
the Rayleigh quotients are the eigenvalues. Each component's sign makes
its largest-magnitude loading positive. Scoring projects the design on
the eigenvectors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_NUM
from h2o3_tpu_torch.core.ops import fixed_point_segment_sum
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register

TRANSFORMS = ("NONE", "STANDARDIZE", "NORMALIZE", "DEMEAN", "DESCALE")


def make_data_info(train: Frame, params: dict, *, response=None) -> DataInfo:
    """A DataInfo whose expansion applies the PCA/SVD/GLRM `transform`;
    NAs are filled with the raw column mean in every mode."""
    t = (params.get("transform") or "NONE").upper()
    if t not in TRANSFORMS:
        raise ValueError(f"unknown transform {t!r}")
    di = DataInfo(train, response=response,
                  ignored=params.get("ignored_columns") or (),
                  standardize=(t == "STANDARDIZE"),
                  use_all_factor_levels=bool(
                      params.get("use_all_factor_levels", False)))
    if t == "NONE":
        di.num_means = np.zeros_like(di.num_means)
        di.num_sigmas = np.ones_like(di.num_sigmas)
        di.standardize = True  # (x - 0) / 1
    elif t == "DEMEAN":
        di.num_sigmas = np.ones_like(di.num_sigmas)
        di.standardize = True
    elif t == "DESCALE":
        di.num_means = np.zeros_like(di.num_means)
        di.standardize = True
    elif t == "NORMALIZE":
        # (x - mean) / (max - min), the means (and the NA fill) summed
        # order-free, so the design is the same on every device
        spans, means = [], []
        for n in di.num_names:
            c = train.col(n)
            spans.append((c.rollups.max - c.rollups.min) or 1.0)
            means.append(_exact_mean(c.data))
        di.num_sigmas = np.asarray(spans, np.float32)
        di.num_means = np.asarray(means, np.float32)
        di.impute_values = di.num_means.copy()
        di.standardize = True
    return di


def _exact_mean(x: torch.Tensor) -> float:
    """The mean of the non-NaN values of `x`: their float32 sum rounded
    once from the exact sum (core/ops.fixed_point_segment_sum), over the
    count in float64, as the rollups finish a mean."""
    v = x[~torch.isnan(x)].float()
    if not v.numel():
        return float("nan")
    idx = torch.zeros(v.numel(), dtype=torch.int64, device=v.device)
    return float(fixed_point_segment_sum(idx, v, 1)[0]) / v.numel()


def gram(di: DataInfo, frame: Frame) -> np.ndarray:
    """XᵀX of the expanded design, summed in float64 on the frame's
    device, as a host array."""
    X = di.expand(*(c.data for c in di.cols(frame))).double()
    return (X.T @ X).cpu().numpy()


def top_eigh(G: np.ndarray, k: int):
    """The k largest eigenpairs of the symmetric G (numpy's eigh),
    eigenvalues clipped at 0."""
    evals, evecs = np.linalg.eigh(G)
    order = np.argsort(evals)[::-1][:k]
    return evecs[:, order], np.maximum(evals[order], 0.0)


def fix_signs(V: np.ndarray) -> np.ndarray:
    """Each column's largest-|loading| entry made positive."""
    for j in range(V.shape[1]):
        i = int(np.argmax(np.abs(V[:, j])))
        if V[i, j] < 0:
            V[:, j] = -V[:, j]
    return V


def _subspace_iteration(G: torch.Tensor, k: int, max_iter: int, seed: int):
    """Subspace iteration on the (p, p) float32 Gram on its device:
    Q ← qr(G Q) from a seeded normal start until max | |Q'| - |Q| | is at
    most 1e-7 or max_iter steps. -> (V (p, k) float64, eigenvalues
    (k,)), by decreasing eigenvalue."""
    p = G.shape[0]
    rng = np.random.default_rng(seed)
    Q = torch.as_tensor(rng.standard_normal((p, k)), dtype=torch.float32,
                        device=G.device)
    for _ in range(max_iter):
        Qn, _ = torch.linalg.qr(G @ Q)
        delta = float(torch.max(torch.abs(torch.abs(Qn) - torch.abs(Q))))
        Q = Qn
        if not delta > 1e-7:
            break
    evals = torch.diagonal(Q.T @ G @ Q)
    V = Q.cpu().numpy().astype(np.float64)
    ev = np.maximum(evals.cpu().numpy().astype(np.float64), 0.0)
    order = np.argsort(ev)[::-1]
    return V[:, order], ev[order]


class PCAModel(Model):
    algo_name = "pca"

    def __init__(self, parms=None, key=None):
        super().__init__(parms, key)
        self.eigenvectors: Optional[np.ndarray] = None  # (p, k)
        self.std_deviation: Optional[np.ndarray] = None  # (k,)
        self.prop_var: Optional[np.ndarray] = None
        self.cum_var: Optional[np.ndarray] = None
        self.data_info: Optional[DataInfo] = None
        self.k: int = 0

    def _predict_raw(self, frame: Frame):
        di = self.data_info
        X = di.expand(*(c.data for c in di.cols(frame)))
        V = torch.as_tensor(self.eigenvectors, dtype=torch.float32,
                            device=X.device)
        return {"scores": X @ V}

    def predict(self, frame: Frame, key: Optional[str] = None) -> Frame:
        s = self._predict_raw(self.adapt_test(frame))["scores"]
        out = Frame(key=key)
        for j in range(self.k):
            out.add(f"PC{j+1}", Column(s[:, j].contiguous(), T_NUM,
                                       frame.nrows))
        return out

    transform = predict

    def _make_metrics(self, frame: Frame, raw, extra_weight=None):
        return None


@register
class PCA(ModelBuilder):
    algo_name = "pca"
    model_class = PCAModel
    supervised = False

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "k": 1,
            "transform": "NONE",
            "pca_method": "GramSVD",     # GramSVD/Power/Randomized/GLRM
            "use_all_factor_levels": False,
            "max_iterations": 1000,
        })
        return p

    def _fit(self, train: Frame) -> PCAModel:
        p = self.params
        di = make_data_info(train, p)
        k = min(int(p["k"]), di.fullN)
        n = train.nrows
        method = (p.get("pca_method") or "GramSVD").lower()
        # the centering and scaling come from `transform` alone: NONE is
        # the uncentered Gram
        G = gram(di, train) / max(n - 1, 1)
        if method in ("gramsvd", "glrm"):
            V, evals = top_eigh(G, k)
        elif method in ("power", "randomized"):
            dev = train.col(di.predictor_names[0]).device
            V, evals = _subspace_iteration(
                torch.as_tensor(G, dtype=torch.float32, device=dev), k,
                int(p.get("max_iterations", 1000)), self._seed())
        else:
            raise ValueError(f"unknown pca_method {method!r}")
        V = fix_signs(V)

        model = PCAModel(parms=dict(p))
        self._init_output(model, train)
        model._output.model_category = ModelCategory.DimReduction
        model.data_info = di
        model.k = k
        model.eigenvectors = np.asarray(V, np.float64)
        sd = np.sqrt(evals)
        model.std_deviation = sd
        total_var = float(np.trace(G))
        model.prop_var = (sd ** 2) / total_var if total_var > 0 else sd * 0
        model.cum_var = np.cumsum(model.prop_var)
        model._output.variable_importances = {
            f"PC{j+1}": float(model.prop_var[j]) for j in range(k)}
        return model
