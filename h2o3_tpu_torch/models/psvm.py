"""PSVM: a Gaussian-kernel SVM on an incomplete Cholesky factor of the
kernel (counterpart of h2o3_tpu/models/psvm.py: `PSVMModel._features`
:49, `_predict_raw` :60, `_fit` :97, the primal BFGS fit :125-146, the
support-vector counts and dual coefficients :155-174, `_icf` :179).

The host factors the RBF kernel of the standardised design, K ≈ H Hᵀ,
by greedy max-residual pivoting (`_icf`, numpy, rank √n + 1 by default,
at most 512). The SVM is then fitted in the primal on H's columns,
squared hinge loss plus L2, by the port's BFGS (optim/bfgs.py, jax's
algorithm) with the rows on the device. New rows map to H's space
through their kernel against the pivot rows and the inverse of the
pivots' factor; P(class 1) is sigmoid(2 f).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register
from h2o3_tpu_torch.optim import bfgs


class PSVMModel(Model):
    algo_name = "psvm"

    def __init__(self, parms=None, key=None):
        super().__init__(parms, key)
        self.pivots: Optional[np.ndarray] = None    # (r, d) pivot rows
        self.icf_L: Optional[np.ndarray] = None     # (r, r) map to H's space
        self.beta: Optional[np.ndarray] = None      # (r + 1,) weights, bias
        self.gamma: float = 1.0
        self.data_info: Optional[DataInfo] = None
        self.svs_count: int = 0        # support vectors (margin active)
        self.bsv_count: int = 0        # bounded ones (margin violators)
        self.rho: float = 0.0          # f(x) = w·φ(x) − rho
        self.alpha_key: Optional[str] = None   # per-row dual coefficients

    def _features(self, X: torch.Tensor) -> torch.Tensor:
        """H's columns for new rows: k(x, pivots) through the map."""
        P = torch.as_tensor(self.pivots, dtype=torch.float32,
                            device=X.device)
        Linv = torch.as_tensor(self.icf_L, dtype=torch.float32,
                               device=X.device)
        d2 = ((X * X).sum(dim=1, keepdim=True) - 2 * (X @ P.T)
              + (P * P).sum(dim=1)[None, :])
        return torch.exp(-self.gamma * torch.clamp_min(d2, 0.0)) @ Linv

    def _predict_raw(self, frame: Frame):
        di = self.data_info
        H = self._features(di.expand(*(c.data for c in di.cols(frame))))
        beta = torch.as_tensor(self.beta, dtype=torch.float32,
                               device=H.device)
        f = H @ beta[:-1] + beta[-1]
        p = torch.sigmoid(2.0 * f)
        return {"probs": torch.stack([1 - p, p], dim=-1), "decision": f}


def svm_loss(Hd: torch.Tensor, yd: torch.Tensor, wd: torch.Tensor,
             C: float):
    """The primal objective of weights and bias b: ½‖w‖² + C Σ w_i
    max(0, 1 - y_i f_i)², f = H w + bias."""
    def loss(b):
        f = Hd @ b[:-1] + b[-1]
        margin = torch.clamp_min(1.0 - yd * f, 0.0)
        return 0.5 * torch.sum(b[:-1] ** 2) + C * torch.sum(wd * margin
                                                           * margin)
    return loss


@register
class PSVM(ModelBuilder):
    algo_name = "psvm"
    model_class = PSVMModel

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "hyper_param": 1.0,         # C
            "kernel_type": "gaussian",
            "gamma": -1.0,              # -1: 1 / #features
            "rank_ratio": -1.0,         # ICF rank fraction; -1: √n
            "positive_weight": 1.0,
            "negative_weight": 1.0,
            "sv_threshold": 1e-4,
            "max_iterations": 200,
        })
        return p

    def _fit(self, train: Frame) -> PSVMModel:
        p = self.params
        resp = p["response_column"]
        y_col = train.col(resp)
        if not y_col.is_categorical or y_col.cardinality != 2:
            raise ValueError("psvm requires a binary categorical response")
        di = DataInfo(train, response=resp,
                      ignored=p.get("ignored_columns") or (),
                      standardize=True, use_all_factor_levels=False)
        n = train.nrows
        Xd = di.expand(*(c.data for c in di.cols(train)))
        dev = Xd.device
        X = Xd.cpu().numpy().astype(np.float32)
        y01 = y_col.to_numpy()
        yv = np.where(y01 > 0, 1.0, -1.0).astype(np.float32)
        w = np.where(yv > 0, float(p.get("positive_weight", 1.0)),
                     float(p.get("negative_weight", 1.0))).astype(np.float32)
        w[y01 < 0] = 0.0       # NA responses drop out
        gamma = float(p.get("gamma", -1.0))
        if gamma <= 0:
            gamma = 1.0 / max(di.fullN, 1)
        rr = float(p.get("rank_ratio", -1.0))
        r = int(rr * n) if rr > 0 else int(np.sqrt(n)) + 1
        r = max(min(r, n, 512), 1)
        pivots_idx, H, L = _icf(X, gamma, r)

        C = float(p.get("hyper_param", 1.0))
        loss = svm_loss(torch.as_tensor(H, device=dev),
                        torch.as_tensor(yv, device=dev),
                        torch.as_tensor(w, device=dev), C)
        # the squared hinge is C¹, so BFGS converges on the r + 1 primal
        # variables
        res = bfgs.minimize(
            bfgs.value_and_grad(loss),
            torch.zeros(H.shape[1] + 1, dtype=torch.float32, device=dev),
            maxiter=int(p.get("max_iterations", 200)) * 10)
        beta = res.x.cpu().numpy()

        model = PSVMModel(parms=dict(p))
        self._init_output(model, train)
        model.data_info = di
        model.gamma = gamma
        model.pivots = X[pivots_idx]
        model.icf_L = L
        model.beta = beta
        model._output.scoring_history = [{"iterations": res.nit,
                                          "objective": res.fun}]
        f = H @ beta[:-1] + beta[-1]
        # for the squared-hinge primal the dual coefficients follow from
        # stationarity, α_i = 2 C w_i max(0, 1 − y_i f_i): rows with
        # slack are support vectors, those with y f < 0 bounded ones
        thr = float(p.get("sv_threshold", 1e-4))
        slack = 1.0 - yv * f
        model.svs_count = int(np.sum(slack > thr))
        model.bsv_count = int(np.sum(slack > 1.0))
        model.rho = float(-beta[-1])
        alpha = 2.0 * C * w * np.maximum(slack, 0.0) * yv
        af = Frame()
        af.add("alpha", Column.from_numpy(alpha.astype(np.float64),
                                          device=dev))
        af.install()
        model.alpha_key = str(af.key)
        return model


def _icf(X: np.ndarray, gamma: float, r: int):
    """Incomplete Cholesky of the RBF kernel by greedy max-residual
    pivoting -> (pivot rows, H (n, r) with K ≈ H Hᵀ, the (r, r) map of
    new rows' pivot kernels into H's space)."""
    n = X.shape[0]
    diag = np.ones(n, np.float64)           # k(x, x) = 1
    H = np.zeros((n, r), np.float64)
    pivots = []
    for j in range(r):
        i = int(np.argmax(diag))
        if diag[i] < 1e-10:
            H = H[:, :j]
            break
        pivots.append(i)
        d2 = ((X - X[i]) ** 2).sum(axis=1)
        k_col = np.exp(-gamma * d2)
        h = (k_col - H[:, :j] @ H[i, :j]) / np.sqrt(diag[i])
        H[:, j] = h
        diag = np.maximum(diag - h * h, 0.0)
    piv = np.asarray(pivots)
    # H's pivot rows are lower-triangular: new rows map through their
    # inverse
    Lp = H[piv][:, :len(piv)]
    Linv = np.linalg.inv(Lp + 1e-10 * np.eye(len(piv)))
    return piv, H.astype(np.float32), Linv.T.astype(np.float32)
