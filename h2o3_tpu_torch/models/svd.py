"""SVD: singular values and right vectors from the Gram of the
transformed design, and the left vectors as a frame (counterpart of
h2o3_tpu/models/svd.py: `SVDModel._predict_raw` :35, `_fit` :86, the
host eigh :109, the sign rule :120-123, `keep_u` :130).

The Gram XᵀX is summed in float64 on the frame's device (pca.gram).
GramSVD takes numpy's `eigh` of it on the host; Power and Randomized run
pca's subspace iteration on the device. d = √eigenvalues, V the
eigenvectors with the largest-|loading| entry of each positive, and
U = X V diag(1/d) is one device matmul, kept as a frame in the DKV.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_NUM
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register
from h2o3_tpu_torch.models.pca import (_subspace_iteration, fix_signs, gram,
                                       make_data_info, top_eigh)


class SVDModel(Model):
    algo_name = "svd"

    def __init__(self, parms=None, key=None):
        super().__init__(parms, key)
        self.d: Optional[np.ndarray] = None    # (nv,)
        self.v: Optional[np.ndarray] = None    # (p, nv)
        self.u_key: Optional[str] = None
        self.data_info: Optional[DataInfo] = None

    def _predict_raw(self, frame: Frame):
        di = self.data_info
        X = di.expand(*(c.data for c in di.cols(frame)))
        V = torch.as_tensor(self.v, dtype=torch.float32, device=X.device)
        dinv = torch.as_tensor(
            np.where(self.d > 0, 1.0 / np.maximum(self.d, 1e-30), 0.0),
            dtype=torch.float32, device=X.device)
        return {"scores": (X @ V) * dinv[None, :]}

    def predict(self, frame: Frame, key: Optional[str] = None) -> Frame:
        s = self._predict_raw(self.adapt_test(frame))["scores"]
        out = Frame(key=key)
        for j in range(s.shape[1]):
            out.add(f"u{j+1}", Column(s[:, j].contiguous(), T_NUM,
                                      frame.nrows))
        return out

    def _make_metrics(self, frame: Frame, raw, extra_weight=None):
        return None


@register
class SVD(ModelBuilder):
    algo_name = "svd"
    model_class = SVDModel
    supervised = False

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "nv": 1,
            "transform": "NONE",
            "svd_method": "GramSVD",    # GramSVD/Power/Randomized
            "use_all_factor_levels": True,
            "max_iterations": 1000,
            "keep_u": True,
            "u_name": None,
        })
        return p

    def _fit(self, train: Frame) -> SVDModel:
        p = self.params
        di = make_data_info(train, p)
        nv = min(int(p["nv"]), di.fullN)
        method = (p.get("svd_method") or "GramSVD").lower()
        G = gram(di, train)
        if method == "gramsvd":
            V, evals = top_eigh(G, nv)
        elif method in ("power", "randomized"):
            dev = train.col(di.predictor_names[0]).device
            V, evals = _subspace_iteration(
                torch.as_tensor(G, dtype=torch.float32, device=dev), nv,
                int(p.get("max_iterations", 1000)), self._seed())
        else:
            raise ValueError(f"unknown svd_method {method!r}")
        V = fix_signs(V)

        model = SVDModel(parms=dict(p))
        self._init_output(model, train)
        model._output.model_category = ModelCategory.DimReduction
        model.data_info = di
        model.d = np.sqrt(evals)
        model.v = np.asarray(V, np.float64)
        if p.get("keep_u", True):
            u = model.predict(train, key=p.get("u_name"))
            u.install()          # in the DKV, so u_key resolves
            model.u_key = str(u.key)
        return model
