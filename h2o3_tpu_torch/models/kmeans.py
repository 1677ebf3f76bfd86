"""KMeans: Lloyd iterations from Random, PlusPlus, Furthest or user
centers, and the estimate_k search (counterpart of
h2o3_tpu/models/kmeans.py: `KMeansModel._predict_raw` :40,
`_clustering_metrics` :64, `_fit` :114, `_estimate_k` :190,
`_destandardize` :211, `_dist2` :220, `_lloyd` :228, `_furthest_point`
:269, `_init_centers` :282).

The design matrix is the DataInfo expansion (one-hot with every level,
numerics optionally standardised) on the frame's device. A Lloyd step
is ‖x‖² − 2x·cᵀ + ‖c‖² in float32 (one matmul), an argmin, and the
center sums as a one-hot matmul (oh.T @ X); the float32 matmuls run in
full float32 (PyTorch's default keeps TF32 off for them). The loop runs
on the host: each step reads its within-cluster sum of squares back to
decide whether to go on, the reference's stopping rule (a relative
improvement above 1e-6, at least two steps, at most max_iterations).
The initial centers are drawn on the host with the reference's numpy
Generator calls in the reference's order, so both packages start from
the same rows.

Durable job progress (reference :105, :138-170): with
``H2O_TPU_JOB_CKPT_ITERS`` = k set, Lloyd runs in chunks of k steps,
saving the centers after each and stopping when a chunk improves the
within-cluster SS by no more than 1e-6 relative; a resumed train
continues from the saved centers. As for GLM, the chunk shape depends
on the knob alone.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.ops import segment_sum
from h2o3_tpu_torch.models import metrics as M
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register


def _dist2(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(n, k) squared distances, ‖x‖² − 2x·cᵀ + ‖c‖² in float32."""
    return ((X * X).sum(dim=1, keepdim=True) - 2.0 * (X @ centers.T)
            + (centers * centers).sum(dim=1)[None, :])


class KMeansModel(Model):
    algo_name = "kmeans"

    def __init__(self, parms=None, key=None):
        super().__init__(parms, key)
        self.centers: Optional[np.ndarray] = None       # (k, p) expanded space
        self.centers_raw: Optional[np.ndarray] = None   # (k, p) original scale
        self.data_info: Optional[DataInfo] = None
        self.k: int = 0

    def _predict_raw(self, frame: Frame):
        di = self.data_info
        X = di.expand(*(c.data for c in di.cols(frame)))
        C = torch.as_tensor(self.centers, dtype=torch.float32,
                            device=X.device)
        d2 = _dist2(X, C)
        dist2, cluster = torch.min(d2, dim=1)
        return {"cluster": cluster.int(), "dist2": dist2}

    def _make_metrics(self, frame: Frame, raw, extra_weight=None):
        return _clustering_metrics(self, frame, raw)


def _clustering_metrics(model: KMeansModel, frame: Frame, raw
                        ) -> M.ModelMetricsClustering:
    """Per-cluster within SS and sizes, the total SS about the mean."""
    di = model.data_info
    X = di.expand(*(c.data for c in di.cols(frame)))
    cl = raw["cluster"].long()
    withinss = segment_sum(cl, raw["dist2"], model.k).double()
    sizes = torch.bincount(cl, minlength=model.k).double()
    Xd = X.double()
    totss = float(((Xd - Xd.mean(dim=0))**2).sum())
    tot_within = float(withinss.sum())
    return M.ModelMetricsClustering(
        nobs=float(frame.nrows), tot_withinss=tot_within, totss=totss,
        betweenss=totss - tot_within,
        within_cluster_sizes=sizes.cpu().tolist())


@register
class KMeans(ModelBuilder):
    algo_name = "kmeans"
    model_class = KMeansModel
    supervised = False
    supports_iteration_resume = True

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "k": 1,
            "estimate_k": False,
            "max_iterations": 10,
            "init": "Furthest",         # Random/PlusPlus/Furthest/User
            "user_points": None,
            "standardize": True,
            "max_k": 100,               # the estimate_k search's cap
        })
        return p

    def _fit(self, train: Frame) -> KMeansModel:
        p = self.params
        di = DataInfo(train, response=None,
                      ignored=p.get("ignored_columns") or (),
                      standardize=bool(p.get("standardize", True)),
                      use_all_factor_levels=True)
        X = di.expand(*(c.data for c in di.cols(train)))
        seed = self._seed()
        max_iter = int(p.get("max_iterations", 10))
        every = self._job_ckpt_every()
        rs = self._take_resume_state("kmeans_lloyd")
        if p.get("estimate_k"):
            k, centers = self._estimate_k(X, seed, max_iter,
                                          int(p.get("max_k", 100)))
        else:
            centers = self._lloyd_chunked(X, di, seed, max_iter, every, rs)
            k = int(centers.shape[0])   # init='User' sets k by its rows

        model = KMeansModel(parms=dict(p))
        self._init_output(model, train)
        model._output.model_category = ModelCategory.Clustering
        model.data_info = di
        model.k = k
        model.centers = centers.cpu().numpy()
        model.centers_raw = _destandardize(model.centers, di)
        model._parms["k"] = k
        return model

    def _lloyd_chunked(self, X, di, seed: int, max_iter: int, every: int,
                       rs: Optional[dict]) -> torch.Tensor:
        """Lloyd in chunks of `every` steps (all of max_iter without the
        knob) from the initial or the saved centers, saving the centers
        after each chunk; the reference's relative-improvement stop at
        chunk granularity."""
        p = self.params
        if rs is not None:
            centers = torch.from_numpy(np.array(rs["centers"])).to(X.device)
            it_done, prev_wss = int(rs["iters_done"]), rs.get("wss")
        else:
            centers = _init_centers(X, int(p["k"]), p.get("init", "Furthest"),
                                    seed, di, p.get("user_points"))
            it_done, prev_wss = 0, None
        chunk = every if every > 0 else max_iter
        while it_done < max_iter:
            step = min(chunk, max_iter - it_done)
            centers, wss = _lloyd(X, centers, step)
            it_done += step
            wss = float(wss)
            self._tick_job_progress(it_done, lambda: {
                "phase": "kmeans_lloyd", "centers": centers.cpu().numpy(),
                "iters_done": it_done, "wss": wss})
            if prev_wss is not None and \
                    (prev_wss - wss) <= 1e-6 * max(prev_wss, 1e-12):
                break
            prev_wss = wss
            if self._out_of_time():
                break
        return centers

    def _estimate_k(self, X: torch.Tensor, seed: int, max_iter: int,
                    max_k: int):
        """Grow k while each added center (seeded Furthest) cuts the
        within-cluster SS by at least 20%."""
        centers = _init_centers(X, 1, "Furthest", seed, None, None)
        centers, wss = _lloyd(X, centers, max_iter)
        best_k, best_c = 1, centers
        prev = float(wss)
        for k in range(2, max_k + 1):
            nxt = _furthest_point(X, centers)
            centers = torch.cat([centers, nxt[None, :]], dim=0)
            centers, wss = _lloyd(X, centers, max_iter)
            cur = float(wss)
            if prev > 0 and (prev - cur) / prev < 0.2:
                break
            best_k, best_c = k, centers
            prev = cur
        return best_k, best_c


def _destandardize(centers: np.ndarray, di: DataInfo) -> np.ndarray:
    out = centers.copy()
    if di.num_names and di.standardize:
        no = di.num_offset
        out[:, no:] = (out[:, no:] * di.num_sigmas[None, :]
                       + di.num_means[None, :])
    return out


def _lloyd(X: torch.Tensor, centers: torch.Tensor, max_iter: int):
    """Lloyd steps from `centers` -> (centers, the last step's
    within-cluster SS as a float32 scalar). A step's SS is that of the
    centers it starts from; the loop stops after max_iter steps, or once
    two steps in a row improve the SS by no more than 1e-6 relative."""
    k = centers.shape[0]
    inf = np.float32(np.inf)
    wss, prev, i = inf, inf, 0
    while i < max_iter and (i < 2 or (prev - wss)
                            > np.float32(1e-6) * max(prev, np.float32(1e-12))):
        d2 = _dist2(X, centers)
        dmin, assign = torch.min(d2, dim=1)
        oh = torch.nn.functional.one_hot(assign, k).float()
        sums = oh.T @ X
        counts = oh.sum(dim=0)
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp_min(counts[:, None], 1.0),
                              centers)
        prev, wss = wss, np.float32(torch.clamp_min(dmin, 0.0).sum().item())
        i += 1
    return centers, wss


def _furthest_point(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The row furthest from its closest center."""
    return X[torch.argmax(torch.min(_dist2(X, centers), dim=1).values)]


def _init_centers(X: torch.Tensor, k: int, method: str, seed: int,
                  di: Optional[DataInfo], user_points) -> torch.Tensor:
    """The k initial centers: the user's points (standardised as the
    design), k distinct random rows, or one random row and then, k - 1
    times, the row furthest from its closest center (Furthest) or a row
    drawn with chance proportional to that squared distance (PlusPlus)."""
    method = (method or "Furthest").lower()
    n = X.shape[0]
    rng = np.random.default_rng(seed)
    if method == "user":
        if user_points is None:
            raise ValueError("init='User' requires user_points")
        pts = (user_points.to_numpy().astype(np.float32)
               if isinstance(user_points, Frame)
               else np.asarray(user_points, np.float32))
        if di is not None and di.num_names and di.standardize:
            no = di.num_offset
            pts = pts.copy()
            pts[:, no:] = ((pts[:, no:] - di.num_means[None, :])
                           / di.num_sigmas[None, :])
        return torch.as_tensor(pts, dtype=torch.float32, device=X.device)
    if method == "random":
        idx = rng.choice(n, size=min(k, n), replace=False)
        return X[torch.as_tensor(idx, device=X.device)]
    first = int(rng.integers(n))
    centers = X[first][None, :]
    for _ in range(1, k):
        d = torch.clamp_min(torch.min(_dist2(X, centers), dim=1).values, 0.0)
        if method == "plusplus":
            probs = d.cpu().numpy().astype(np.float64)
            s = probs.sum()
            idx = (int(rng.integers(n)) if s <= 0
                   else int(rng.choice(len(probs), p=probs / s)))
            nxt = X[idx]
        else:  # furthest
            nxt = X[torch.argmax(d)]
        centers = torch.cat([centers, nxt[None, :]], dim=0)
    return centers
