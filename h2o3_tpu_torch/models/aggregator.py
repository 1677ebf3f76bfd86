"""Aggregator: exemplar-based compression of a frame (counterpart of
h2o3_tpu/models/aggregator.py: `AggregatorModel._predict_raw` :41,
`_fit` :83, the radius search :104-111, `_radius_pass` :130).

One pass streams the transformed design (pca.make_data_info, every
factor level one-hot, NORMALIZE by default) in batches of 4096 rows: the
batch's nearest exemplars so far are one device matmul and argmin (only
the argmin and its distance come to the host), a row within the radius
joins its nearest exemplar, and the rows outside every radius are
admitted on the host in order, each joining the nearest exemplar by
numpy's (e - x)² sums when one is near enough. The radius starts at a
tenth of the norm of the column standard deviations and grows (×1.7) or
shrinks (×0.6), up to 20 passes, until the exemplar count lands within
rel_tol_num_exemplars of target_num_exemplars; the last pass is kept
even when it missed the band. A pass that is not the last stops once it
holds more than target_num_exemplars exemplars, since only its count is
used: the reference runs it to the end, to the same exemplars, which at
a small first radius costs time quadratic in the rows. The output frame
holds the exemplar rows and their counts; scoring assigns each row its
nearest exemplar.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.dkv import DKV
from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.kmeans import _dist2
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register
from h2o3_tpu_torch.models.pca import make_data_info

BATCH = 4096
SUB = 256     # missed rows whose candidates are found at a time


class AggregatorModel(Model):
    algo_name = "aggregator"

    def __init__(self, parms=None, key=None):
        super().__init__(parms, key)
        self.exemplars: Optional[np.ndarray] = None
        self.counts: Optional[np.ndarray] = None
        self.exemplar_rows: Optional[np.ndarray] = None
        self.output_frame_key: Optional[str] = None
        self.data_info: Optional[DataInfo] = None
        # port only: each pass's radius and exemplar count (target + 1
        # for a pass cut short); the last pass is the one kept
        self.search_path: list = []

    def aggregated_frame(self) -> Optional[Frame]:
        return (DKV.get(self.output_frame_key) if self.output_frame_key
                else None)

    def _predict_raw(self, frame: Frame):
        di = self.data_info
        X = di.expand(*(c.data for c in di.cols(frame)))
        E = torch.as_tensor(self.exemplars, dtype=torch.float32,
                            device=X.device)
        return {"cluster": torch.argmin(_dist2(X, E), dim=1).int()}

    def _make_metrics(self, frame, raw, extra_weight=None):
        return None


@register
class Aggregator(ModelBuilder):
    algo_name = "aggregator"
    model_class = AggregatorModel
    supervised = False

    def _score_on(self, model, frame):
        return None      # no metrics; skip the scoring pass

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({
            "target_num_exemplars": 5000,
            "rel_tol_num_exemplars": 0.5,
            "transform": "NORMALIZE",
            "categorical_encoding": "AUTO",
        })
        return p

    def _fit(self, train: Frame) -> AggregatorModel:
        from h2o3_tpu_torch.ops.filters import take_rows

        p = self.params
        di = make_data_info(train, p)
        di.set_use_all_factor_levels(True)
        Xd = di.expand(*(c.data for c in di.cols(train)))
        X = Xd.cpu().numpy()
        target = int(p.get("target_num_exemplars", 5000))
        rel_tol = float(p.get("rel_tol_num_exemplars", 0.5))
        span = float(np.linalg.norm(X.std(axis=0))) or 1.0
        radius = span * 0.1
        lo_t = int(target * (1 - rel_tol))
        path = []
        for it in range(20):    # search the radius into the target band
            # every pass but the last may stop above the target: its
            # result is dropped and only its count decides the next step
            ex_idx, assign = _radius_pass(X, Xd, radius,
                                          None if it == 19 else target)
            path.append((radius, len(ex_idx)))
            if len(ex_idx) > target:
                radius *= 1.7
            elif len(ex_idx) < max(lo_t, 1) and radius > 1e-8:
                radius *= 0.6
            else:
                break

        counts = np.bincount(assign, minlength=len(ex_idx)).astype(
            np.float64)
        model = AggregatorModel(parms=dict(p))
        self._init_output(model, train)
        model._output.model_category = ModelCategory.Clustering
        model.data_info = di
        model.exemplars = X[ex_idx]
        model.exemplar_rows = np.asarray(ex_idx)
        model.counts = counts
        model.search_path = path
        agg = take_rows(train, np.asarray(ex_idx))
        out = Frame()
        for name in agg.names:
            out.add(name, agg.col(name))
        out.add("counts", Column.from_numpy(counts, device=Xd.device))
        out.install()
        model.output_frame_key = str(out.key)
        return model


def _near_pairs(A: torch.Tensor, B: torch.Tensor, r2: float,
                upper: bool = False):
    """(i, j) index arrays, in row-major order, of the float64 rows of A
    and B that may lie within r2 of each other by numpy's float32 sum of
    (b - a)²; with `upper`, only j < i (A is B). The distances are
    ‖a‖² - 2a·b + ‖b‖² in float64: the products of float32 values are
    exact there, and the sums err by under 4(d + 2)·2⁻⁵³(‖a‖² + ‖b‖²),
    while numpy's float32 sum is at least (1 - (d + 3)u) of the true one
    (u = 2⁻²⁴: a rounded difference, its rounded square, d - 1 rounded
    adds of non-negative terms). A pair is kept unless it is farther than
    r2 by more than both margins. Chunked over A's rows to hold each
    block near 2**24 entries."""
    d = A.shape[1]
    rel = 1 + (2 * d + 8) * 2.0**-24
    slack = 4 * (d + 2) * 2.0**-53
    na, nb = (A * A).sum(dim=1), (B * B).sum(dim=1)
    out_i, out_j = [], []
    step = max(1, (1 << 24) // max(B.shape[0], 1))
    for s in range(0, A.shape[0], step):
        a, sa = A[s:s + step], na[s:s + step, None]
        dist = sa - 2.0 * (a @ B.T) + nb[None, :]
        keep = ~(dist > r2 * rel + slack * (sa + nb[None, :]) + 1e-30)
        if upper:
            keep &= torch.ones_like(keep).tril(s - 1)
        i, j = torch.nonzero(keep, as_tuple=True)
        out_i.append((i + s).cpu().numpy())
        out_j.append(j.cpu().numpy())
    return np.concatenate(out_i), np.concatenate(out_j)


def _radius_pass(X: np.ndarray, Xd: torch.Tensor, radius: float,
                 limit: Optional[int] = None):
    """One streaming pass at `radius` -> (exemplar rows, each row's
    exemplar). Row 0 is the first exemplar; a batch's nearest exemplar
    among those so far is one device matmul and argmin, and its rows
    outside every radius are admitted on the host in order, each joining
    the nearest exemplar by numpy's (e - x)² sums, as the reference
    sums them, when one lies within the radius.

    Those sums are taken only over candidates (`_near_pairs`, for SUB
    missed rows at a time): the exemplars so far, and the earlier rows
    of those SUB, that a float64 device distance cannot place outside
    the radius. Every exemplar within the radius by numpy's sum is a
    candidate, so the nearest one, ties broken to the earliest, and the
    decision to admit are the full scan's. With `limit`, the pass
    returns as soon as it holds more than `limit` exemplars (the rows
    after that one unassigned)."""
    n = X.shape[0]
    r2 = radius * radius
    dev = Xd.device
    X64 = Xd.double()
    E = np.empty_like(X)        # the exemplars' rows, in admission order
    E[0] = X[0]
    ex = np.zeros(n, np.int64)  # their row numbers; the first m hold
    m = 1
    assign = np.zeros(n, np.int64)
    i = 1
    while i < n:
        j = min(i + BATCH, n)
        d2 = _dist2(Xd[i:j], Xd[torch.from_numpy(ex[:m]).to(dev)])
        best = d2.argmin(dim=1)
        bestd = d2.gather(1, best[:, None])[:, 0].cpu().numpy()
        assign[i:j] = best.cpu().numpy()
        missed = i + np.nonzero(bestd > r2)[0]
        for s in range(0, len(missed), SUB):
            rows = missed[s:s + SUB]
            md = X64[torch.from_numpy(rows).to(dev)]
            oi, oj = _near_pairs(md, X64[torch.from_numpy(ex[:m]).to(dev)],
                                 r2)
            pi, pj = _near_pairs(md, md, r2, upper=True)
            old_at = np.searchsorted(oi, np.arange(len(rows) + 1))
            pair_at = np.searchsorted(pi, np.arange(len(rows) + 1))
            admitted = {}           # position in `rows` -> exemplar index
            for q, row in enumerate(rows):
                cand = list(oj[old_at[q]:old_at[q + 1]])
                cand += [admitted[p] for p in pj[pair_at[q]:pair_at[q + 1]]
                         if p in admitted]
                if cand:
                    dd = ((E[cand] - X[row]) ** 2).sum(axis=1)
                    bi = int(dd.argmin())
                    if dd[bi] <= r2:
                        assign[row] = cand[bi]
                        continue
                E[m], ex[m], assign[row] = X[row], row, m
                admitted[q] = m
                m += 1
                if limit is not None and m > limit:
                    return ex[:m].copy(), assign
        i = j
    return ex[:m].copy(), assign
