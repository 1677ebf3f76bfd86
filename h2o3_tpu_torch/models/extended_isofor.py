"""Extended Isolation Forest: random-hyperplane isolation trees
(counterpart of h2o3_tpu/models/extended_isofor.py: `_Node` :29,
`ExtendedIsolationForestModel._predict_raw` :57, `_fit` :117, `_grow`
:166).

Trees are grown on the host, each on a psi-row subsample of the
expanded design matrix (DataInfo, one-hot categoricals, raw numerics):
a node splits its rows by a random hyperplane through a random point of
their bounding box, with `extension_level` + 1 nonzero coordinates in
its normal. The host draws are the reference's numpy Generator calls in
the reference's order, so the trees are equal to the reference's.

Scoring runs on the device. Every tree's nodes are packed into dense
(T, M, d) normals and (T, M) offsets, children and leaf path lengths,
and all rows walk all trees level by level with batched gathers and dot
products. Gathering a normal per (row, tree) is an (n, T, d) tensor per
level, so rows are scored in chunks that keep it under
`DEFAULT_CHUNK_BYTES`;
each row is scored on its own, so chunking changes no result. The dot
products and the mean path length are summed in float64 (each f32
product is exact there), so the card and the CPU route every row the
same way and agree on its score.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register
from h2o3_tpu_torch.models.tree.isofor import _avg_path

# bytes of the per-level (rows, T, d) float64 normal gather of one chunk
DEFAULT_CHUNK_BYTES = 256 * 1024 * 1024


class _Node:
    __slots__ = ("normal", "point", "left", "right", "value")

    def __init__(self):
        self.normal = None
        self.point = None
        self.left = -1
        self.right = -1
        self.value = 0.0


def score_packed(X, normals, offsets, lefts, rights, values, depth: int,
                 cnorm: float, chunk_bytes: int = DEFAULT_CHUNK_BYTES):
    """(n, d) float32 rows through T packed trees -> (score, mean_length),
    both (n,) float32, on X's device. A row goes left at a node when
    X·normal - offset < 0; a leaf (child -1) keeps the row."""
    dev = X.device
    Nrm = torch.as_tensor(normals, device=dev).double()
    Off = torch.as_tensor(offsets, device=dev).double()
    L = torch.as_tensor(lefts, device=dev).long()
    R = torch.as_tensor(rights, device=dev).long()
    Val = torch.as_tensor(values, device=dev).float()
    T, _, d = Nrm.shape
    n = X.shape[0]
    rows = max(int(chunk_bytes) // max(T * d * 8, 1), 1)
    tr = torch.arange(T, device=dev)[None, :]
    lengths = []
    for a in range(0, n, rows):
        Xc = X[a:a + rows].double()
        node = torch.zeros((Xc.shape[0], T), dtype=torch.long, device=dev)
        for _ in range(depth):
            s = torch.einsum("nd,ntd->nt", Xc, Nrm[tr, node]) - Off[tr, node]
            nxt = torch.where(s < 0, L[tr, node], R[tr, node])
            node = torch.where(nxt >= 0, nxt, node)
        lengths.append((Val[tr, node].double().sum(dim=1) / T).float())
    mean_len = (torch.cat(lengths) if lengths
                else torch.zeros(0, dtype=torch.float32, device=dev))
    return torch.exp2(-mean_len / cnorm), mean_len


class ExtendedIsolationForestModel(Model):
    algo_name = "extendedisolationforest"

    def __init__(self, parms=None):
        super().__init__(parms=parms)
        self.normals: Optional[np.ndarray] = None   # (T, M, d)
        self.offsets: Optional[np.ndarray] = None   # (T, M) = normal·point
        self.lefts: Optional[np.ndarray] = None     # (T, M) child or -1
        self.rights: Optional[np.ndarray] = None
        self.values: Optional[np.ndarray] = None    # (T, M) path length
        self.max_depth: int = 0
        self.cnorm: float = 1.0
        self.data_info: Optional[DataInfo] = None

    def _predict_raw(self, frame: Frame):
        di = self.data_info
        X = di.expand(*(c.data for c in di.cols(frame)))
        s, ml = score_packed(X, self.normals, self.offsets, self.lefts,
                             self.rights, self.values, self.max_depth,
                             self.cnorm, DEFAULT_CHUNK_BYTES)
        return {"score": s, "mean_length": ml}

    def _make_metrics(self, frame, raw, extra_weight=None):
        return None


@register
class ExtendedIsolationForest(ModelBuilder):
    algo_name = "extendedisolationforest"
    model_class = ExtendedIsolationForestModel
    supervised = False

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({"ntrees": 100, "sample_size": 256,
                  "extension_level": 0})  # 0 axis-parallel; d-1 full
        return p

    def _fit(self, train: Frame) -> ExtendedIsolationForestModel:
        p = self.params
        di = DataInfo(train, ignored=p.get("ignored_columns") or (),
                      standardize=False, use_all_factor_levels=True)
        n = train.nrows
        X = di.expand(*(c.data for c in di.cols(train))).cpu().numpy()
        d = X.shape[1]
        ext = min(int(p.get("extension_level", 0)), d - 1)
        psi = min(int(p.get("sample_size", 256)), n)
        ntrees = int(p.get("ntrees", 100))
        max_depth = max(int(np.ceil(np.log2(max(psi, 2)))), 1)
        rng = np.random.default_rng(self._seed())

        all_nodes: List[List[_Node]] = []
        for _ in range(ntrees):
            sub = X[rng.choice(n, size=psi, replace=False)]
            nodes: List[_Node] = []
            self._grow(sub, 0, max_depth, ext, rng, nodes)
            all_nodes.append(nodes)

        M = max(len(nd) for nd in all_nodes)
        normals = np.zeros((ntrees, M, d), np.float32)
        offsets = np.zeros((ntrees, M), np.float32)
        lefts = np.full((ntrees, M), -1, np.int32)
        rights = np.full((ntrees, M), -1, np.int32)
        values = np.zeros((ntrees, M), np.float32)
        for t, nds in enumerate(all_nodes):
            for i, nd in enumerate(nds):
                values[t, i] = nd.value
                if nd.normal is not None:
                    normals[t, i] = nd.normal
                    offsets[t, i] = float(nd.normal @ nd.point)
                    lefts[t, i] = nd.left
                    rights[t, i] = nd.right

        model = ExtendedIsolationForestModel(parms=dict(p))
        self._init_output(model, train)
        model._output.model_category = ModelCategory.AnomalyDetection
        model.data_info = di
        model.normals, model.offsets = normals, offsets
        model.lefts, model.rights, model.values = lefts, rights, values
        model.max_depth = max_depth
        model.cnorm = max(_avg_path(psi), 1e-9)
        return model

    def _grow(self, rows: np.ndarray, depth: int, max_depth: int, ext: int,
              rng, nodes: List[_Node]) -> int:
        nd = _Node()
        idx = len(nodes)
        nodes.append(nd)
        if depth >= max_depth or len(rows) <= 1:
            nd.value = depth + _avg_path(len(rows))
            return idx
        d = rows.shape[1]
        normal = rng.standard_normal(d)
        # extension_level: all but ext+1 random coordinates are zero
        if ext < d - 1:
            keep = rng.choice(d, size=ext + 1, replace=False)
            m = np.zeros(d, bool)
            m[keep] = True
            normal = np.where(m, normal, 0.0)
        lo, hi = rows.min(axis=0), rows.max(axis=0)
        point = rng.uniform(lo, hi)
        side = (rows - point) @ normal < 0
        if side.all() or (~side).all():
            nd.value = depth + _avg_path(len(rows))
            return idx
        nd.normal = normal.astype(np.float32)
        nd.point = point.astype(np.float32)
        nd.value = depth + _avg_path(len(rows))   # if traversal stops here
        nd.left = self._grow(rows[side], depth + 1, max_depth, ext, rng, nodes)
        nd.right = self._grow(rows[~side], depth + 1, max_depth, ext, rng,
                              nodes)
        return idx
