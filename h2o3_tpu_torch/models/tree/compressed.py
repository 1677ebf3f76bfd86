"""Compressed forest: stacked per-node tree arrays and device scoring
(counterpart of h2o3_tpu/models/tree/compressed.py; `concat` :110,
`forest_predict_fn` :459).

The forest is dense host arrays shaped (n_trees, max_nodes): feat /
thresh_bin / na_left / left / right / leaf_val / cat_split, plus one
shared categorical-subset table. Scoring walks every row through every
tree in lockstep: a Python loop over trees, the depth loop as torch ops
on the whole row batch; test data is binned with the training edges so
the walk is pure integer compares. Per-class forests (multinomial, DRF's
binomial_double_trees) add each tree's leaf value into its class's
column of an (N, K) margin.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

_INT_ARRAYS = ("feat", "thresh_bin", "left", "right", "cat_split",
               "tree_class", "na_bins")


class CompressedForest:
    """Arrays (T, M): feat int32 (-1 leaf), thresh_bin int32, na_left bool,
    left/right int32, leaf_val f32, cat_split int32 (-1 numeric, else a
    row of cat_table). cat_table (C, maxB) bool. tree_class (T,) int32
    tree -> class. na_bins (F,) int32 = NA bin per feature. init_class
    (K,) per-class prior margins of a multinomial GBM, else None. gain
    and cover (T, M) f32: each split's gain and each node's weight, for
    forests built here (None for forests carried across)."""

    def __init__(self, feat, thresh_bin, na_left, left, right, leaf_val,
                 cat_split, cat_table, tree_class, na_bins, max_depth: int,
                 init_f: float = 0.0, nclasses: int = 1):
        self.feat = feat
        self.thresh_bin = thresh_bin
        self.na_left = na_left
        self.left = left
        self.right = right
        self.leaf_val = leaf_val
        self.cat_split = cat_split
        self.cat_table = cat_table
        self.tree_class = tree_class
        self.na_bins = na_bins
        self.max_depth = int(max_depth)
        self.init_f = float(init_f)
        self.nclasses = int(nclasses)
        self.init_class = None
        self.gain = None
        self.cover = None

    @property
    def n_trees(self) -> int:
        return int(self.feat.shape[0])

    @property
    def per_class_trees(self) -> bool:
        """True when trees are grown one per class (multinomial, or DRF's
        binomial_double_trees: class-1 trees at nclasses == 2), so scoring
        keeps K class margins."""
        return self.nclasses > 2 or (
            self.nclasses == 2
            and int(np.asarray(self.tree_class).max(initial=0)) > 0)

    @property
    def n_margins(self) -> int:
        """K of the (N, K) margins, or 1 for (N,) margins."""
        return self.nclasses if self.per_class_trees else 1

    def init_margin(self, device):
        """What scoring adds to the leaf sums: init_class as a (K,) tensor,
        else init_f."""
        if self.init_class is None:
            return self.init_f
        return torch.as_tensor(np.asarray(self.init_class, np.float32),
                               device=device)

    @staticmethod
    def from_host_trees(trees: List, spec, *, tree_class=None,
                        max_depth: int, init_f: float = 0.0,
                        nclasses: int = 1) -> "CompressedForest":
        T = len(trees)
        M = max(max(len(t.nodes) for t in trees), 1)
        feat = np.full((T, M), -1, np.int32)
        thresh = np.zeros((T, M), np.int32)
        na_left = np.zeros((T, M), bool)
        left = np.zeros((T, M), np.int32)
        right = np.zeros((T, M), np.int32)
        leaf_val = np.zeros((T, M), np.float32)
        cat_split = np.full((T, M), -1, np.int32)
        cat_rows = []
        maxB = int(spec.nbins.max())
        gain = np.zeros((T, M), np.float32)
        cover = np.zeros((T, M), np.float32)
        for ti, tree in enumerate(trees):
            for n in tree.nodes:
                cover[ti, n.nid] = n.weight
                if n.split is None:
                    leaf_val[ti, n.nid] = n.leaf_value
                    continue
                s = n.split
                feat[ti, n.nid] = s.feat
                na_left[ti, n.nid] = s.na_left
                left[ti, n.nid] = n.left
                right[ti, n.nid] = n.right
                gain[ti, n.nid] = max(s.gain, 0.0)
                if s.is_cat:
                    row = np.zeros(maxB, bool)
                    row[: len(s.left_bins)] = s.left_bins
                    cat_split[ti, n.nid] = len(cat_rows)
                    cat_rows.append(row)
                else:
                    thresh[ti, n.nid] = s.thresh_bin
        cat_table = (np.stack(cat_rows) if cat_rows
                     else np.zeros((1, maxB), bool))
        tc = (np.asarray(tree_class, np.int32) if tree_class is not None
              else np.zeros(T, np.int32))
        out = CompressedForest(feat, thresh, na_left, left, right, leaf_val,
                               cat_split, cat_table, tc,
                               (spec.nbins - 1).astype(np.int32),
                               max_depth=max_depth, init_f=init_f,
                               nclasses=nclasses)
        out.gain = gain
        out.cover = cover
        return out

    @staticmethod
    def concat(a: "CompressedForest", b: "CompressedForest", *,
               scale_a: float = 1.0, scale_b: float = 1.0
               ) -> "CompressedForest":
        """Forest b's trees after forest a's (training continuation).
        Node tables pad to the wider forest; b's categorical-subset rows
        append with its split indices shifted. scale_a / scale_b rescale
        the leaf values (DRF stores leaves divided by its tree count, so
        a continued forest rescales both sides to n_side / n_total)."""
        if a.nclasses != b.nclasses:
            raise ValueError(f"concat: {a.nclasses} vs {b.nclasses} classes")
        M = max(a.feat.shape[1], b.feat.shape[1])

        def pad(x, fill):
            x = np.asarray(x)
            if x.shape[1] == M:
                return x
            out = np.full((x.shape[0], M), fill, x.dtype)
            out[:, :x.shape[1]] = x
            return out

        maxB = max(a.cat_table.shape[1], b.cat_table.shape[1])

        def padB(t):
            t = np.asarray(t)
            if t.shape[1] == maxB:
                return t
            out = np.zeros((t.shape[0], maxB), bool)
            out[:, :t.shape[1]] = t
            return out

        b_cs = pad(b.cat_split, -1).copy()
        b_cs[b_cs >= 0] += a.cat_table.shape[0]

        def cat(fa, fb):
            return np.concatenate([fa, fb], axis=0)

        out = CompressedForest(
            cat(pad(a.feat, -1), pad(b.feat, -1)),
            cat(pad(a.thresh_bin, 0), pad(b.thresh_bin, 0)),
            cat(pad(a.na_left, False), pad(b.na_left, False)),
            cat(pad(a.left, 0), pad(b.left, 0)),
            cat(pad(a.right, 0), pad(b.right, 0)),
            cat(pad(a.leaf_val, 0).astype(np.float32) * np.float32(scale_a),
                pad(b.leaf_val, 0).astype(np.float32) * np.float32(scale_b)),
            cat(pad(a.cat_split, -1), b_cs),
            cat(padB(a.cat_table), padB(b.cat_table)),
            np.concatenate([np.asarray(a.tree_class),
                            np.asarray(b.tree_class)]),
            np.asarray(a.na_bins),
            max_depth=max(a.max_depth, b.max_depth),
            init_f=a.init_f, nclasses=a.nclasses)
        out.init_class = a.init_class
        if a.gain is not None and b.gain is not None:
            out.gain = cat(pad(a.gain, 0), pad(b.gain, 0))
            out.cover = cat(pad(a.cover, 0), pad(b.cover, 0))
        return out

    def depths(self) -> np.ndarray:
        """(T,) depth of each tree's deepest node (0 for a stump)."""
        out = np.zeros(self.n_trees, np.int64)
        for t in range(self.n_trees):
            feat, left, right = self.feat[t], self.left[t], self.right[t]
            level, d = [0], 0
            while True:
                level = [c for m in level if feat[m] >= 0
                         for c in (left[m], right[m])]
                if not level:
                    break
                d += 1
            out[t] = d
        return out

    def arrays(self, device) -> dict:
        """The forest's arrays as tensors on `device` (integer arrays as
        int64, ready to index with)."""
        out = {}
        for name in ("feat", "thresh_bin", "na_left", "left", "right",
                     "leaf_val", "cat_split", "cat_table", "tree_class",
                     "na_bins"):
            t = torch.as_tensor(np.asarray(getattr(self, name)), device=device)
            out[name] = t.long() if name in _INT_ARRAYS else t
        return out

    def predict_binned(self, binned: torch.Tensor) -> torch.Tensor:
        """(N, F) integer bins -> (N,) f32 margins (leaf sums + init_f),
        or (N, K) per-class margins for a per-class forest."""
        a = self.arrays(binned.device)
        return (_forest_margins(binned, a, self.max_depth, self.n_margins)
                + self.init_margin(binned.device))

    def leaf_index(self, binned: torch.Tensor) -> torch.Tensor:
        """(N, T) int64 leaf node id of every row in every tree."""
        a = self.arrays(binned.device)
        return torch.stack(list(_walk(binned, a, self.max_depth)), dim=1)


def _walk(binned, a: dict, max_depth: int):
    """Lockstep walk of every row through each tree in turn: yields the
    (N,) leaf node ids of tree 0, 1, ..."""
    N = binned.shape[0]
    cat_table = a["cat_table"]
    C = cat_table.shape[1]
    na_bins = a["na_bins"]
    for t in range(a["feat"].shape[0]):
        tf, tt, tnl = a["feat"][t], a["thresh_bin"][t], a["na_left"][t]
        tl, tr, tcs = a["left"][t], a["right"][t], a["cat_split"][t]
        node = torch.zeros(N, dtype=torch.long, device=binned.device)
        for _ in range(max_depth + 1):
            f = tf[node]
            fi = torch.clamp_min(f, 0)
            b = torch.gather(binned, 1, fi[:, None])[:, 0].long()
            csid = tcs[node]
            cat_left = cat_table[torch.clamp_min(csid, 0),
                                 torch.clamp_max(b, C - 1)]
            go_left = torch.where(csid >= 0, cat_left, b <= tt[node])
            go_left = torch.where(b == na_bins[fi], tnl[node], go_left)
            nxt = torch.where(go_left, tl[node], tr[node])
            node = torch.where(f < 0, node, nxt)
        yield node


def _forest_margins(binned, a: dict, max_depth: int, K: int = 1
                    ) -> torch.Tensor:
    """Lockstep traversal: (N, F) integer bins -> (N,) f32 sums of the
    leaf values (K == 1), or (N, K) with each tree's leaf value added to
    its class's column; one f32 add per tree in tree order."""
    N = binned.shape[0]
    shape = (N, K) if K > 1 else (N,)
    acc = torch.zeros(shape, dtype=torch.float32, device=binned.device)
    tree_class = a["tree_class"].tolist()
    for t, node in enumerate(_walk(binned, a, max_depth)):
        contrib = a["leaf_val"][t][node]
        if K > 1:
            acc[:, tree_class[t]] += contrib
        else:
            acc = acc + contrib
    return acc


def _bin_features(X, edges, is_cat, na_bins):
    """(N, F) raw float32 features (categoricals as codes, NA as NaN or a
    negative code) -> (N, F) int64 bins, bitwise the same as
    BinSpec.bin_columns: numeric bin = number of edges < x (the +inf pad
    lanes of `edges` never count), categorical bin = code, NA and
    out-of-range codes to the feature's NA bin."""
    nb = na_bins[None, :]
    num_b = torch.searchsorted(edges, X.T.contiguous(), side="left").T
    num_b = torch.where(torch.isnan(X), nb, num_b)
    codes = torch.where(torch.isnan(X), -1.0, X).long()
    cat_b = torch.where((codes < 0) | (codes >= nb), nb, codes)
    return torch.where(is_cat[None, :], cat_b, num_b)


def _fused_margins(X, edges, is_cat, forest: CompressedForest):
    """(N, F) raw float32 features -> (N,) or (N, K) f32 margins: binning
    with the training edges, the lockstep traversal and the init
    margin."""
    a = forest.arrays(X.device)
    binned = _bin_features(X, edges, is_cat, a["na_bins"])
    return (_forest_margins(binned, a, forest.max_depth, forest.n_margins)
            + forest.init_margin(X.device))


def forest_predict_fn(device=None):
    """(fn, example_args): the flagship's scoring step, a random but
    structurally real forest (50 trees of depth 5 over 32 features of 20
    bins) traversed over 1024 binned rows, built as the reference's
    compile-check entry builds it; the tensors are on `device` (default:
    the booted one)."""
    from h2o3_tpu_torch.core.runtime import cluster

    dev = torch.device(device) if device is not None else cluster().device
    rng = np.random.default_rng(0)
    T, depth, F, B, N = 50, 5, 32, 20, 1024
    M = 2 ** (depth + 1) - 1
    feat = np.full((T, M), -1, np.int32)
    inner = M // 2
    feat[:, :inner] = rng.integers(0, F, (T, inner))
    thresh = rng.integers(0, B - 1, (T, M)).astype(np.int32)
    left = np.zeros((T, M), np.int32)
    right = np.zeros((T, M), np.int32)
    for m in range(inner):
        left[:, m], right[:, m] = 2 * m + 1, 2 * m + 2
    forest = CompressedForest(
        feat, thresh, np.zeros((T, M), bool), left, right,
        rng.standard_normal((T, M)).astype(np.float32),
        np.full((T, M), -1, np.int32), np.zeros((1, B), bool),
        np.zeros(T, np.int32), np.full(F, B - 1, np.int32), max_depth=depth)
    binned = torch.as_tensor(rng.integers(0, B - 1, (N, F)),
                             dtype=torch.int32, device=dev)

    def fwd(binned):
        return forest.predict_binned(binned)

    return fwd, (binned,)
