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
    and cover (T, M) f32: each split's gain and each node's weight (None
    for a forest carried across or read from a MOJO without them)."""

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
        r = ResidentForest(self, None, binned.device)
        return margins_core(binned, r.init, *r.arrays,
                            max_depth=r.max_depth, tree_class=r.tree_class,
                            K=r.K)

    def leaf_index(self, binned: torch.Tensor) -> torch.Tensor:
        """(N, T) int64 leaf node id of every row in every tree."""
        r = ResidentForest(self, None, binned.device)
        return leaves_core(binned, *r.walk_arrays, max_depth=r.max_depth)


# the forest arrays the walk reads, in the order the cores take them
WALK_ARRAYS = ("feat", "thresh_bin", "na_left", "left", "right",
               "cat_split", "cat_table", "na_bins")


class ResidentForest:
    """A forest's scoring inputs on one device, resolved once: the walk
    arrays (integer arrays as int64), the leaf values, the init margin as
    a tensor (a 0-dim init_f or the (K,) init_class), with the spec's
    padded edges and categorical mask when a BinSpec is given, and the
    tree -> class map as a host tuple. The cores below take these and
    sync with the host nowhere, so a CUDA graph can capture them."""

    def __init__(self, forest: CompressedForest, spec, device):
        dev = torch.device(device)
        a = forest.arrays(dev)
        self.walk_arrays = tuple(a[k] for k in WALK_ARRAYS)
        self.leaf_val = a["leaf_val"]
        # margins_core's argument order: walk arrays with leaf_val after
        # right (the reference's forest argument order)
        self.arrays = self.walk_arrays[:5] + (self.leaf_val,) \
            + self.walk_arrays[5:]
        self.tree_class = tuple(int(c) for c in np.asarray(forest.tree_class))
        self.max_depth = int(forest.max_depth)
        self.K = forest.n_margins
        init = (np.asarray(forest.init_class, np.float32)
                if forest.init_class is not None
                else np.float32(forest.init_f))
        self.init = torch.as_tensor(init, device=dev)
        if spec is not None:
            self.edges = torch.as_tensor(spec.padded_edges(), device=dev)
            self.is_cat = torch.as_tensor(np.asarray(spec.is_cat, bool),
                                          device=dev)

    def margins(self, X: torch.Tensor) -> torch.Tensor:
        """(N, F) raw float32 features -> (N,) or (N, K) margins."""
        return score_core(X, self.edges, self.is_cat, self.init,
                          *self.arrays, max_depth=self.max_depth,
                          tree_class=self.tree_class, K=self.K)

    def leaves(self, X: torch.Tensor) -> torch.Tensor:
        """(N, F) raw float32 features -> (N, T) int64 leaf ids."""
        return leaf_score_core(X, self.edges, self.is_cat,
                               *self.walk_arrays, max_depth=self.max_depth)


# a walk holds a few (trees, rows) int64 temporaries: trees are walked in
# groups of at most this many (tree, row) cells
_WALK_CELLS = 1 << 24


def _walk(binned, feat, thresh_bin, na_left, left, right, cat_split,
          cat_table, na_bins, max_depth: int):
    """Lockstep walk of every row through every tree: yields (G, N)
    leaf node ids for successive groups of G trees (all T trees at
    once when T x N fits _WALK_CELLS). Each level is a handful of
    gathers over the (G, N) node matrix, so the op count grows with the
    depth and not with the tree count. Factories take their device from
    `binned` (*_like), so an exported program carries none."""
    T, N = feat.shape[0], binned.shape[0]
    C = cat_table.shape[1]
    binned_t = binned.T.contiguous().long()            # (F, N)
    zero_row = torch.zeros_like(binned_t[0])[None, :]  # (1, N)
    G = max(1, min(T, _WALK_CELLS // max(N, 1)))
    for g0 in range(0, T, G):
        sl = slice(g0, min(T, g0 + G))
        tf, tt, tnl = feat[sl], thresh_bin[sl], na_left[sl]
        tl, tr, tcs = left[sl], right[sl], cat_split[sl]
        node = zero_row.expand(tf.shape[0], N)
        for _ in range(max_depth + 1):
            f = torch.gather(tf, 1, node)
            fi = torch.clamp_min(f, 0)
            b = torch.gather(binned_t, 0, fi)
            csid = torch.gather(tcs, 1, node)
            cat_left = cat_table[torch.clamp_min(csid, 0),
                                 torch.clamp_max(b, C - 1)]
            go_left = torch.where(csid >= 0, cat_left,
                                  b <= torch.gather(tt, 1, node))
            go_left = torch.where(b == na_bins[fi],
                                  torch.gather(tnl, 1, node), go_left)
            nxt = torch.where(go_left, torch.gather(tl, 1, node),
                              torch.gather(tr, 1, node))
            node = torch.where(f < 0, node, nxt)
        yield node


def margins_core(binned, init, feat, thresh_bin, na_left, left, right,
                 leaf_val, cat_split, cat_table, na_bins, *, max_depth: int,
                 tree_class: tuple, K: int = 1) -> torch.Tensor:
    """Lockstep traversal: (N, F) integer bins -> (N,) f32 sums of the
    leaf values plus `init` (K == 1), or (N, K) with each tree's leaf
    value added to its class's column (`tree_class`, a host tuple) and
    the (K,) `init` after; one f32 add per tree in tree order."""
    N = binned.shape[0]
    acc = leaf_val.new_zeros((N, K) if K > 1 else (N,))
    t = 0
    for node in _walk(binned, feat, thresh_bin, na_left, left, right,
                      cat_split, cat_table, na_bins, max_depth):
        contrib = torch.gather(leaf_val[t: t + node.shape[0]], 1, node)
        for row in contrib:
            if K > 1:
                acc[:, tree_class[t]] += row
            else:
                acc = acc + row
            t += 1
    return acc + init


def leaves_core(binned, feat, thresh_bin, na_left, left, right, cat_split,
                cat_table, na_bins, *, max_depth: int) -> torch.Tensor:
    """(N, F) integer bins -> (N, T) int64 leaf node ids."""
    return torch.cat(list(_walk(binned, feat, thresh_bin, na_left, left,
                                right, cat_split, cat_table, na_bins,
                                max_depth)), dim=0).T


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


def score_core(X, edges, is_cat, init, feat, thresh_bin, na_left, left,
               right, leaf_val, cat_split, cat_table, na_bins, *,
               max_depth: int, tree_class: tuple, K: int = 1
               ) -> torch.Tensor:
    """The fused scoring program (the reference's `_fused_score_fn`,
    compressed.py:336): (N, F) raw float32 features -> margins, binning
    with the training edges, the lockstep walk and the init margin. Every
    tree predict, the scoring sessions' CUDA graphs and the exported
    artifact programs run this one function."""
    binned = _bin_features(X, edges, is_cat, na_bins)
    return margins_core(binned, init, feat, thresh_bin, na_left, left,
                        right, leaf_val, cat_split, cat_table, na_bins,
                        max_depth=max_depth, tree_class=tree_class, K=K)


def leaf_score_core(X, edges, is_cat, feat, thresh_bin, na_left, left,
                    right, cat_split, cat_table, na_bins, *, max_depth: int
                    ) -> torch.Tensor:
    """The fused bin + leaf program (the reference's `_fused_leaf_fn`,
    compressed.py:418): (N, F) raw features -> (N, T) int64 leaf ids."""
    binned = _bin_features(X, edges, is_cat, na_bins)
    return leaves_core(binned, feat, thresh_bin, na_left, left, right,
                       cat_split, cat_table, na_bins, max_depth=max_depth)


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
