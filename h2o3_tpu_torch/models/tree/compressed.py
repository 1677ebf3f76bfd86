"""Compressed forest: stacked per-node tree arrays and device scoring
(counterpart of h2o3_tpu/models/tree/compressed.py).

The forest is dense host arrays shaped (n_trees, max_nodes): feat /
thresh_bin / na_left / left / right / leaf_val / cat_split, plus one
shared categorical-subset table. Scoring walks every row through every
tree in lockstep: a Python loop over trees, the depth loop as torch ops
on the whole row batch; test data is binned with the training edges so
the walk is pure integer compares.
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
    row of cat_table). cat_table (C, maxB) bool. tree_class (T,) int32.
    na_bins (F,) int32 = NA bin per feature."""

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

    @property
    def n_trees(self) -> int:
        return int(self.feat.shape[0])

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
        for ti, tree in enumerate(trees):
            for n in tree.nodes:
                if n.split is None:
                    leaf_val[ti, n.nid] = n.leaf_value
                    continue
                s = n.split
                feat[ti, n.nid] = s.feat
                na_left[ti, n.nid] = s.na_left
                left[ti, n.nid] = n.left
                right[ti, n.nid] = n.right
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
        return CompressedForest(feat, thresh, na_left, left, right, leaf_val,
                                cat_split, cat_table, tc,
                                (spec.nbins - 1).astype(np.int32),
                                max_depth=max_depth, init_f=init_f,
                                nclasses=nclasses)

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

    def _check_single_margin(self):
        if self.nclasses > 2 or int(np.asarray(self.tree_class).max(
                initial=0)) > 0:
            raise NotImplementedError("per-class forests (multinomial) are "
                                      "not ported yet")

    def predict_binned(self, binned: torch.Tensor) -> torch.Tensor:
        """(N, F) integer bins -> (N,) f32 margins (leaf sums + init_f)."""
        self._check_single_margin()
        a = self.arrays(binned.device)
        return _forest_margins(binned, a, self.max_depth) + self.init_f


def _forest_margins(binned, a: dict, max_depth: int) -> torch.Tensor:
    """Lockstep traversal: (N, F) integer bins -> (N,) f32 sums of the
    leaf values, one f32 add per tree in tree order."""
    N = binned.shape[0]
    cat_table = a["cat_table"]
    C = cat_table.shape[1]
    na_bins = a["na_bins"]
    acc = torch.zeros(N, dtype=torch.float32, device=binned.device)
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
        acc = acc + a["leaf_val"][t][node]
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
    """(N, F) raw float32 features -> (N,) f32 margins: binning with the
    training edges, the lockstep traversal and the init margin."""
    forest._check_single_margin()
    a = forest.arrays(X.device)
    binned = _bin_features(X, edges, is_cat, a["na_bins"])
    return _forest_margins(binned, a, forest.max_depth) + forest.init_f
