"""Host-side tree structure and the host split search (a copy of
h2o3_tpu/models/tree/dtree.py: `_se` :55, `find_best_splits` :60,
`left_table_for` :135, `HostTree` :153, which the port cannot import).

Split gain is the squared-error reduction SE(parent) - SE(left) -
SE(right) with SE = wyy - wy^2/w, computed in numpy float64 from a
level's (S, tot_bins, 3) histogram; NA rows go to whichever side gains
more; categorical splits are subset splits over the categories sorted
by mean response (optimal for squared loss).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

EPS_W = 1e-12


@dataclass
class Split:
    feat: int
    is_cat: bool
    thresh_bin: int               # numeric: go left iff bin <= thresh_bin
    left_bins: Optional[np.ndarray]   # categorical: bool (B_f-1,) over codes
    na_left: bool
    gain: float
    left_stats: tuple             # (w, wy)
    right_stats: tuple


@dataclass
class TreeNode:
    """One node of a host tree; compressed after training."""

    nid: int
    depth: int
    split: Optional[Split] = None
    left: int = -1
    right: int = -1
    leaf_value: float = 0.0
    leaf_id: int = -1             # dense leaf numbering
    weight: float = 0.0
    pred: float = 0.0             # node mean (wy/w)


class HostTree:
    """Host tree assembled from one tree's packed tables."""

    def __init__(self):
        self.nodes: List[TreeNode] = [TreeNode(0, 0)]
        self.n_leaves = 0

    def new_node(self, depth: int) -> int:
        nid = len(self.nodes)
        self.nodes.append(TreeNode(nid, depth))
        return nid

    def finalize_leaf(self, nid: int, weight: float, pred: float) -> int:
        n = self.nodes[nid]
        n.leaf_id = self.n_leaves
        n.weight = weight
        n.pred = pred
        self.n_leaves += 1
        return n.leaf_id


def _se(w, wy, wyy):
    """Squared error within a bucket set; 0 where empty."""
    return wyy - np.where(w > EPS_W, wy * wy / np.maximum(w, EPS_W), 0.0)


def find_best_splits(hist: np.ndarray, spec, *, min_rows: float,
                     min_split_improvement: float,
                     feat_mask: Optional[np.ndarray] = None
                     ) -> List[Optional[Split]]:
    """Best split per active node from the level histogram.

    hist: (S, tot_bins, 3) float64 w/wy/wyy. feat_mask: optional (S, F)
    bool of the features allowed per node. Returns one Split or None per
    node slot."""
    S = hist.shape[0]
    best_gain = np.full(S, 0.0)
    best: List[Optional[Split]] = [None] * S
    for f in range(spec.F):
        o, B = int(spec.offsets[f]), int(spec.nbins[f])
        H = hist[:, o:o + B, :]               # (S, B, 3)
        na = H[:, -1, :]                      # (S, 3) NA bucket
        V = H[:, :-1, :]                      # value buckets
        nb = V.shape[1]
        if nb < 2:
            continue
        tot = V.sum(axis=1) + na              # (S, 3)
        se_parent = _se(tot[:, 0], tot[:, 1], tot[:, 2])
        if spec.is_cat[f]:
            mean = np.where(V[:, :, 0] > EPS_W,
                            V[:, :, 1] / np.maximum(V[:, :, 0], EPS_W),
                            np.inf)
            order = np.argsort(mean, axis=1)                  # (S, nb)
            Vs = np.take_along_axis(V, order[:, :, None], axis=1)
        else:
            order = None
            Vs = V
        cand = np.cumsum(Vs, axis=1)[:, :-1, :]   # split after position t
        gains = np.full((S, nb - 1, 2), -np.inf)
        for na_dir in (0, 1):                     # 0: NA right, 1: NA left
            L = cand + (na[:, None, :] if na_dir else 0)
            R = tot[:, None, :] - L
            ok = (L[:, :, 0] >= min_rows) & (R[:, :, 0] >= min_rows)
            g = (se_parent[:, None]
                 - _se(L[:, :, 0], L[:, :, 1], L[:, :, 2])
                 - _se(R[:, :, 0], R[:, :, 1], R[:, :, 2]))
            gains[:, :, na_dir] = np.where(ok, g, -np.inf)
        flat = gains.reshape(S, -1)
        bi = np.argmax(flat, axis=1)
        bg = flat[np.arange(S), bi]
        t, na_dir = bi // 2, bi % 2
        improve = bg > np.maximum(best_gain, min_split_improvement)
        if feat_mask is not None:
            improve &= feat_mask[:, f]
        for s in np.nonzero(improve)[0]:
            ts = int(t[s])
            Lst = cand[s, ts] + (na[s] if na_dir[s] else 0)
            Rst = tot[s] - Lst
            if spec.is_cat[f]:
                left_bins = np.zeros(nb, bool)
                left_bins[order[s, :ts + 1]] = True
                split = Split(f, True, -1, left_bins, bool(na_dir[s]),
                              float(bg[s]), (Lst[0], Lst[1]),
                              (Rst[0], Rst[1]))
            else:
                split = Split(f, False, ts, None, bool(na_dir[s]),
                              float(bg[s]), (Lst[0], Lst[1]),
                              (Rst[0], Rst[1]))
            best_gain[s] = bg[s]
            best[s] = split
    return best


def left_table_for(splits: List[Optional[Split]], spec,
                   maxB: int) -> np.ndarray:
    """(S, maxB) bool routing table: entry [s, b] says a row with bin b
    goes left. The NA bin (B_f-1) carries the NA direction, so numeric
    and categorical splits route the same way."""
    lt = np.zeros((len(splits), maxB), bool)
    for s, sp in enumerate(splits):
        if sp is None:
            continue
        B = int(spec.nbins[sp.feat])
        if sp.is_cat:
            lt[s, :B - 1] = sp.left_bins
        else:
            lt[s, :sp.thresh_bin + 1] = True
        lt[s, B - 1] = sp.na_left
    return lt
