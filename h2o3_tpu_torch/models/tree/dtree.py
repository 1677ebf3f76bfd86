"""Host-side tree structure (a copy of the HostTree / Split / TreeNode
part of h2o3_tpu/models/tree/dtree.py, which the port cannot import).

Split gain is the squared-error reduction SE(parent) - SE(left) -
SE(right) with SE = wyy - wy^2/w; categorical splits are subset splits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


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
    leaf_id: int = -1
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
