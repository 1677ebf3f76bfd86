"""Host-orchestrated level-wise tree growth (counterpart of
h2o3_tpu/models/tree/host_grow.py `grow_tree_host` :27).

Per level: one device histogram of the active nodes (histogram.py), a
host numpy split search over those nodes only (dtree.py), and one device
routing pass. Memory is O(active nodes). The fit loops use the
single-dispatch grower (device_tree.grow_tree_device); this one serves
the public single-tree entry `shared_tree.grow_tree`, whose trees number
their leaves densely.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from h2o3_tpu_torch.models.tree.dtree import (HostTree, find_best_splits,
                                              left_table_for)
from h2o3_tpu_torch.models.tree.histogram import build_histogram, route_rows


def grow_tree_host(binned, hist_w, hist_y, spec, *, max_depth: int,
                   min_rows: float, min_split_improvement: float,
                   row_active=None, feat_mask_fn=None):
    """Grow one tree level by level. Returns (HostTree, row_leaf (N,)
    int32 tensor) with dense leaf ids (tree.n_leaves counts them)."""
    N = binned.shape[0]
    dev = binned.device
    tree = HostTree()
    row_node = torch.zeros(N, dtype=torch.int32, device=dev)
    if row_active is not None:
        row_node = torch.where(torch.as_tensor(row_active, device=dev),
                               row_node, -1)
    row_leaf = torch.full((N,), -1, dtype=torch.int32, device=dev)
    hist_w = torch.as_tensor(hist_w, device=dev).float()
    hist_y = torch.as_tensor(hist_y, device=dev).float()
    slots = [0]                   # tree nid per active slot

    if max_depth == 0:
        # a stump needs two sums over the active rows, not a histogram
        w32 = torch.where(row_node >= 0, hist_w, 0.0)
        wy = float(torch.sum(w32 * hist_y))
        tree.nodes[0].weight = float(torch.sum(w32))
        tree.nodes[0].pred = wy / max(tree.nodes[0].weight, 1e-12)

    maxB = int(spec.nbins.max())
    for depth in range(max_depth + 1):
        if not slots:
            break
        S = len(slots)
        # the last level never splits, so it builds no histogram
        if depth < max_depth:
            hist = build_histogram(binned, row_node, hist_w, hist_y, spec, S)
            if depth == 0:
                # root stats from feature 0's bins of the level histogram
                o, B = int(spec.offsets[0]), int(spec.nbins[0])
                tree.nodes[0].weight = float(hist[0, o:o + B, 0].sum())
                wy = float(hist[0, o:o + B, 1].sum())
                tree.nodes[0].pred = wy / max(tree.nodes[0].weight, 1e-12)
            feat_mask = feat_mask_fn(S) if feat_mask_fn else None
            splits = find_best_splits(
                hist, spec, min_rows=min_rows,
                min_split_improvement=min_split_improvement,
                feat_mask=feat_mask)
        else:
            splits = [None] * S
        split_feat = np.full(S, -1, np.int32)
        left_slot = np.full(S, -1, np.int32)
        right_slot = np.full(S, -1, np.int32)
        leaf_id = np.full(S, -1, np.int32)
        next_slots: List[int] = []
        for s, sp in enumerate(splits):
            nid = slots[s]
            node = tree.nodes[nid]
            if sp is None:
                leaf_id[s] = tree.finalize_leaf(nid, node.weight, node.pred)
                continue
            node.split = sp
            split_feat[s] = sp.feat
            node.left = tree.new_node(depth + 1)
            node.right = tree.new_node(depth + 1)
            for child, (cw, cwy) in ((node.left, sp.left_stats),
                                     (node.right, sp.right_stats)):
                tree.nodes[child].weight = float(cw)
                tree.nodes[child].pred = float(cwy) / max(float(cw), 1e-12)
            left_slot[s] = len(next_slots)
            next_slots.append(node.left)
            right_slot[s] = len(next_slots)
            next_slots.append(node.right)
        lt = left_table_for(splits, spec, maxB)
        row_node, row_leaf = route_rows(
            binned, row_node, row_leaf, split_feat=split_feat, left_table=lt,
            left_slot=left_slot, right_slot=right_slot, leaf_id=leaf_id)
        slots = next_slots
    return tree, row_leaf
