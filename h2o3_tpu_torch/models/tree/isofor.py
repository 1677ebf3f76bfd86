"""Isolation Forest: anomaly detection with random isolation trees
(counterpart of h2o3_tpu/models/tree/isofor.py: `_avg_path` :29,
`IsolationForestModel` :37, `IsolationForest._fit` :69,
`_grow_random_tree` :112, `_cat_bins` :181).

Each tree isolates a `sample_size`-row sample (drawn without
replacement): per level, one count histogram of the live rows (the
level-wise `build_histogram`, so the hand-written kernel on the card)
gives every node's row count and occupied bin range, the host draws a
random feature and a random threshold bin inside that range, and one
routing pass moves the rows. A leaf stores depth + c(count), so the
summed traversal of the forest gives each row's total path length, and
the anomaly score is 2^(-mean length / c(sample_size)).

Every host draw is the reference's numpy Generator call, in the
reference's order, so forests are equal to the reference's bit for bit
wherever the counts are (they are integers, summed exactly).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.model import ModelCategory
from h2o3_tpu_torch.models.model_builder import register
from h2o3_tpu_torch.models.tree.binning import BinSpec
from h2o3_tpu_torch.models.tree.compressed import CompressedForest
from h2o3_tpu_torch.models.tree.dtree import HostTree, Split, left_table_for
from h2o3_tpu_torch.models.tree.histogram import build_histogram, route_rows
from h2o3_tpu_torch.models.tree.shared_tree import SharedTree, SharedTreeModel


def _avg_path(n: float) -> float:
    """c(n): average unsuccessful-search path length in a BST of n nodes."""
    if n <= 1:
        return 0.0
    h = np.log(n - 1) + 0.5772156649
    return 2.0 * h - 2.0 * (n - 1) / n


class IsolationForestModel(SharedTreeModel):
    algo_name = "isolationforest"

    def _predict_raw(self, frame: Frame):
        total = self._margin(frame)          # summed path lengths
        mean_len = total / self.forest.n_trees
        c = max(self._parms.get("_cnorm", 1.0), 1e-9)
        return {"score": torch.exp2(-mean_len / c), "mean_length": mean_len}


@register
class IsolationForest(SharedTree):
    algo_name = "isolationforest"
    model_class = IsolationForestModel
    supervised = False
    supports_checkpoint = False      # the reference's has no continuation
    supports_iteration_resume = False   # nor durable progress

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({"ntrees": 50, "max_depth": 8, "sample_size": 256,
                  "sample_rate": -1.0, "mtries": -1})
        return p

    def _fit(self, train: Frame) -> IsolationForestModel:
        model = IsolationForestModel(parms=dict(self.params))
        out = self._init_output(model, train)
        out.model_category = ModelCategory.AnomalyDetection
        spec = BinSpec.build(train, out.names,
                             nbins=max(int(self.params["nbins"]), 64),
                             nbins_cats=int(self.params["nbins_cats"]),
                             strategy="uniform")
        model.spec = spec
        binned = spec.bin_columns(train)
        N = binned.shape[0]
        rng = np.random.default_rng(self._seed())

        rate = float(self.params.get("sample_rate", -1.0) or -1.0)
        sample_size = int(self.params.get("sample_size", 256))
        if rate > 0:
            sample_size = max(int(rate * N), 2)
        sample_size = min(sample_size, N)

        max_depth = int(self.params["max_depth"])
        trees: List[HostTree] = []
        ntrees = int(self.params["ntrees"])
        for t in range(ntrees):
            pick = rng.choice(N, size=sample_size, replace=False)
            w = np.zeros(N, np.float32)
            w[pick] = 1.0
            trees.append(self._grow_random_tree(
                binned, torch.as_tensor(w, device=binned.device), spec,
                max_depth, rng))
            if self.job:
                self.job.update(progress=(t + 1) / ntrees, msg=f"tree {t + 1}")
        model._parms["_cnorm"] = _avg_path(sample_size)
        model.forest = CompressedForest.from_host_trees(
            trees, spec, max_depth=max_depth, init_f=0.0, nclasses=1)
        return model

    def _grow_random_tree(self, binned, w, spec, max_depth, rng) -> HostTree:
        """One isolation tree over the rows with w > 0. Every level, the
        final one included, builds a count histogram (it gives the nodes'
        weights); a node with more than one row and a feature with two
        occupied value bins splits at a random bin between them."""
        N = binned.shape[0]
        dev = binned.device
        tree = HostTree()
        row_node = torch.where(w > 0, 0, -1).int()
        row_leaf = torch.full((N,), -1, dtype=torch.int32, device=dev)
        zeros = torch.zeros(N, dtype=torch.float32, device=dev)
        slots = [0]
        mtries = int(self.params.get("mtries", -1) or -1)
        maxB = int(spec.nbins.max())
        for depth in range(max_depth + 1):
            if not slots:
                break
            S = len(slots)
            hist = build_histogram(binned, row_node, w, zeros, spec, S)
            splits = [None] * S
            o0, B0 = int(spec.offsets[0]), int(spec.nbins[0])
            for s in range(S):
                cnt = float(hist[s, o0:o0 + B0, 0].sum())
                tree.nodes[slots[s]].weight = cnt
                if depth == max_depth or cnt <= 1:
                    continue
                # a random feature with > 1 occupied value bin, a few
                # tries; mtries > 0 draws the candidates per node
                pool = (rng.choice(spec.F, size=min(mtries, spec.F),
                                   replace=False) if mtries > 0 else None)
                for _ in range(5):
                    f = (int(rng.choice(pool)) if pool is not None
                         else int(rng.integers(spec.F)))
                    o, B = int(spec.offsets[f]), int(spec.nbins[f])
                    occ = np.nonzero(hist[s, o:o + B - 1, 0] > 0)[0]
                    if len(occ) >= 2:
                        tbin = int(rng.integers(occ[0], occ[-1]))
                        nw = float(hist[s, o:o + tbin + 1, 0].sum())
                        splits[s] = Split(f, bool(spec.is_cat[f]), tbin,
                                          self._cat_bins(spec, f, tbin),
                                          bool(rng.random() < 0.5), 1.0,
                                          (nw, 0.0), (cnt - nw, 0.0))
                        break
            split_feat = np.full(S, -1, np.int32)
            left_slot = np.full(S, -1, np.int32)
            right_slot = np.full(S, -1, np.int32)
            leaf_id = np.full(S, -1, np.int32)
            next_slots = []
            for s, sp in enumerate(splits):
                nid = slots[s]
                node = tree.nodes[nid]
                if sp is None:
                    leaf_id[s] = tree.finalize_leaf(nid, node.weight, 0.0)
                    node.leaf_value = depth + _avg_path(node.weight)
                    continue
                node.split = sp
                split_feat[s] = sp.feat
                node.left = tree.new_node(depth + 1)
                node.right = tree.new_node(depth + 1)
                left_slot[s] = len(next_slots)
                next_slots.append(node.left)
                right_slot[s] = len(next_slots)
                next_slots.append(node.right)
            lt = left_table_for(splits, spec, maxB)
            row_node, row_leaf = route_rows(
                binned, row_node, row_leaf, split_feat=split_feat,
                left_table=lt, left_slot=left_slot, right_slot=right_slot,
                leaf_id=leaf_id)
            slots = next_slots
        return tree

    @staticmethod
    def _cat_bins(spec, f, tbin):
        """A categorical split sends codes 0..tbin left."""
        if not spec.is_cat[f]:
            return None
        left = np.zeros(int(spec.nbins[f]) - 1, bool)
        left[: tbin + 1] = True
        return left
