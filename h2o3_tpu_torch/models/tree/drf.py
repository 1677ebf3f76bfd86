"""DRF: distributed random forest (counterpart of
h2o3_tpu/models/tree/drf.py: `_node_feat_mask_fn` :61,
`DRFModel._margin_to_raw` :77, `DRF` defaults :106, `_mtries` :115,
`_score_on` :122, `_fit_single` :133, `_fit_multinomial` :289).

SharedTree with a row sample per tree (sample_rate 0.632), a fresh
mtries-subset of the features per node, leaf = weighted mean of the raw
response, and the ensemble = the mean over trees: each tree's leaf values
are scaled by 1/trees when the forest is built, so scoring reuses the
summed traversal of GBM. Sampled-out rows keep routing with w = 0, so
their leaves give the out-of-bag (OOB) predictions for free; the
training metrics are OOB, as the reference's. A class response with
more than two levels (or binomial_double_trees) grows one tree per class
per iteration on the class indicator.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core import random as rnd
from h2o3_tpu_torch.models.model import ModelCategory
from h2o3_tpu_torch.models.tree.compressed import CompressedForest
from h2o3_tpu_torch.models.tree.device_tree import (apply_packed,
                                                    assemble_trees,
                                                    build_feat_masks,
                                                    grow_tree_device,
                                                    stash_packed)
from h2o3_tpu_torch.models.tree.shared_tree import (SharedTree,
                                                    SharedTreeModel,
                                                    _leaf_update,
                                                    sample_mask)


def _node_feat_mask_fn(rng, F: int, mtries: int):
    """A fresh random mtries-subset of the features per node: one
    rank-of-randoms draw per level."""

    def fn(S):
        r = rng.random((S, F))
        rank = np.argsort(np.argsort(r, axis=1), axis=1)
        return rank < mtries

    return fn


def _leaf_mean(leaf4):
    ln, ld = leaf4[:, 2], leaf4[:, 3]
    return torch.where(ld > 1e-12, ln / torch.clamp_min(ld, 1e-12),
                       0.0).float()


def _normalised_votes(f):
    p = torch.clamp(f, 0.0, 1.0)
    return p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-12)


class DRFModel(SharedTreeModel):
    algo_name = "drf"

    def _margin_to_raw(self, f):
        # f = the mean leaf response over the trees
        cat = self._output.model_category
        if cat == ModelCategory.Binomial:
            if f.dim() == 2:          # binomial_double_trees: class votes
                return {"probs": _normalised_votes(f)}
            p = torch.clamp(f, 0.0, 1.0)
            return {"probs": torch.stack([1 - p, p], dim=-1)}
        if cat == ModelCategory.Multinomial:
            return {"probs": _normalised_votes(f)}
        return {"value": f}


class DRF(SharedTree):
    algo_name = "drf"
    model_class = DRFModel

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({"ntrees": 50, "max_depth": 20, "min_rows": 1.0,
                  "sample_rate": 0.632, "mtries": -1,
                  "binomial_double_trees": False})
        return p

    def _mtries(self, F: int, classification: bool) -> int:
        m = int(self.params.get("mtries", -1) or -1)
        if m > 0:
            return min(m, F)
        # the reference's defaults: sqrt(p) classification, p/3 regression
        return max(1, int(np.sqrt(F)) if classification else F // 3)

    def _score_on(self, model, frame):
        """Training metrics are OOB: scoring the training frame right
        after the fit uses the accumulated OOB predictions, and rows that
        were never out of bag drop out."""
        oob = getattr(self, "_oob_raw", None)
        if oob is not None and frame is getattr(self, "_train_frame_ref",
                                                None):
            raw, mask = oob
            self._oob_raw = None
            return model._make_metrics(frame, raw, extra_weight=mask)
        return super()._score_on(model, frame)

    def _fit_single(self, model, binned, y, w, offset, spec, dist, rng,
                    ntrees):
        """Bagged trees on the raw response, leaf = weighted mean of y;
        OOB and validation margins on the device."""
        classification = model._output.model_category == ModelCategory.Binomial
        if classification and self.params.get("binomial_double_trees"):
            return self._fit_multinomial(model, binned, y, w, offset, spec,
                                         2, rng, ntrees)
        N = binned.shape[0]
        dev = binned.device
        feat_mask_fn = _node_feat_mask_fn(
            rng, spec.F, self._mtries(spec.F, classification))
        grow = self._grow_args()
        max_depth = grow["max_depth"]
        maxB = int(spec.nbins.max())
        vs = self._vstate
        v_sum = (None if vs is None else
                 torch.zeros(vs["binned"].shape[0], dtype=torch.float32,
                             device=dev))
        oob_sum = torch.zeros(N, dtype=torch.float32, device=dev)
        oob_cnt = torch.zeros(N, dtype=torch.float32, device=dev)
        rate = float(self.params.get("sample_rate", 0.632) or 1.0)
        root_key = rnd.PRNGKey(self._seed())
        history, stop_metric = [], []
        packs, leaf_means, leaf_wys = [], [], []
        mask = None
        for t in range(ntrees):
            if rate < 1.0:
                mask = sample_mask(root_key, t, N, rate, dev)
                w_t = torch.where(mask, w, 0.0)
            else:
                w_t = w
            masks = build_feat_masks(max_depth, feat_mask_fn, spec.F, maxB)
            packed, leaf4, row_leaf = grow_tree_device(
                binned, w_t, y, spec, feat_masks=masks, **grow)
            mean = _leaf_mean(leaf4)
            if mask is not None:
                oob = (~mask) & (w > 0)
                oob_sum = oob_sum + torch.where(
                    oob, _leaf_update(mean, row_leaf), 0.0)
                oob_cnt = oob_cnt + oob.float()
            packs.append(stash_packed(packed, max_depth))
            leaf_means.append(mean)
            leaf_wys.append(leaf4[:, :2])
            if v_sum is not None:
                v_sum = v_sum + apply_packed(vs["binned"], packed, mean,
                                             max_depth, maxB)
            if (mask is not None or v_sum is not None) \
                    and self._should_score(t, ntrees):
                entry = {"tree": t + 1}
                mse = None
                if mask is not None:
                    # running OOB squared error
                    fcur = torch.where(oob_cnt > 0, oob_sum
                                       / torch.clamp_min(oob_cnt, 1.0), 0.0)
                    wm = w * (oob_cnt > 0)
                    mse = float(torch.sum(wm * (y - fcur) ** 2)
                                / torch.clamp_min(torch.sum(wm), 1e-12))
                    entry["training_rmse"] = float(np.sqrt(mse))
                if v_sum is not None:
                    fv = v_sum / (t + 1)
                    if classification:
                        fv = torch.clamp(fv, 0.0, 1.0)
                    vmse = float(torch.sum(vs["w"] * (vs["y"] - fv) ** 2)
                                 / torch.clamp_min(torch.sum(vs["w"]), 1e-12))
                    entry["validation_rmse"] = float(np.sqrt(vmse))
                    stop_metric.append(vmse)
                else:
                    stop_metric.append(mse)
                history.append(entry)
                if self._early_stop(stop_metric):
                    break
            if self._out_of_time():
                break

        # scale by the trees actually grown (early stopping may cut)
        trees = assemble_trees(packs, leaf_means, leaf_wys, spec, max_depth,
                               scale=1.0 / len(packs))
        self._set_varimp(model, trees, history)
        forest = CompressedForest.from_host_trees(
            trees, spec, max_depth=max_depth, init_f=0.0, nclasses=1)
        f = torch.where(oob_cnt > 0, oob_sum / torch.clamp_min(oob_cnt, 1.0),
                        0.0)
        self._oob_raw = None
        if float(torch.max(oob_cnt)) > 0:
            oob_mask = (oob_cnt > 0).float()
            if classification:
                p = torch.clamp(f, 0.0, 1.0)
                self._oob_raw = ({"probs": torch.stack([1 - p, p], dim=-1)},
                                 oob_mask)
            else:
                self._oob_raw = ({"value": f}, oob_mask)
        return forest

    def _fit_multinomial(self, model, binned, y, w, offset, spec, K, rng,
                         ntrees):
        """One tree per class per iteration, voting class-indicator
        means."""
        N = binned.shape[0]
        dev = binned.device
        onehot = torch.nn.functional.one_hot(y.long(), K).float()
        feat_mask_fn = _node_feat_mask_fn(rng, spec.F,
                                          self._mtries(spec.F, True))
        grow = self._grow_args()
        max_depth = grow["max_depth"]
        maxB = int(spec.nbins.max())
        tree_class = []
        oob_sum = torch.zeros(N, K, dtype=torch.float32, device=dev)
        oob_cnt = torch.zeros(N, dtype=torch.float32, device=dev)
        packs, leaf_means, leaf_wys = [], [], []
        for t in range(ntrees):
            mask, w_t = self._sample_rows(rng, N, w)
            for k in range(K):
                masks = build_feat_masks(max_depth, feat_mask_fn, spec.F,
                                         maxB)
                packed, leaf4, row_leaf = grow_tree_device(
                    binned, w_t, onehot[:, k], spec, feat_masks=masks,
                    **grow)
                mean = _leaf_mean(leaf4)
                packs.append(stash_packed(packed, max_depth))
                leaf_means.append(mean)
                leaf_wys.append(leaf4[:, :2])
                tree_class.append(k)
                if mask is not None:
                    oob = (~mask) & (w > 0)
                    oob_sum[:, k] += torch.where(
                        oob, _leaf_update(mean, row_leaf), 0.0)
            if mask is not None:
                oob_cnt = oob_cnt + ((~mask) & (w > 0)).float()
            if self._out_of_time():
                break

        trees = assemble_trees(packs, leaf_means, leaf_wys, spec, max_depth,
                               scale=1.0 / (len(packs) // K))
        self._set_varimp(model, trees, [])
        forest = CompressedForest.from_host_trees(
            trees, spec, tree_class=tree_class, max_depth=max_depth,
            nclasses=K)
        self._oob_raw = None
        if float(torch.max(oob_cnt)) > 0:
            p = _normalised_votes(
                oob_sum / torch.clamp_min(oob_cnt, 1.0)[:, None])
            self._oob_raw = ({"probs": p}, (oob_cnt > 0).float())
        return forest
