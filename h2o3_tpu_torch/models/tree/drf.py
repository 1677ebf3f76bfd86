"""DRF: distributed random forest (counterpart of
h2o3_tpu/models/tree/drf.py: `_node_feat_mask_fn` :61,
`DRFModel._margin_to_raw` :77, `DRF` defaults :106, `_mtries` :115,
`_score_on` :122, `_fit_single` :133, `_fit_multinomial` :289; the
checkpoint rescaling :159-171, :264-277, :364-376).

SharedTree with a row sample per tree (sample_rate 0.632), a fresh
mtries-subset of the features per node, leaf = weighted mean of the raw
response, and the ensemble = the mean over trees: each tree's leaf values
are scaled by 1/trees when the forest is built, so scoring reuses the
summed traversal of GBM. Sampled-out rows keep routing with w = 0, so
their leaves give the out-of-bag (OOB) predictions for free; the
training metrics are OOB, as the reference's. A class response with
more than two levels (or binomial_double_trees) grows one tree per class
per iteration on the class indicator.

A continued forest (checkpoint) keeps its leaves divided by its own tree
count, so the validation sum restarts at its mean times that count, and
the joined forest rescales both parts to their share of the new total.
The out-of-bag sums restart at zero: the bagging masks are not part of
a model, so the continued model's OOB metrics cover the new trees only.

Durable job progress (reference :184-250, :314-355) saves what the
SharedTree loops save plus the OOB sums and counts (and the validation
sum), so a resumed forest and its OOB metrics are the uninterrupted
run's bit for bit; the host Generator carries the per-node mtries draws
and, for per-class trees, the row samples.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core import random as rnd
from h2o3_tpu_torch.core import sharded_frame
from h2o3_tpu_torch.models.model import ModelCategory
from h2o3_tpu_torch.models.model_builder import register
from h2o3_tpu_torch.models.tree.compressed import CompressedForest
from h2o3_tpu_torch.models.tree.device_tree import (apply_packed,
                                                    assemble_trees,
                                                    build_feat_masks,
                                                    grow_tree_device,
                                                    stash_packed)
from h2o3_tpu_torch.models.tree.shared_tree import (SharedTree,
                                                    SharedTreeModel, _device,
                                                    _host, _leaf_update,
                                                    _weighted_mean,
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


def _any_rows(cnt, mesh) -> bool:
    """Whether any row of any rank was out of bag at least once."""
    m = torch.max(cnt).reshape(1).double() if cnt.numel() \
        else torch.zeros(1, dtype=torch.float64, device=cnt.device)
    if mesh is not None:
        mesh.all_reduce(m.contiguous(), "max")
    return float(m[0]) > 0


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


@register
class DRF(SharedTree):
    algo_name = "drf"
    row_sharded = True
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
        t_base = self._ckpt_start(ntrees)
        if vs is None:
            v_sum = None
        elif t_base:
            v_sum = (self._ckpt.forest.predict_binned(vs["binned"]).float()
                     * t_base)
        else:
            v_sum = torch.zeros(vs["binned"].shape[0], dtype=torch.float32,
                                device=dev)
        oob_sum = torch.zeros(N, dtype=torch.float32, device=dev)
        oob_cnt = torch.zeros(N, dtype=torch.float32, device=dev)
        rate = float(self.params.get("sample_rate", 0.632) or 1.0)
        root_key = rnd.PRNGKey(self._seed())
        history, stop_metric = [], []
        packs, leaf_means, leaf_wys = [], [], []
        mask = None
        t_start = t_base
        rs = self._take_resume_state("drf_single")
        if rs is not None:
            # the saved loop state, the OOB sums and the host Generator
            # (the mtries masks) included
            t_start = int(rs["t_done"])
            stop_metric = list(rs["stop_metric"])
            history = [dict(h) for h in rs["history"]]
            packs, leaf_means, leaf_wys = self._load_tree_progress(
                rs, dev, max_depth)
            if self._rows_match(rs):
                oob_sum = _device(rs["oob_sum"], dev)
                oob_cnt = _device(rs["oob_cnt"], dev)
                if v_sum is not None and rs.get("v_sum") is not None:
                    v_sum = _device(rs["v_sum"], dev)
            else:
                # another rank's rows were saved: this rank's sums again,
                # tree by tree as the uninterrupted loop added them
                oob_sum, oob_cnt, v_sum = self._rebuild_oob(
                    binned, w, packs, leaf_means, t_start - len(packs),
                    root_key, rate, oob_sum, oob_cnt, v_sum, max_depth,
                    maxB)
            rng.bit_generator.state = rs["rng_state"]
        jp_every = self._job_ckpt_every()
        for t in range(t_start, ntrees):
            if rate < 1.0:
                mask = sample_mask(root_key, t, N, rate, dev, self._rows)
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
                    mse = _weighted_mean(wm * (y - fcur) ** 2, wm,
                                         self._mesh)
                    entry["training_rmse"] = float(np.sqrt(mse))
                if v_sum is not None:
                    fv = v_sum / (t + 1)
                    if classification:
                        fv = torch.clamp(fv, 0.0, 1.0)
                    vmse = _weighted_mean(
                        vs["w"] * (vs["y"] - fv) ** 2, vs["w"],
                        sharded_frame.mesh_of(self._valid_frame_ref))
                    entry["validation_rmse"] = float(np.sqrt(vmse))
                    stop_metric.append(vmse)
                else:
                    stop_metric.append(mse)
                history.append(entry)
                if self._early_stop(stop_metric):
                    break
            if self._out_of_time():
                break
            if self.job:
                self.job.update(progress=(t + 1) / ntrees, msg=f"tree {t + 1}")
            if jp_every and (t + 1) % jp_every == 0:
                done = t + 1
                self._tick_job_progress(done, lambda: {
                    "phase": "drf_single", "t_done": done,
                    "oob_sum": _host(oob_sum), "oob_cnt": _host(oob_cnt),
                    "v_sum": _host(v_sum), "rows": self._rows,
                    "stop_metric": list(stop_metric),
                    "history": [dict(h) for h in history],
                    **self._tree_progress_ref(packs, leaf_means, leaf_wys),
                    "rng_state": rng.bit_generator.state})

        # scale by the trees actually grown (early stopping may cut)
        total = t_base + len(packs)
        trees = assemble_trees(packs, leaf_means, leaf_wys, spec, max_depth,
                               scale=1.0 / total)
        self._set_varimp(model, trees, history)
        forest = CompressedForest.from_host_trees(
            trees, spec, max_depth=max_depth, init_f=0.0, nclasses=1)
        if t_base:
            forest = CompressedForest.concat(self._ckpt.forest, forest,
                                             scale_a=t_base / total)
        f = torch.where(oob_cnt > 0, oob_sum / torch.clamp_min(oob_cnt, 1.0),
                        0.0)
        self._oob_raw = None
        if _any_rows(oob_cnt, self._mesh):
            oob_mask = (oob_cnt > 0).float()
            if classification:
                p = torch.clamp(f, 0.0, 1.0)
                self._oob_raw = ({"probs": torch.stack([1 - p, p], dim=-1)},
                                 oob_mask)
            else:
                self._oob_raw = ({"value": f}, oob_mask)
        return forest

    def _rebuild_oob(self, binned, w, packs, means, t0, root_key, rate,
                     oob_sum, oob_cnt, v_sum, max_depth, maxB):
        """The out-of-bag sums and counts (and the validation sum) of this
        rank's rows after the loaded trees t0, t0+1, ...: each tree's
        sample drawn again and its leaf means added in the loop's order."""
        N, dev = binned.shape[0], binned.device
        vs = self._vstate
        for i, (p, mean) in enumerate(zip(packs, means)):
            p = p.to(dev)
            if rate < 1.0:
                mask = sample_mask(root_key, t0 + i, N, rate, dev,
                                   self._rows)
                oob = (~mask) & (w > 0)
                oob_sum = oob_sum + torch.where(
                    oob, apply_packed(binned, p, mean, max_depth, maxB), 0.0)
                oob_cnt = oob_cnt + oob.float()
            if v_sum is not None:
                v_sum = v_sum + apply_packed(vs["binned"], p, mean,
                                             max_depth, maxB)
        return oob_sum, oob_cnt, v_sum

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
        t_base = self._ckpt_start(ntrees, per_iter=K)
        oob_sum = torch.zeros(N, K, dtype=torch.float32, device=dev)
        oob_cnt = torch.zeros(N, dtype=torch.float32, device=dev)
        packs, leaf_means, leaf_wys = [], [], []
        t_start = t_base
        rs = self._take_resume_state("drf_multi")
        if rs is not None:
            # the saved loop state, as in _fit_single
            t_start = int(rs["t_done"])
            oob_sum = _device(rs["oob_sum"], dev)
            oob_cnt = _device(rs["oob_cnt"], dev)
            tree_class = list(rs["tree_class"])
            packs, leaf_means, leaf_wys = self._load_tree_progress(
                rs, dev, max_depth)
            rng.bit_generator.state = rs["rng_state"]
        jp_every = self._job_ckpt_every()
        for t in range(t_start, ntrees):
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
            if self.job:
                self.job.update(progress=(t + 1) / ntrees, msg=f"iter {t + 1}")
            if jp_every and (t + 1) % jp_every == 0:
                done = t + 1
                self._tick_job_progress(done, lambda: {
                    "phase": "drf_multi", "t_done": done,
                    "oob_sum": _host(oob_sum), "oob_cnt": _host(oob_cnt),
                    "tree_class": list(tree_class),
                    **self._tree_progress_ref(packs, leaf_means, leaf_wys),
                    "rng_state": rng.bit_generator.state})

        total = t_base + len(packs) // K
        trees = assemble_trees(packs, leaf_means, leaf_wys, spec, max_depth,
                               scale=1.0 / total)
        self._set_varimp(model, trees, [])
        forest = CompressedForest.from_host_trees(
            trees, spec, tree_class=tree_class, max_depth=max_depth,
            nclasses=K)
        if t_base:
            forest = CompressedForest.concat(self._ckpt.forest, forest,
                                             scale_a=t_base / total)
        self._oob_raw = None
        if _any_rows(oob_cnt, self._mesh):
            p = _normalised_votes(
                oob_sum / torch.clamp_min(oob_cnt, 1.0)[:, None])
            self._oob_raw = ({"probs": p}, (oob_cnt > 0).float())
        return forest
