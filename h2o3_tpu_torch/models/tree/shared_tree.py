"""SharedTree: the fit loops GBM and DRF share (counterpart of
h2o3_tpu/models/tree/shared_tree.py: `_pre_fn` :41, `_post_fn` :71,
`grow_tree` :104, `SharedTreeModel._margin_to_raw` :210, the leaf hooks
:265-294, `_fit` :364, `_fit_single` :471, `_fit_multinomial` :625,
`_sample_rows` :816, `_feat_mask_fn` :825, `_should_score`/`_early_stop`
:848-865; checkpoints `_ckpt_start`/`_ckpt_varimp0` :343-361 and
`_finalize_varimp` :875; `predict_leaf_node_assignment` :134).

Per tree: residuals and leaf Newton-step rows (`_pre`, with the row
sample of sample_rate < 1), one device-grown tree (device_tree.
grow_tree_device, with per-level column-sampling masks), leaf gammas and
the margin update (`_post`). A multinomial response grows K trees per
iteration, one per class. With a validation frame the loop keeps the
validation margins on the device (device_tree.apply_packed), records a
scoring history and stops early when the validation metric stalls.
Every per-tree table stays on the device (deep ones on the host) until
one transfer at the end of training.

Row samples come from core/random.py (the reference's jax.random stream,
bit for bit); column masks come from a host numpy Generator seeded as
the reference seeds it, and are drawn in the reference's order.

A checkpoint model continues: its BinSpec bins the frame, its forest's
margins are where boosting restarts, the tree index t (and so every
row-sample key and the learning-rate annealing) runs on from its tree
count, the host Generator is seeded with (seed, its tree count), split
gains accumulate onto its raw importances, and the new trees append to
its forest (`CompressedForest.concat`).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core import random as rnd
from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.core.ops import segment_sum
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.distribution import (auto_distribution,
                                                get_distribution)
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder
from h2o3_tpu_torch.models.tree.binning import BinSpec, pad_rows
from h2o3_tpu_torch.models.tree.compressed import (CompressedForest,
                                                   _fused_margins)
from h2o3_tpu_torch.models.tree.device_tree import (apply_packed,
                                                    assemble_trees,
                                                    build_feat_masks,
                                                    grow_tree_device,
                                                    stash_packed)


def grow_tree(binned, hist_w, hist_y, spec, *, max_depth: int,
              min_rows: float, min_split_improvement: float,
              row_active=None, feat_mask_fn=None):
    """Public single-tree API: (HostTree with dense leaf ids, row_leaf),
    from the level-wise grower (host_grow.grow_tree_host), which is safe
    at any depth. The fit loops use the single-dispatch device grower
    (device_tree.grow_tree_device) directly."""
    from h2o3_tpu_torch.models.tree.host_grow import grow_tree_host

    return grow_tree_host(binned, hist_w, hist_y, spec, max_depth=max_depth,
                          min_rows=min_rows,
                          min_split_improvement=min_split_improvement,
                          row_active=row_active, feat_mask_fn=feat_mask_fn)


def sample_mask(root_key, t: int, n: int, rate: float, device):
    """Tree t's row sample: uniform(fold_in(root_key, t)) < rate over the
    rows (the reference's `_pre_fn` draw)."""
    return rnd.uniform(rnd.fold_in(root_key, t), n, device=device) < rate


def sampled_weights(w, root_key, t: int, rate: float):
    """w with tree t's sampled-out rows at 0 (w itself at rate >= 1)."""
    if rate >= 1.0:
        return w
    return torch.where(sample_mask(root_key, t, len(w), rate, w.device), w,
                       0.0)


def softmax(f: torch.Tensor) -> torch.Tensor:
    """Row softmax written as the reference's (exp of the max-shifted
    margins over their sum)."""
    e = torch.exp(f - torch.amax(f, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def _offset(frame: Frame, name: Optional[str], n: int, device):
    if name and name in frame:
        oc = frame.col(name).data.float()
        return torch.where(torch.isnan(oc), 0.0, oc)
    return torch.zeros(n, dtype=torch.float32, device=device)


class SharedTreeModel(Model):
    """Trained forest; scoring bins the adapted frame with the training
    BinSpec and walks the forest."""

    def __init__(self, parms=None):
        super().__init__(parms=parms)
        self.forest: Optional[CompressedForest] = None
        self.spec: Optional[BinSpec] = None
        self._distribution = None

    def _margin(self, frame: Frame) -> torch.Tensor:
        """(N,) or (N, K) margins of the adapted frame: raw features
        binned with the training edges and walked through the forest in
        one pass."""
        spec = self.spec
        X = torch.stack([frame.col(n).data.float() for n in spec.names],
                        dim=1)
        dev = X.device
        return _fused_margins(
            X, torch.as_tensor(spec.padded_edges(), device=dev),
            torch.as_tensor(spec.is_cat, device=dev), self.forest)

    def _predict_raw(self, frame: Frame):
        return self._margin_to_raw(self._margin(frame))

    def predict_leaf_node_assignment(self, frame: Frame,
                                     type: str = "Path") -> Frame:
        """Each row's leaf in each tree: 'Path', the L/R walk from the
        root as an enum ("(root)" for a stump), or 'Node_ID', the leaf's
        node index. One column per tree, T<t> (T<g>.C<k> for per-class
        forests). Leaves come from the training BinSpec's bins and the
        forest's lockstep walk, the same walk scoring sums over."""
        if type not in ("Path", "Node_ID"):
            raise ValueError(f"leaf assignment type {type!r} "
                             "(Path or Node_ID)")
        adapted = self.adapt_test(frame)
        dev = adapted.col(adapted.names[0]).data.device
        leaf = self.forest.leaf_index(
            self.spec.bin_columns(adapted)).cpu().numpy()
        fo = self.forest
        tcls = np.asarray(fo.tree_class)
        per_class = fo.per_class_trees
        counters: dict = {}
        out = Frame()
        for t in range(fo.n_trees):
            if per_class:
                k = int(tcls[t])
                g = counters.get(k, 0)
                counters[k] = g + 1
                name = f"T{g + 1}.C{k + 1}"
            else:
                name = f"T{t + 1}"
            if type == "Node_ID":
                out.add(name, Column.from_numpy(leaf[:, t].astype(np.int32),
                                                device=dev))
                continue
            out.add(name, _path_column(fo, t, leaf[:, t], dev))
        return out

    def _margin_to_raw(self, f):
        """Margins -> raw prediction dict (pure margin math)."""
        cat = self._output.model_category
        if cat == ModelCategory.Binomial:
            p = self._distribution.linkinv(f)
            return {"probs": torch.stack([1 - p, p], dim=-1)}
        if cat == ModelCategory.Multinomial:
            return {"probs": softmax(f)}
        if cat == ModelCategory.AnomalyDetection:
            return {"score": f}
        if self._distribution is not None:
            return {"value": self._distribution.linkinv(f)}
        return {"value": f}


class SharedTree(ModelBuilder):
    """Base tree builder: binning, sampling, the fit loops, scoring
    history, early stopping and variable importances."""

    model_class = SharedTreeModel
    supports_checkpoint = True

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({"ntrees": 50, "max_depth": 5, "min_rows": 10.0,
                  "nbins": 20, "nbins_cats": 1024,
                  "min_split_improvement": 1e-5,
                  "sample_rate": 1.0, "col_sample_rate_per_tree": 1.0,
                  "score_each_iteration": False, "score_tree_interval": 0,
                  "calibrate_model": False, "calibration_frame": None,
                  "calibration_method": "AUTO",
                  "distribution": "AUTO", "tweedie_power": 1.5,
                  "quantile_alpha": 0.5,
                  # accepted as in the reference, whose huber keeps delta
                  # 1 and never reads it (shared_tree.py:377)
                  "huber_alpha": 0.9})
        return p

    # subclass hooks -------------------------------------------------------
    def _leaf_num_den(self, w, y, z, f, dist):
        """(num, den) rows of the leaf Newton step."""
        return dist.gamma_num(w, y, z, f), dist.gamma_denom(w, y, z, f)

    def _tree_lr(self, t: int) -> float:
        """Shrinkage applied to tree t's leaves."""
        return 1.0

    def _leaf_clip(self) -> float:
        """Leaf-value bound: max_abs_leafnode_pred when set, else a
        numeric-safety bound."""
        clip = float(self.params.get("max_abs_leafnode_pred", 1e30) or 1e30)
        return clip if clip < 1e30 else 1e4

    def _leaf_den_offset(self) -> float:
        """Additive leaf-denominator regularizer (XGBoost's lambda); 0 for
        GBM and DRF."""
        return 0.0

    def _leaf_gamma(self, ln, ld):
        """Leaf Newton step from the per-leaf (num, den) sums."""
        return torch.where(
            ld > 1e-12,
            ln / torch.clamp_min(ld + self._leaf_den_offset(), 1e-12), 0.0)

    # per-tree steps ---------------------------------------------------------
    def _pre(self, dist, y, f, w, root_key, t: int, rate: float):
        """-> (z, w_t, num, den): residuals, tree t's sampled weights and
        the leaf Newton-step rows."""
        z = dist.neg_half_gradient(y, f)
        w_t = sampled_weights(w, root_key, t, rate)
        num, den = self._leaf_num_den(w_t, y, z, f, dist)
        return z, w_t, num, den

    def _post(self, leaf4, row_leaf, lr: float, clip: float):
        """-> (gamma, contrib): leaf steps, clipped and shrunk by the
        learning rate, and each row's leaf step."""
        gamma = self._leaf_gamma(leaf4[:, 2], leaf4[:, 3])
        gamma = (torch.clamp(gamma, -clip, clip) * lr).float()
        return gamma, _leaf_update(gamma, row_leaf)

    def _tree_margin(self, rng, t: int, f):
        """-> (f_used, lr, keys): the margin tree t is grown against, the
        shrinkage of its leaves and extra scoring-history keys. Called
        before the tree's column masks are drawn; XGBoost's dart drops
        earlier trees here."""
        return f, self._tree_lr(t), {}

    def _add_tree(self, f_used, f_valid, contrib, vcontrib, leaf_vals):
        """-> (f, f_valid): the training and validation margins after
        the new tree's contributions (f_valid None without a validation
        frame). leaf_vals holds the earlier trees' leaf values."""
        return f_used + contrib, (None if f_valid is None
                                  else f_valid + vcontrib)

    # checkpoints -----------------------------------------------------------
    def _ckpt_start(self, ntrees: int, per_iter: int = 1) -> int:
        """Iterations the checkpoint forest already holds (0 when training
        fresh); ntrees is the total and must exceed them."""
        prev = getattr(self, "_ckpt", None)
        if prev is None:
            return 0
        done = prev.forest.n_trees // per_iter
        if ntrees <= done:
            raise ValueError(
                f"checkpoint model already has {done} iterations; ntrees "
                f"({ntrees}) must be greater")
        return done

    def _ckpt_varimp0(self) -> Dict[str, float]:
        """The checkpoint model's raw (unnormalised) importances, where
        split gains go on accumulating."""
        prev = getattr(self, "_ckpt", None)
        return dict(getattr(prev, "_varimp_raw", {}) or {}) if prev else {}

    # fit loops -------------------------------------------------------------
    def _fit(self, train: Frame) -> SharedTreeModel:
        model = self.model_class(parms=dict(self.params))
        out = self._init_output(model, train)
        resp = self.params["response_column"]
        y_col = train.col(resp)
        nclasses = out.nclasses
        dist_name = (self.params.get("distribution") or "AUTO").lower()
        if dist_name == "auto":
            dist_name = auto_distribution(y_col.ctype, nclasses)
        multinomial = dist_name == "multinomial"
        dist = get_distribution(
            dist_name, tweedie_power=float(self.params["tweedie_power"]),
            quantile_alpha=float(self.params["quantile_alpha"]))
        model._distribution = dist
        prev = self._resolve_checkpoint()
        if prev is not None:
            if not isinstance(prev, SharedTreeModel) or prev.forest is None:
                raise ValueError("checkpoint model has no forest to continue")
            if prev._output.names != out.names \
                    or prev._output.domains != out.domains:
                raise ValueError(
                    "checkpoint: training frame columns/domains differ from "
                    f"the original run ({prev._output.names} vs {out.names})")
            spec = prev.spec
        else:
            spec = BinSpec.build(train, out.names,
                                 nbins=int(self.params["nbins"]),
                                 nbins_cats=int(self.params["nbins_cats"]))
        self._ckpt = prev
        model.spec = spec
        binned = spec.bin_columns(train)
        N = binned.shape[0]
        w_user = None
        if self.params.get("weights_column"):
            w_user = train.col(self.params["weights_column"]).data
        w = DataInfo.response_weight(y_col.data, w_user)
        y = DataInfo.clean_response(y_col.data).float()
        offset = _offset(train, self.params.get("offset_column"), N,
                         binned.device)
        # a continued run seeds its host draws with (seed, trees done):
        # the bare seed would replay the original run's draws
        rng = (np.random.default_rng([self._seed(), prev.forest.n_trees])
               if prev is not None else np.random.default_rng(self._seed()))
        ntrees = int(self.params["ntrees"])
        self._train_frame_ref = train      # OOB metric routing (DRF)
        self._vstate = self._validation_state(model, spec)
        t0 = time.time()
        try:
            if multinomial:
                model.forest = self._fit_multinomial(
                    model, binned, y, w, offset, spec, nclasses, rng, ntrees)
            else:
                model.forest = self._fit_single(
                    model, binned, y, w, offset, spec, dist, rng, ntrees)
        finally:
            self._vstate = None
            self._ckpt = None
        model._output.run_time_ms = int((time.time() - t0) * 1000)
        return model

    def _validation_state(self, model, spec):
        """The validation frame binned with the training edges, its
        response, weights and offset, on the device; None unless a
        validation frame holds the response and intermediate scores are
        observable (stopping or per-iteration scoring)."""
        valid = getattr(self, "_valid_frame_ref", None)
        resp = self.params["response_column"]
        wants_scores = bool(self.params.get("stopping_rounds")
                            or self.params.get("score_each_iteration")
                            or self.params.get("score_tree_interval"))
        if valid is None or not wants_scores or resp not in valid:
            return None
        yv_col = model._adapt_response(valid.col(resp))
        wname = self.params.get("weights_column")
        wv_user = valid.col(wname).data if wname and wname in valid else None
        binned_v = spec.bin_columns(model.adapt_test(valid))
        return {"binned": binned_v,
                "y": DataInfo.clean_response(yv_col.data).float(),
                "w": DataInfo.response_weight(yv_col.data, wv_user),
                "offset": _offset(valid, self.params.get("offset_column"),
                                  binned_v.shape[0], binned_v.device)}

    def _grow_args(self):
        return dict(max_depth=int(self.params["max_depth"]),
                    min_rows=float(self.params["min_rows"]),
                    min_split_improvement=float(
                        self.params["min_split_improvement"]))

    # single-margin families -------------------------------------------------
    def _fit_single(self, model, binned, y, w, offset, spec, dist, rng,
                    ntrees):
        """Boosting loop for the single-margin families; returns the
        forest."""
        N = binned.shape[0]
        t_base = self._ckpt_start(ntrees)
        if t_base:
            # continued: margins restart from the checkpoint forest's
            pf = self._ckpt.forest
            init_f = pf.init_f
            f = pf.predict_binned(binned) + offset
        else:
            num = float(torch.sum(dist.init_f_num(w, y, offset)))
            den = float(torch.sum(dist.init_f_denom(w, y, offset)))
            init_f = float(dist.link(torch.tensor(num / max(den, 1e-12),
                                                  dtype=torch.float32)))
            if dist.name in ("bernoulli", "quasibinomial"):
                # only the log-odds prior is clamped
                init_f = float(np.clip(init_f, -19, 19))
            f = torch.full((N,), init_f, dtype=torch.float32,
                           device=binned.device) + offset

        clip = self._leaf_clip()
        grow = self._grow_args()
        max_depth = grow["max_depth"]
        maxB = int(spec.nbins.max())
        vs = self._vstate
        if vs is None:
            f_valid = None
        elif t_base:
            f_valid = (self._ckpt.forest.predict_binned(vs["binned"])
                       + vs["offset"])
        else:
            f_valid = init_f + vs["offset"]
        rate = float(self.params.get("sample_rate", 1.0) or 1.0)
        root_key = rnd.PRNGKey(self._seed())
        history, stop_metric = [], []
        packs, leaf_vals, leaf_wys = [], [], []
        for t in range(t_base, ntrees):
            f_used, lr, keys = self._tree_margin(rng, t, f)
            z, w_t, num_r, den_r = self._pre(dist, y, f_used, w, root_key, t,
                                             rate)
            masks = build_feat_masks(max_depth, self._feat_mask_fn(rng, spec),
                                     spec.F, maxB)
            packed, leaf4, row_leaf = grow_tree_device(
                binned, w_t, z, spec, num=num_r, den=den_r,
                feat_masks=masks, **grow)
            gamma, contrib = self._post(leaf4, row_leaf, lr, clip)
            vcontrib = (None if vs is None else
                        apply_packed(vs["binned"], packed, gamma, max_depth,
                                     maxB))
            f, f_valid = self._add_tree(f_used, f_valid, contrib, vcontrib,
                                        leaf_vals)
            packs.append(stash_packed(packed, max_depth))
            leaf_vals.append(gamma)
            leaf_wys.append(leaf4[:, :2])
            if self._should_score(t, ntrees):
                dev = _mean_deviance(dist, w, y, f)
                entry = {"tree": t + 1, "training_deviance": dev, **keys}
                if f_valid is not None:
                    vdev = _mean_deviance(dist, vs["w"], vs["y"], f_valid)
                    entry["validation_deviance"] = vdev
                    stop_metric.append(vdev)
                else:
                    stop_metric.append(dev)
                history.append(entry)
                if self._early_stop(stop_metric):
                    break
            if self._out_of_time():
                break

        trees = assemble_trees(packs, leaf_vals, leaf_wys, spec, max_depth)
        self._set_varimp(model, trees, history)
        forest = CompressedForest.from_host_trees(
            trees, spec, max_depth=max_depth, init_f=init_f, nclasses=1)
        if t_base:
            forest = CompressedForest.concat(self._ckpt.forest, forest)
        return forest

    # multinomial: K trees per iteration -------------------------------------
    def _fit_multinomial(self, model, binned, y, w, offset, spec, K, rng,
                         ntrees):
        N = binned.shape[0]
        dev = binned.device
        yi = y.long()
        vs = self._vstate
        t_base = self._ckpt_start(ntrees, per_iter=K)
        if t_base:
            pf = self._ckpt.forest
            init = np.asarray(pf.init_class, np.float32)
            f = pf.predict_binned(binned).float()
            f_valid = (None if vs is None else
                       pf.predict_binned(vs["binned"]).float())
        else:
            # init: log class priors
            pri = segment_sum(yi, w, K).cpu().numpy()     # class weights
            pri = np.maximum(pri / max(pri.sum(), 1e-12), 1e-9)
            init = np.log(pri).astype(np.float32)
            init_t = torch.as_tensor(init, device=dev)
            f = init_t.expand(N, K).clone()
            f_valid = (None if vs is None else
                       init_t.expand(vs["binned"].shape[0], K).clone())

        clip = self._leaf_clip()
        grow = self._grow_args()
        max_depth = grow["max_depth"]
        maxB = int(spec.nbins.max())
        onehot = torch.nn.functional.one_hot(yi, K).float()
        root_key = rnd.PRNGKey(self._seed())
        rate = float(self.params.get("sample_rate", 1.0) or 1.0)
        tree_class, history, stop_metric = [], [], []
        packs, leaf_vals, leaf_wys = [], [], []
        for t in range(t_base, ntrees):
            masks = build_feat_masks(max_depth, self._feat_mask_fn(rng, spec),
                                     spec.F, maxB)
            w_t = sampled_weights(w, root_key, t, rate)
            lr = self._tree_lr(t)
            for k in range(K):
                # multinomial leaf step: (K-1)/K * sum z / sum |z|(1-|z|)
                z = onehot[:, k] - softmax(f)[:, k]
                az = torch.abs(z)
                packed, leaf4, row_leaf = grow_tree_device(
                    binned, w_t, z, spec, num=w_t * z,
                    den=w_t * az * (1 - az), feat_masks=masks, **grow)
                ln, ld = leaf4[:, 2], leaf4[:, 3]
                gamma = torch.where(
                    ld > 1e-12, (K - 1) / K * ln / torch.clamp_min(ld, 1e-12),
                    0.0)
                gamma = (torch.clamp(gamma, -clip, clip) * lr).float()
                f[:, k] += _leaf_update(gamma, row_leaf)
                packs.append(stash_packed(packed, max_depth))
                leaf_vals.append(gamma)
                leaf_wys.append(leaf4[:, :2])
                tree_class.append(k)
                if f_valid is not None:
                    f_valid[:, k] += apply_packed(vs["binned"], packed, gamma,
                                                  max_depth, maxB)
            if self._should_score(t, ntrees):
                ll = _mean_logloss(f, yi, w)
                entry = {"tree": t + 1, "training_logloss": ll}
                if f_valid is not None:
                    vll = _mean_logloss(f_valid,
                                        torch.clamp_min(vs["y"].long(), 0),
                                        vs["w"])
                    entry["validation_logloss"] = vll
                    stop_metric.append(vll)
                else:
                    stop_metric.append(ll)
                history.append(entry)
                if self._early_stop(stop_metric):
                    break
            if self._out_of_time():
                break

        trees = assemble_trees(packs, leaf_vals, leaf_wys, spec, max_depth)
        self._set_varimp(model, trees, history)
        forest = CompressedForest.from_host_trees(
            trees, spec, tree_class=tree_class, max_depth=max_depth,
            init_f=0.0, nclasses=K)
        forest.init_class = init          # added per class at scoring
        if t_base:
            forest = CompressedForest.concat(self._ckpt.forest, forest)
        return forest

    # sampling ---------------------------------------------------------------
    def _sample_rows(self, rng, N, w):
        """Host-drawn row sample (DRF's per-class trees): the reference
        draws one uniform per row of its padded column."""
        rate = float(self.params.get("sample_rate", 1.0))
        if rate >= 1.0:
            return None, w
        mask = torch.as_tensor(rng.random(pad_rows(N))[:N] < rate,
                               device=w.device)
        return mask, torch.where(mask, w, 0.0)

    def _feat_mask_fn(self, rng, spec):
        """Per-tree column sampling (col_sample_rate_per_tree) combined
        with per-node sampling (col_sample_rate)."""
        tree_rate = float(self.params.get("col_sample_rate_per_tree", 1.0))
        node_rate = float(self.params.get("col_sample_rate", 1.0))
        if tree_rate >= 1.0 and node_rate >= 1.0:
            return None
        keep = rng.random(spec.F) < tree_rate if tree_rate < 1.0 \
            else np.ones(spec.F, bool)
        if not keep.any():
            keep[rng.integers(spec.F)] = True

        def fn(S):
            mask = np.broadcast_to(keep, (S, spec.F)).copy()
            if node_rate < 1.0:
                mask &= rng.random((S, spec.F)) < node_rate
                for s in np.nonzero(~mask.any(axis=1))[0]:
                    mask[s, rng.choice(np.nonzero(keep)[0])] = True
            return mask

        return fn

    # scoring cadence / early stop -------------------------------------------
    def _should_score(self, t: int, ntrees: int) -> bool:
        if t == ntrees - 1 or self.params.get("score_each_iteration"):
            return True
        interval = int(self.params.get("score_tree_interval") or 0)
        if interval > 0:
            return (t + 1) % interval == 0
        return bool(self.params.get("stopping_rounds"))

    def _early_stop(self, series: List[float]) -> bool:
        """The mean of the last k scores must improve on the mean of the
        k before by stopping_tolerance (relative), else stop."""
        k = int(self.params.get("stopping_rounds") or 0)
        if k <= 0 or len(series) < 2 * k:
            return False
        tol = float(self.params.get("stopping_tolerance") or 1e-3)
        recent = np.mean(series[-k:])
        prev = np.mean(series[-2 * k:-k])
        return recent >= prev * (1 - tol)

    # varimp -----------------------------------------------------------------
    def _set_varimp(self, model, trees, history) -> None:
        """Split gains summed by feature onto the checkpoint's, kept raw
        (`_varimp_raw`, what a continuation starts from) and normalised
        to a maximum of 1."""
        varimp: Dict[str, float] = self._ckpt_varimp0()
        names = model._output.names
        for tree in trees:
            for n in tree.nodes:
                if n.split is not None:
                    nm = names[n.split.feat]
                    varimp[nm] = varimp.get(nm, 0.0) + max(n.split.gain, 0.0)
        model._output.scoring_history = history
        model._varimp_raw = dict(varimp)
        if varimp:
            top = max(varimp.values()) or 1.0
            model._output.variable_importances = {
                k: v / top for k, v in sorted(varimp.items(),
                                              key=lambda kv: -kv[1])}


def _path_column(fo, t: int, leaf: np.ndarray, dev) -> Column:
    """Tree t's root-to-leaf L/R walks as an enum column: the domain is
    the sorted walks of the leaves some row reached ("(root)" for a
    stump), as interning the strings would make it, built per leaf and
    gathered, not per row."""
    feat, left, right = (np.asarray(a[t]) for a in (fo.feat, fo.left,
                                                    fo.right))
    paths = [""] * feat.shape[0]
    stack = [(0, "")]
    while stack:
        node, prefix = stack.pop()
        paths[node] = prefix
        if feat[node] >= 0:
            stack.append((int(right[node]), prefix + "R"))
            stack.append((int(left[node]), prefix + "L"))
    reached = np.unique(leaf)
    names = [paths[i] or "(root)" for i in reached]
    order = sorted(range(len(names)), key=names.__getitem__)
    lut = np.zeros(feat.shape[0], np.int32)
    lut[reached[order]] = np.arange(len(order), dtype=np.int32)
    return Column.from_numpy(lut[leaf], ctype="enum",
                             domain=[names[i] for i in order], device=dev)


def _leaf_update(vals, row_leaf):
    """Each row's leaf value (0 for rows in no leaf)."""
    return torch.where(row_leaf >= 0,
                       vals[torch.clamp_min(row_leaf, 0).long()], 0.0)


def _mean_deviance(dist, w, y, f) -> float:
    return float(torch.sum(dist.deviance(w, y, f))
                 / torch.clamp_min(torch.sum(w), 1e-12))


def _mean_logloss(f, yi, w) -> float:
    p = softmax(f)[torch.arange(f.shape[0], device=f.device), yi]
    return float(torch.sum(-w * torch.log(torch.clamp_min(p, 1e-15)))
                 / torch.clamp_min(torch.sum(w), 1e-12))
