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

Durable job progress (reference :242, :300-340, :528-607, :712-790):
every ``H2O_TPU_JOB_CKPT_ITERS`` iterations a loop saves the margins
(training and validation), the trees grown since the last save as one
append-only chunk (`_tree_progress_ref`), the scoring history and the
host Generator's `bit_generator.state`. Row samples need no state: tree
t's is keyed by fold_in(root_key, t). A resumed loop puts the margins
back on the frame's device with their dtype and continues at the saved
tree, so its forest is the uninterrupted run's bit for bit.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core import random as rnd
from h2o3_tpu_torch.core import sharded_frame
from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.core.ops import fixed_point_sums, segment_sum
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.distribution import (auto_distribution,
                                                get_distribution)
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder
from h2o3_tpu_torch.models.tree.binning import BinSpec, pad_rows
from h2o3_tpu_torch.models.tree.compressed import (CompressedForest,
                                                   ResidentForest)
from h2o3_tpu_torch.models.tree.device_tree import (apply_packed,
                                                    assemble_trees,
                                                    build_feat_masks,
                                                    grow_tree_device,
                                                    stash_packed)
from h2o3_tpu_torch.obs import metrics as obs_metrics


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


def sample_mask(root_key, t: int, n: int, rate: float, device, rows=None):
    """Tree t's row sample: uniform(fold_in(root_key, t)) < rate over the
    rows (the reference's `_pre_fn` draw). `rows` = (lo, hi, n_global)
    draws over the global rows and keeps [lo, hi)."""
    if rows is None:
        return rnd.uniform(rnd.fold_in(root_key, t), n, device=device) < rate
    lo, hi, ng = rows
    u = rnd.uniform(rnd.fold_in(root_key, t), ng, device=device)
    return u[lo:hi] < rate


def sampled_weights(w, root_key, t: int, rate: float, rows=None):
    """w with tree t's sampled-out rows at 0 (w itself at rate >= 1)."""
    if rate >= 1.0:
        return w
    return torch.where(sample_mask(root_key, t, len(w), rate, w.device,
                                   rows), w, 0.0)


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

    def _features(self, frame: Frame) -> torch.Tensor:
        """(N, F) float32 features of the adapted frame in training-column
        order, on its device: numerics as they are (NaN = NA),
        categoricals as their codes (NA negative)."""
        return torch.stack([frame.col(n).data.float()
                            for n in self.spec.names], dim=1)

    def _margin(self, frame: Frame) -> torch.Tensor:
        """(N,) or (N, K) margins of the adapted frame: raw features
        binned with the training edges and walked through the forest in
        one pass (compressed.score_core, the program the scoring
        sessions capture)."""
        X = self._features(frame)
        return ResidentForest(self.forest, self.spec, X.device).margins(X)

    def _predict_raw(self, frame: Frame):
        return self._margin_to_raw(self._margin(frame))

    def predict_leaf_node_assignment(self, frame: Frame,
                                     type: str = "Path") -> Frame:
        """Each row's leaf in each tree: 'Path', the L/R walk from the
        root as an enum ("(root)" for a stump), or 'Node_ID', the leaf's
        node index. One column per tree, T<t> (T<g>.C<k> for per-class
        forests). Leaves come from the training BinSpec's bins and the
        forest's lockstep walk, the same walk scoring sums over. On a
        row-sharded frame each rank walks its own rows and the result is
        sharded as its input; a Path domain is the leaves some row of
        any rank reached (one all-reduce for the forest)."""
        if type not in ("Path", "Node_ID"):
            raise ValueError(f"leaf assignment type {type!r} "
                             "(Path or Node_ID)")
        adapted = self.adapt_test(frame)
        dev = adapted.col(adapted.names[0]).data.device
        leaf = _leaf_matrix(self, adapted, frame.local_rows)
        fo = self.forest
        n = frame.nrows
        tcls = np.asarray(fo.tree_class)
        per_class = fo.per_class_trees
        reached = None
        if type == "Path":
            reached = np.zeros(np.asarray(fo.feat).shape, np.int32)
            for t in range(fo.n_trees):
                reached[t, np.unique(leaf[:, t])] = 1
            mesh = sharded_frame.sharded_mesh(frame)
            if mesh is not None:
                reached = mesh.all_reduce(torch.from_numpy(reached),
                                          "max").numpy()
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
                out.add(name, sharded_frame.block_column(
                    leaf[:, t].astype(np.int32), n, device=dev))
                continue
            out.add(name, _path_column(fo, t, leaf[:, t],
                                       np.nonzero(reached[t])[0], n, dev))
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
    supports_iteration_resume = True

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
        w_t = sampled_weights(w, root_key, t, rate,
                              getattr(self, "_rows", None))
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

    # durable progress -------------------------------------------------------
    def _tree_progress_ref(self, packs, leaf_vals, leaf_wys) -> Dict:
        """The per-tree part of a progress state: the trees grown since
        the last save go to one new chunk (one host copy per list), and
        the state lists every chunk's path. Called only while a save
        happens."""
        from h2o3_tpu_torch.parallel import ckpt

        saved = getattr(self, "_jp_entries", 0)
        chunks = list(getattr(self, "_jp_chunks", []))
        if len(packs) > saved:
            new = [list(torch.stack(lst[saved:]).cpu().numpy())
                   for lst in (packs, leaf_vals, leaf_wys)]
            chunks.append(ckpt.append_job_tree_chunk(
                str(self._progress_job.key), len(chunks), *new))
            self._jp_chunks = chunks
            self._jp_entries = len(packs)
        return {"tree_chunks": chunks, "n_tree_entries": len(packs)}

    def _load_tree_progress(self, rs: Dict, device, max_depth: int):
        """(packs, leaf values, leaf (w, w·y)) of a progress state, on
        `device` (deep tables on the host, as `stash_packed` keeps them);
        later saves append after the loaded chunks. A missing or torn
        chunk, or a count that disagrees with the state, raises."""
        from h2o3_tpu_torch.parallel import ckpt

        packs, lv, lw = ckpt.load_job_tree_chunks(rs["tree_chunks"])
        n = int(rs["n_tree_entries"])
        if len(packs) != n:
            raise RuntimeError(
                f"tree-progress chunks hold {len(packs)} trees but the "
                f"state expects {n}: the durable progress is torn")
        self._jp_chunks = list(rs["tree_chunks"])
        self._jp_entries = n

        def put(arrs):
            if not arrs:
                return []
            return list(torch.from_numpy(np.stack(arrs)).to(device).unbind(0))

        return ([stash_packed(p, max_depth) for p in put(packs)], put(lv),
                put(lw))

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
        # the row mesh the frame is sharded over (None in one process):
        # collectives take it, per-row draws take the global rows
        self._mesh = sharded_frame.mesh_of(train)
        self._rows = (sharded_frame.global_row_slice(train)
                      if self._mesh is not None else None)
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
        rows = getattr(self, "_rows", None)
        return dict(max_depth=int(self.params["max_depth"]),
                    min_rows=float(self.params["min_rows"]),
                    min_split_improvement=float(
                        self.params["min_split_improvement"]),
                    mesh=getattr(self, "_mesh", None),
                    n_global=None if rows is None else rows[2])

    @staticmethod
    def _rebuild_margins(f, binned, packs, vals, max_depth: int, maxB: int):
        """`f` plus each tree's leaf values, tree by tree in order: the
        margins the uninterrupted loop held (a resumed rank whose rows
        are not the saving rank's)."""
        for p, v in zip(packs, vals):
            f = f + apply_packed(binned, p.to(binned.device), v, max_depth,
                                 maxB)
        return f

    def _rows_match(self, rs) -> bool:
        """Whether a saved state's per-row arrays are this rank's rows."""
        return tuple(rs.get("rows") or ()) == tuple(
            getattr(self, "_rows", None) or ())

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
            # order-free sums: the same for every split into ranks
            num, den = fixed_point_sums(torch.stack(
                [dist.init_f_num(w, y, offset).double(),
                 dist.init_f_denom(w, y, offset).double()], dim=1),
                self._mesh).tolist()
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
        t_start = t_base
        rs = self._take_resume_state("tree_single")
        if rs is not None:
            # the saved loop state, exactly: margins, trees, the host
            # Generator
            t_start = int(rs["t_done"])
            init_f = float(rs["init_f"])
            stop_metric = [float(v) for v in rs["stop_metric"]]
            history = [dict(h) for h in rs["history"]]
            packs, leaf_vals, leaf_wys = self._load_tree_progress(
                rs, binned.device, max_depth)
            if self._rows_match(rs):
                f = _device(rs["f"], binned.device)
                if f_valid is not None and rs.get("f_valid") is not None:
                    f_valid = _device(rs["f_valid"], binned.device)
            else:
                f = self._rebuild_margins(f, binned, packs, leaf_vals,
                                          max_depth, maxB)
                if f_valid is not None:
                    f_valid = self._rebuild_margins(
                        f_valid, vs["binned"], packs, leaf_vals, max_depth,
                        maxB)
            rng.bit_generator.state = rs["rng_state"]
        jp_every = self._job_ckpt_every()
        for t in range(t_start, ntrees):
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
            obs_metrics.inc("h2o3_tree_trees_built_total")
            if self._should_score(t, ntrees):
                dev = _mean_deviance(dist, w, y, f, self._mesh)
                entry = {"tree": t + 1, "training_deviance": dev, **keys}
                if f_valid is not None:
                    vdev = _mean_deviance(dist, vs["w"], vs["y"], f_valid,
                                          sharded_frame.mesh_of(
                                              self._valid_frame_ref))
                    entry["validation_deviance"] = vdev
                    stop_metric.append(vdev)
                else:
                    stop_metric.append(dev)
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
                    "phase": "tree_single", "t_done": done,
                    "init_f": float(init_f), "f": _host(f),
                    "f_valid": _host(f_valid), "rows": self._rows,
                    "stop_metric": list(stop_metric),
                    "history": [dict(h) for h in history],
                    **self._tree_progress_ref(packs, leaf_vals, leaf_wys),
                    "rng_state": rng.bit_generator.state})

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
            pri = segment_sum(yi, w, K).double()           # class weights
            if self._mesh is not None:
                self._mesh.all_reduce(pri, "sum")
            pri = pri.cpu().numpy()
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
        t_start = t_base
        rs = self._take_resume_state("tree_multi")
        if rs is not None:
            # the saved loop state, as in _fit_single
            t_start = int(rs["t_done"])
            init = np.asarray(rs["init"], np.float32)
            f = _device(rs["f"], dev)
            if f_valid is not None and rs.get("f_valid") is not None:
                f_valid = _device(rs["f_valid"], dev)
            stop_metric = [float(v) for v in rs["stop_metric"]]
            history = [dict(h) for h in rs["history"]]
            tree_class = list(rs["tree_class"])
            packs, leaf_vals, leaf_wys = self._load_tree_progress(
                rs, dev, max_depth)
            rng.bit_generator.state = rs["rng_state"]
        jp_every = self._job_ckpt_every()
        for t in range(t_start, ntrees):
            masks = build_feat_masks(max_depth, self._feat_mask_fn(rng, spec),
                                     spec.F, maxB)
            w_t = sampled_weights(w, root_key, t, rate, self._rows)
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
                obs_metrics.inc("h2o3_tree_trees_built_total")
                if f_valid is not None:
                    f_valid[:, k] += apply_packed(vs["binned"], packed, gamma,
                                                  max_depth, maxB)
            if self._should_score(t, ntrees):
                ll = _mean_logloss(f, yi, w, self._mesh)
                entry = {"tree": t + 1, "training_logloss": ll}
                if f_valid is not None:
                    vll = _mean_logloss(f_valid,
                                        torch.clamp_min(vs["y"].long(), 0),
                                        vs["w"], sharded_frame.mesh_of(
                                            self._valid_frame_ref))
                    entry["validation_logloss"] = vll
                    stop_metric.append(vll)
                else:
                    stop_metric.append(ll)
                history.append(entry)
                if self._early_stop(stop_metric):
                    break
            if self._out_of_time():
                break
            if self.job:
                self.job.update(progress=(t + 1) / ntrees, msg=f"iter {t + 1}")
            if jp_every and (t + 1) % jp_every == 0:
                done = t + 1
                self._tick_job_progress(done, lambda: {
                    "phase": "tree_multi", "t_done": done,
                    "init": np.asarray(init), "f": _host(f),
                    "f_valid": _host(f_valid),
                    "stop_metric": list(stop_metric),
                    "history": [dict(h) for h in history],
                    "tree_class": list(tree_class),
                    **self._tree_progress_ref(packs, leaf_vals, leaf_wys),
                    "rng_state": rng.bit_generator.state})

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
        draws one uniform per row of its padded column (of all the rows:
        a rank keeps its own)."""
        rate = float(self.params.get("sample_rate", 1.0))
        if rate >= 1.0:
            return None, w
        lo, hi, n = getattr(self, "_rows", None) or (0, N, N)
        mask = torch.as_tensor(rng.random(pad_rows(n))[lo:hi] < rate,
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


def _path_column(fo, t: int, leaf: np.ndarray, reached: np.ndarray,
                 n: int, dev) -> Column:
    """Tree t's root-to-leaf L/R walks as an enum column of `n` rows,
    this process's rows `leaf`: the domain is the sorted walks of the
    leaves some row reached (`reached`, the sorted node ids; "(root)"
    for a stump), as interning the strings would make it, built per leaf
    and gathered, not per row."""
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
    names = [paths[i] or "(root)" for i in reached]
    order = sorted(range(len(names)), key=names.__getitem__)
    lut = np.zeros(feat.shape[0], np.int32)
    lut[reached[order]] = np.arange(len(order), dtype=np.int32)
    return sharded_frame.block_column(lut[leaf], n, ctype="enum",
                                      domain=[names[i] for i in order],
                                      device=dev)


def _leaf_matrix(model, adapted: Frame, n: int) -> np.ndarray:
    """(n, T) leaf ids of the adapted frame: through the model's scoring
    session (bucketed, captured once per bucket on the card) when the
    model rides the session path, else the eager bin + walk pass; the
    two are bitwise equal."""
    from h2o3_tpu_torch import scoring

    if scoring.supports(model):
        return scoring.session_for(model).leaf_matrix(adapted, n)
    return model.forest.leaf_index(
        model.spec.bin_columns(adapted)).cpu().numpy()


def _host(t) -> Optional[np.ndarray]:
    """A loop tensor as a host array of its dtype (None stays None)."""
    return None if t is None else t.detach().cpu().numpy()


def _device(a: np.ndarray, device) -> torch.Tensor:
    """A saved host array back on the loop's device, a tensor of its own
    (the multinomial loops update their margins in place)."""
    return torch.from_numpy(np.array(a)).to(device)


def _leaf_update(vals, row_leaf):
    """Each row's leaf value (0 for rows in no leaf)."""
    return torch.where(row_leaf >= 0,
                       vals[torch.clamp_min(row_leaf, 0).long()], 0.0)


def _weighted_mean(vals, w, mesh) -> float:
    """sum(vals) / sum(w), each sum order-free (core/ops.fixed_point_sums)
    so that one process and every split of the rows into ranks of `mesh`
    score, and stop early, alike; the quotient is taken in float32."""
    num, den = fixed_point_sums(torch.stack([vals.double(), w.double()], 1),
                                mesh).tolist()
    return float(np.float32(num) / np.float32(max(den, 1e-12)))


def _mean_deviance(dist, w, y, f, mesh=None) -> float:
    return _weighted_mean(dist.deviance(w, y, f), w, mesh)


def _mean_logloss(f, yi, w, mesh=None) -> float:
    p = softmax(f)[torch.arange(f.shape[0], device=f.device), yi]
    return _weighted_mean(-w * torch.log(torch.clamp_min(p, 1e-15)), w,
                          mesh)
