"""SharedTree: the boosting loop for GBM (counterpart of
h2o3_tpu/models/tree/shared_tree.py: `_pre_fn` :41, `_post_fn` :71,
`_fit` :364, `_fit_single` :471, `SharedTreeModel`).

Per tree: residuals and leaf Newton-step rows (`_pre`), one device-grown
tree (device_tree.grow_tree_device), leaf gammas and the margin update
(`_post`). Every per-tree table stays on the device until one transfer
at the end of training. This slice ports the single-margin families
(gaussian, bernoulli) with every row and every column used per tree;
row/column sampling, multinomial, validation frames and early stopping
are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.data_info import DataInfo
from h2o3_tpu_torch.models.distribution import (auto_distribution,
                                                get_distribution)
from h2o3_tpu_torch.models.model import Model, ModelCategory
from h2o3_tpu_torch.models.model_builder import ModelBuilder
from h2o3_tpu_torch.models.tree.binning import BinSpec
from h2o3_tpu_torch.models.tree.compressed import (CompressedForest,
                                                   _fused_margins)


def _pre(dist, y, f, w):
    """(y, f, w) -> (z, num, den): residuals and leaf Newton-step rows."""
    z = dist.neg_half_gradient(y, f)
    return z, dist.gamma_num(w, y, z, f), dist.gamma_denom(w, y, z, f)


def _post(leaf4, row_leaf, f, lr: float, clip: float):
    """(leaf4, row_leaf, f) -> (gamma, f_new): leaf Newton steps, clipped
    and shrunk by the learning rate, added to every row's margin."""
    ln, ld = leaf4[:, 2], leaf4[:, 3]
    gamma = torch.where(ld > 1e-12, ln / torch.clamp_min(ld, 1e-12), 0.0)
    gamma = torch.clamp(gamma, -clip, clip) * lr
    f_new = f + torch.where(row_leaf >= 0,
                            gamma[torch.clamp_min(row_leaf, 0).long()], 0.0)
    return gamma, f_new


class SharedTreeModel(Model):
    """Trained forest; scoring bins the adapted frame with the training
    BinSpec and walks the forest."""

    def __init__(self, parms=None):
        super().__init__(parms=parms)
        self.forest: Optional[CompressedForest] = None
        self.spec: Optional[BinSpec] = None
        self._distribution = None

    def _margin(self, frame: Frame) -> torch.Tensor:
        """(N,) margins of the adapted frame: raw features binned with the
        training edges and walked through the forest in one pass."""
        spec = self.spec
        X = torch.stack([frame.col(n).data.float() for n in spec.names],
                        dim=1)
        dev = X.device
        return _fused_margins(
            X, torch.as_tensor(spec.padded_edges(), device=dev),
            torch.as_tensor(spec.is_cat, device=dev), self.forest)

    def _predict_raw(self, frame: Frame):
        f = self._margin(frame)
        if self._output.model_category == ModelCategory.Binomial:
            p = self._distribution.linkinv(f)
            return {"probs": torch.stack([1 - p, p], dim=-1)}
        return {"value": self._distribution.linkinv(f)}


class SharedTree(ModelBuilder):
    """Base tree builder: binning, the boosting loop, scoring history and
    variable importances."""

    model_class = SharedTreeModel
    not_ported = dict(ModelBuilder.not_ported, sample_rate=1.0,
                      col_sample_rate=1.0, col_sample_rate_per_tree=1.0,
                      stopping_rounds=0, max_runtime_secs=0.0)

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({"ntrees": 50, "max_depth": 5, "min_rows": 10.0,
                  "nbins": 20, "nbins_cats": 1024,
                  "min_split_improvement": 1e-5,
                  "score_each_iteration": False, "score_tree_interval": 0,
                  "distribution": "AUTO"})
        return p

    def _tree_lr(self, t: int) -> float:
        """Shrinkage applied to tree t's leaves."""
        return 1.0

    def _leaf_clip(self) -> float:
        """Leaf-value bound: max_abs_leafnode_pred when set, else a
        numeric-safety bound."""
        clip = float(self.params.get("max_abs_leafnode_pred", 1e30) or 1e30)
        return clip if clip < 1e30 else 1e4

    def _fit(self, train: Frame) -> SharedTreeModel:
        model = self.model_class(parms=dict(self.params))
        out = self._init_output(model, train)
        y_col = train.col(self.params["response_column"])
        dist_name = (self.params.get("distribution") or "AUTO").lower()
        if dist_name == "auto":
            dist_name = auto_distribution(y_col.ctype, out.nclasses)
        dist = get_distribution(dist_name)
        model._distribution = dist
        spec = BinSpec.build(train, out.names,
                             nbins=int(self.params["nbins"]),
                             nbins_cats=int(self.params["nbins_cats"]))
        model.spec = spec
        binned = spec.bin_columns(train)
        w_user = None
        if self.params.get("weights_column"):
            w_user = train.col(self.params["weights_column"]).data
        w = DataInfo.response_weight(y_col.data, w_user)
        y = DataInfo.clean_response(y_col.data).float()
        t0 = time.time()
        model.forest = self._fit_single(model, binned, y, w, spec, dist)
        model._output.run_time_ms = int((time.time() - t0) * 1000)
        return model

    def _fit_single(self, model, binned, y, w, spec, dist):
        """Boosting loop for single-margin families; returns the forest."""
        from h2o3_tpu_torch.models.tree.device_tree import (assemble_trees,
                                                            grow_tree_device)

        N = binned.shape[0]
        ntrees = int(self.params["ntrees"])
        # init f0: weighted argmin of the deviance at a constant margin
        num = float(torch.sum(dist.init_f_num(w, y, 0.0)))
        den = float(torch.sum(dist.init_f_denom(w, y, 0.0)))
        init_f = float(dist.link(torch.tensor(num / max(den, 1e-12),
                                              dtype=torch.float32)))
        if dist.name == "bernoulli":
            init_f = float(np.clip(init_f, -19, 19))
        f = torch.full((N,), init_f, dtype=torch.float32,
                       device=binned.device)

        clip = self._leaf_clip()
        max_depth = int(self.params["max_depth"])
        min_rows = float(self.params["min_rows"])
        msi = float(self.params["min_split_improvement"])
        history = []
        packs, leaf_vals, leaf_wys = [], [], []
        for t in range(ntrees):
            z, num_r, den_r = _pre(dist, y, f, w)
            packed, leaf4, row_leaf = grow_tree_device(
                binned, w, z, spec, max_depth=max_depth, min_rows=min_rows,
                min_split_improvement=msi, num=num_r, den=den_r)
            gamma, f = _post(leaf4, row_leaf, f, self._tree_lr(t), clip)
            packs.append(packed)
            leaf_vals.append(gamma)
            leaf_wys.append(leaf4[:, :2])
            if self._should_score(t, ntrees):
                dev = float(torch.sum(dist.deviance(w, y, f))
                            / torch.clamp_min(torch.sum(w), 1e-12))
                history.append({"tree": t + 1, "training_deviance": dev})

        trees = assemble_trees(packs, leaf_vals, leaf_wys, spec, max_depth)
        varimp: Dict[str, float] = {}
        names = model._output.names
        for tree in trees:
            for n in tree.nodes:
                if n.split is not None:
                    nm = names[n.split.feat]
                    varimp[nm] = varimp.get(nm, 0.0) + max(n.split.gain, 0.0)
        model._output.scoring_history = history
        if varimp:
            top = max(varimp.values()) or 1.0
            model._output.variable_importances = {
                k: v / top for k, v in sorted(varimp.items(),
                                              key=lambda kv: -kv[1])}
        return CompressedForest.from_host_trees(
            trees, spec, max_depth=max_depth, init_f=init_f, nclasses=1)

    def _should_score(self, t: int, ntrees: int) -> bool:
        if t == ntrees - 1 or self.params.get("score_each_iteration"):
            return True
        interval = int(self.params.get("score_tree_interval") or 0)
        return interval > 0 and (t + 1) % interval == 0
