"""GBM — gradient boosting machine (counterpart of
h2o3_tpu/models/tree/gbm.py: `staged_predict_proba` :24, defaults :99).

The algorithm is SharedTree plus the distribution's residuals and leaf
Newton steps; this class adds the GBM parameters (learn_rate and its
annealing, per-node column sampling, the leaf-value bound) and staged
class probabilities.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.models.model import ModelCategory
from h2o3_tpu_torch.models.tree.shared_tree import SharedTree, SharedTreeModel


class GBMModel(SharedTreeModel):
    algo_name = "gbm"

    def staged_predict_proba(self, frame: Frame) -> Frame:
        """Per-stage class probabilities: column T<t>.C<c> holds class c's
        probability using trees 1..t (multinomial: tree groups 1..t).
        Binomial trees model class 1, so T<t>.C1 carries p0, as in the
        reference."""
        cat = self._output.model_category
        if cat not in (ModelCategory.Binomial, ModelCategory.Multinomial):
            raise ValueError("staged_predict_proba needs a classification "
                             "GBM")
        adapted = self.adapt_test(frame)
        leaf = self.forest.leaf_index(
            self.spec.bin_columns(adapted)).cpu().numpy()
        dev = adapted.col(adapted.names[0]).data.device
        fo = self.forest
        lv = np.asarray(fo.leaf_val, np.float64)
        contrib = np.take_along_axis(lv, leaf.T, axis=1).T   # (N, T)
        out = Frame()
        if cat == ModelCategory.Binomial:
            margins = (fo.init_f
                       + np.cumsum(contrib, axis=1)).astype(np.float32)
            p1 = self._distribution.linkinv(
                torch.as_tensor(margins)).double().numpy()
            for t in range(fo.n_trees):
                out.add(f"T{t + 1}.C1",
                        Column.from_numpy(1.0 - p1[:, t], device=dev))
            return out
        # multinomial: stages advance one tree group (one tree per class)
        K = fo.nclasses
        tcls = np.asarray(fo.tree_class)
        init = (np.asarray(fo.init_class, np.float64)
                if fo.init_class is not None else np.zeros(K))
        margins = np.tile(init, (frame.nrows, 1))
        by_group: dict = {}
        counters: dict = {}
        for t in range(fo.n_trees):
            k = int(tcls[t])
            g = counters.get(k, 0)
            counters[k] = g + 1
            by_group.setdefault(g, []).append((k, t))
        for g in range(len(by_group)):
            for k, t in by_group.get(g, []):
                margins[:, k] += contrib[:, t]
            z = margins - margins.max(1, keepdims=True)
            e = np.exp(z)
            p = e / e.sum(1, keepdims=True)
            for k in range(K):
                out.add(f"T{g + 1}.C{k + 1}",
                        Column.from_numpy(p[:, k].copy(), device=dev))
        return out


class GBM(SharedTree):
    algo_name = "gbm"
    model_class = GBMModel

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({"learn_rate": 0.1, "learn_rate_annealing": 1.0,
                  "sample_rate": 1.0, "col_sample_rate": 1.0,
                  "max_abs_leafnode_pred": 1e30})
        return p

    def _tree_lr(self, t: int) -> float:
        lr = float(self.params.get("learn_rate", 0.1))
        anneal = float(self.params.get("learn_rate_annealing", 1.0) or 1.0)
        return lr * (anneal ** t)
