"""GBM — gradient boosting machine (counterpart of
h2o3_tpu/models/tree/gbm.py).

The algorithm is SharedTree plus the distribution's residuals and leaf
Newton steps; this class adds the GBM parameters and the learning-rate
schedule (learn_rate * learn_rate_annealing^t).
"""

from __future__ import annotations

from h2o3_tpu_torch.models.tree.shared_tree import SharedTree, SharedTreeModel


class GBMModel(SharedTreeModel):
    algo_name = "gbm"


class GBM(SharedTree):
    algo_name = "gbm"
    model_class = GBMModel

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({"learn_rate": 0.1, "learn_rate_annealing": 1.0,
                  "max_abs_leafnode_pred": 1e30})
        return p

    def _tree_lr(self, t: int) -> float:
        lr = float(self.params.get("learn_rate", 0.1))
        anneal = float(self.params.get("learn_rate_annealing", 1.0) or 1.0)
        return lr * (anneal ** t)
