"""The model framework and the algorithms (counterpart of
h2o3_tpu/models/__init__.py).

`BUILDERS` maps each algorithm's `algo_name` to its builder; the
algorithm modules fill it (@register) as `_register_all` imports them.
"""

from h2o3_tpu_torch.models.model_builder import BUILDERS, register  # noqa: F401

ALGORITHMS = ("tree.gbm", "tree.drf", "tree.isofor", "deeplearning",
              "kmeans", "pca", "naive_bayes", "svd", "glrm", "word2vec",
              "ensemble", "rulefit", "coxph", "gam", "aggregator",
              "extended_isofor", "psvm", "xgboost", "isotonic",
              "target_encoder", "segments", "glm")


def _register_all():
    """Import every algorithm module for its @register."""
    import importlib

    for mod in ALGORITHMS:
        importlib.import_module(f"h2o3_tpu_torch.models.{mod}")


_register_all()
