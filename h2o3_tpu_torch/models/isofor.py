"""Estimator alias, h2o-py name parity (estimators/isolation_forest.py;
counterpart of h2o3_tpu/models/isofor.py)."""

from h2o3_tpu_torch.models.tree.isofor import (  # noqa: F401
    IsolationForest, IsolationForestModel)

H2OIsolationForestEstimator = IsolationForest
