"""Estimator alias, h2o-py name parity (estimators/random_forest.py;
counterpart of h2o3_tpu/models/drf.py)."""

from h2o3_tpu_torch.models.tree.drf import DRF, DRFModel  # noqa: F401

H2ORandomForestEstimator = DRF
