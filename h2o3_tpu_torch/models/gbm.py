"""Estimator alias, h2o-py name parity (estimators/gbm.py; counterpart of
h2o3_tpu/models/gbm.py)."""

from h2o3_tpu_torch.models.tree.gbm import GBM, GBMModel  # noqa: F401

H2OGradientBoostingEstimator = GBM
