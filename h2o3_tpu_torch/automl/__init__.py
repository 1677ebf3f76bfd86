"""AutoML (counterpart of h2o3_tpu/automl/: the AutoML orchestrator, its
step registry and the in-process search engine)."""

from h2o3_tpu_torch.automl.automl import H2OAutoML  # noqa: F401
