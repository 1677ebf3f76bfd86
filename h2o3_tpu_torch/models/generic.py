"""Generic model: an external MOJO as a first-class model (counterpart of
h2o3_tpu/models/generic.py: `GenericModel` :23, `Generic` :48).

Reference: h2o-algos/src/main/java/hex/generic/ (Generic.java,
GenericModel.java): reads a MOJO artifact and serves the Model API
(predict, metrics) by delegating scoring to the embedded scorer.

The MOJO reader (models/mojo.py) rebuilds the concrete scoring model
(forest, GLM, KMeans, MLP, ...) on the runtime's device, and
GenericModel wraps it: predict, adapt_test and metrics run the inner
model's own device code, so a round trip predicts bit for bit as the
exporting model does.
"""

from __future__ import annotations

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.models.model_builder import ModelBuilder, register


class GenericModel(Model):
    algo_name = "generic"

    def __init__(self, inner: Model, parms=None):
        super().__init__(parms=parms)
        self._inner = inner
        # the inner model's world, for metrics and introspection
        self._output = inner._output
        # ... and its scoring add-ons (Platt / isotonic calibration columns)
        self._calibrator = getattr(inner, "_calibrator", None)
        if self._calibrator is not None:
            self._calibrated_p1 = inner._calibrated_p1

    def _predict_raw(self, frame: Frame):
        return self._inner._predict_raw(frame)

    def adapt_test(self, test: Frame) -> Frame:
        return self._inner.adapt_test(test)

    @property
    def inner_algo(self) -> str:
        return self._inner.algo_name


@register
class Generic(ModelBuilder):
    """H2OGenericEstimator: `Generic(path=...).train()`, with no training
    data, loads the MOJO and installs the model in the DKV like any
    trained model (hex/generic/Generic.java)."""

    algo_name = "generic"
    model_class = GenericModel
    supervised = False

    @classmethod
    def default_params(cls):
        p = super().default_params()
        p.update({"path": None, "model_key": None})
        return p

    def train(self, x=None, y=None, training_frame=None,
              validation_frame=None, **kw) -> GenericModel:
        self.params.update({k: v for k, v in kw.items() if v is not None})
        path = self.params.get("path") or self.params.get("model_key")
        if not path:
            raise ValueError("Generic: 'path' to a MOJO file is required")
        from h2o3_tpu_torch.core.dkv import DKV
        from h2o3_tpu_torch.models import mojo

        inner = mojo.read_mojo(path)
        model = GenericModel(inner, parms=dict(self.params))
        if self.params.get("model_id"):
            DKV.put(self.params["model_id"], model)
        self.model = model
        return model


# h2o-py spelling
H2OGenericEstimator = Generic
