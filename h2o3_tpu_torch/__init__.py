"""h2o3_tpu_torch — the PyTorch/CUDA port of h2o3_tpu for one NVIDIA H100.

    import h2o3_tpu_torch as h2o
    h2o.init()                      # the CUDA device; device="cpu" on a CPU
    fr = h2o.Frame(); fr.add("x", h2o.Column.from_numpy(x)); ...
    m = h2o.GBM(ntrees=20, max_depth=5).train(y="y", training_frame=fr)
    m.predict(fr); m.model_performance()
    h2o.DRF(ntrees=50).train(y="y", training_frame=fr, validation_frame=va)

Importing the package builds no kernel: each CUDA kernel is compiled on
its first launch (or all at once by ``kernels.build_all``).
"""

from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.core.runtime import cluster, init
from h2o3_tpu_torch.models.tree.drf import DRF, DRFModel
from h2o3_tpu_torch.models.tree.gbm import GBM, GBMModel

__all__ = ["Column", "DRF", "DRFModel", "Frame", "GBM", "GBMModel",
           "cluster", "init"]
