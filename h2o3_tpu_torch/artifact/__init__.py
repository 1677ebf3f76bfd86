"""Standalone scoring artifacts (counterpart of h2o3_tpu/artifact).

- :mod:`export`: trained forest or GLM -> artifact directory: a
  versioned manifest, the packed arrays (``forest.npz`` / ``glm.npz``)
  and one exported ``torch.export`` program per row bucket.
- :mod:`loader`: artifact directory -> servable model, checksum-gated.
- :mod:`compile_cache`: program counters and the disk tier of exported
  programs under ``$H2O_TPU_COMPILE_CACHE_DIR``.
- :mod:`manifest`, :mod:`packer`, :mod:`aot`, :mod:`glm`: the codecs.
- :mod:`runner`: the standalone scorer, run as a file path with torch,
  numpy and the standard library alone.
- :mod:`pipeline`: ``export_pipeline`` fuses a pending lazy Rapids
  feature pipeline with a forest or GLM into one program per bucket,
  scored from raw rows by the runner; the loader imports it as a
  ``PipelineModel``.
"""

from h2o3_tpu_torch.artifact.export import export_model, supports_export
from h2o3_tpu_torch.artifact.loader import describe, load_model
from h2o3_tpu_torch.artifact.manifest import (FORMAT, FORMAT_VERSION,
                                              ArtifactError)
from h2o3_tpu_torch.artifact.pipeline import export_pipeline

__all__ = ["export_model", "export_pipeline", "supports_export",
           "load_model", "describe",
           "ArtifactError", "FORMAT", "FORMAT_VERSION"]
