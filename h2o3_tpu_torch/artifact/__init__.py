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

Pipeline artifacts (``export_pipeline``) wait for the lazy Rapids
planner (ROADMAP A11).
"""

from h2o3_tpu_torch.artifact.export import export_model, supports_export
from h2o3_tpu_torch.artifact.loader import describe, load_model
from h2o3_tpu_torch.artifact.manifest import (FORMAT, FORMAT_VERSION,
                                              ArtifactError)

__all__ = ["export_model", "supports_export", "load_model", "describe",
           "ArtifactError", "FORMAT", "FORMAT_VERSION"]
