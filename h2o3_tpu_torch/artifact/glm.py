"""GLM artifact packing (counterpart of h2o3_tpu/artifact/glm.py).

The exported program is the port's DataInfo expansion and glm_predict
(artifact/aot.GLMProgram) over per-column inputs: int32 categorical
codes, float32 numerics, NA as negative or NaN. The coefficients and the
DataInfo moments ride as program inputs from ``glm.npz``.

Scope, as the reference's (refused with a reason otherwise): gaussian-
family regression, binomial and multinomial GLMs without interactions,
offset columns or the ordinal link.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional

import numpy as np

GLM_FILE = "glm.npz"


def _host(t) -> np.ndarray:
    import torch

    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def supports_glm_export(model) -> Optional[str]:
    """None when `model` is an exportable GLM; otherwise the reason."""
    from h2o3_tpu_torch.models.glm import GLMModel

    if not isinstance(model, GLMModel):
        return f"{type(model).__name__} is not a GLM"
    if model.beta is None or model.dinfo is None:
        return "model has no trained coefficients"
    if model.linkname == "ordinal":
        return "ordinal GLMs are not artifact-exportable yet"
    if model._parms.get("interactions"):
        return ("GLMs with interaction columns expand frames at adapt "
                "time and cannot ride the standalone program")
    if model._parms.get("offset_column"):
        return ("GLMs with an offset column need per-request offsets the "
                "standalone artifact cannot carry")
    return None


def pack_glm(model) -> Dict[str, np.ndarray]:
    """Dense arrays for a trained GLM (the whole payload is arrays)."""
    d = model.dinfo
    return {
        "beta": _host(model.beta).astype(np.float32),
        "cat_modes": np.asarray(d.cat_modes, np.int32),
        "impute_values": np.asarray(d.impute_values, np.float32),
        "num_means": np.asarray(d.num_means, np.float32),
        "num_sigmas": np.asarray(d.num_sigmas, np.float32),
        "cards": np.asarray(d.cards, np.int64),
    }


def glm_meta(model) -> Dict[str, Any]:
    """The shape-defining configuration the program is built for; rides
    in the manifest's ``glm`` block."""
    d = model.dinfo
    return {"use_all_factor_levels": bool(d.use_all_factor_levels),
            "standardize": bool(d.standardize),
            "linkname": str(model.linkname),
            "link_power": float(model.link_power),
            "nclasses": int(model._output.nclasses),
            "n_cat": len(d.cat_names),
            "n_num": len(d.num_names),
            "cards": [int(c) for c in d.cards]}


def glm_checksum(model) -> str:
    """Content hash of the packed arrays and the meta (the same
    discipline as packer.model_checksum)."""
    h = hashlib.sha256()
    arrays = pack_glm(model)
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(json.dumps(glm_meta(model), sort_keys=True).encode())
    return h.hexdigest()
