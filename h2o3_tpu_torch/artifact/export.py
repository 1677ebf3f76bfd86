"""Artifact exporter: trained model -> self-contained scoring directory
(counterpart of h2o3_tpu/artifact/export.py).

The directory holds

- ``manifest.json``: versioned, schema-validated, a sha256 for every
  payload;
- ``forest.npz`` (or ``glm.npz``): the packed arrays, no pickle;
- ``program_b{N}.pt2``: the exported scoring program of row bucket N
  (artifact/aot.py), listed under the manifest's ``programs``.

The standalone runner (artifact/runner.py) scores from it with torch,
numpy and the standard library alone; either package's `load_model`
turns it back into a servable model.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

from h2o3_tpu_torch.artifact import aot, compile_cache, manifest, packer
from h2o3_tpu_torch.artifact.manifest import ArtifactError
from h2o3_tpu_torch.obs import compiles

FOREST_FILE = "forest.npz"


def supports_export(model) -> Optional[str]:
    """None when `model` can be exported (the session-path forest family,
    or a standalone-scorable GLM); otherwise the reason."""
    from h2o3_tpu_torch.artifact.glm import supports_glm_export
    from h2o3_tpu_torch.models.glm import GLMModel
    from h2o3_tpu_torch.models.tree.shared_tree import SharedTreeModel

    if isinstance(model, GLMModel):
        return supports_glm_export(model)
    if not isinstance(model, SharedTreeModel):
        return (f"{type(model).__name__} is not a SharedTree forest model "
                "or a GLM; artifacts cover the forest scoring family "
                "(GBM/DRF/XGBoost) and GLM — use MOJO export for other "
                "algos")
    if model.forest is None or model.spec is None:
        return "model has no trained forest"
    if type(model)._predict_raw is not SharedTreeModel._predict_raw:
        return (f"{type(model).__name__} overrides _predict_raw (custom "
                "post-processing) and cannot ride the scoring program")
    return None


def _post_spec(model) -> Dict[str, Any]:
    """The margin -> raw recipe the runner replays with the ops of
    SharedTreeModel._margin_to_raw."""
    from h2o3_tpu_torch.models.model import ModelCategory

    cat = model._output.model_category
    if cat == ModelCategory.Binomial:
        return {"kind": "binomial"}
    if cat == ModelCategory.Multinomial:
        return {"kind": "multinomial"}
    dist = getattr(model, "_distribution", None)
    name = getattr(dist, "name", "gaussian") if dist is not None \
        else "gaussian"
    linkinv = "exp" if name in ("poisson", "gamma", "tweedie") else "identity"
    return {"kind": "regression", "linkinv": linkinv}


def _default_threshold(model) -> float:
    tm = model._output.training_metrics
    aucd = getattr(tm, "auc_data", None)
    return float(aucd.max_f1_threshold) if aucd is not None else 0.5


def default_buckets() -> List[int]:
    from h2o3_tpu_torch.scoring import _env_buckets

    return sorted(_env_buckets())


def _programs(out_dir: str, checksum: str, variant: str,
              buckets: List[int], build: Callable[[int], bytes]
              ) -> List[Dict[str, Any]]:
    """Write each bucket's program, from the compile cache's disk tier
    when it holds this model's program for this backend, else exported
    (and stored there)."""
    fp = aot.backend_fingerprint()
    entries = []
    for b in buckets:
        key = compile_cache.cache_key(checksum, b, variant, fp) \
            if compile_cache.enabled() else None
        blob = compile_cache.load(key) if key is not None else None
        if blob is not None:
            compiles.record_hit("artifact", tier="disk")
        else:
            with compiles.timed("artifact", (checksum, b, variant),
                                program=f"{variant}_b{b}"):
                blob = build(b)
            if key is not None:
                compile_cache.store(key, blob)
        e = manifest.write_payload(out_dir, f"program_b{b}.pt2", blob)
        e.update(bucket=b, backend=fp)
        entries.append(e)
    return entries


def _export_glm(model, out_dir: str, buckets: List[int]) -> Dict[str, Any]:
    """GLM artifact (model_type "glm"): the packed coefficients and
    moments and one exported program per bucket; the forest-only
    manifest keys carry inert values so one schema covers both."""
    from h2o3_tpu_torch.artifact import glm

    arrays = glm.pack_glm(model)
    meta = glm.glm_meta(model)
    checksum = glm.glm_checksum(model)
    entry = manifest.write_payload(out_dir, glm.GLM_FILE,
                                   packer.dump_npz(arrays))
    progs = _programs(out_dir, checksum, "glm", buckets,
                      lambda b: aot.export_glm_bucket(b, meta, arrays))
    o = model._output
    cat = o.model_category
    post = {"kind": ("glm_binomial" if cat == "Binomial"
                     else "glm_multinomial" if cat == "Multinomial"
                     else "glm_regression")}
    m = manifest.new_manifest(
        model_type="glm", algo=str(model.algo_name),
        model_key=str(model.key), model_category=str(cat),
        model_checksum=checksum, nclasses=int(meta["nclasses"]),
        per_class_trees=False, max_depth=0, init_f=0.0, n_trees=0,
        names=list(model.dinfo.predictor_names),
        response_name=o.response_name,
        response_domain=list(o.response_domain or []) or None,
        domains={k: list(v) for k, v in model.dinfo.domains.items()},
        post=post, default_threshold=_default_threshold(model), glm=meta,
        files={"glm": entry}, buckets=buckets, executables=[],
        stablehlo=[], programs=progs)
    manifest.write_manifest(out_dir, m)
    return m


def export_model(model, out_dir: str,
                 buckets: Optional[List[int]] = None) -> Dict[str, Any]:
    """Write the artifact directory for `model`, one program for each of
    `buckets` (default: the serving ladder); returns the manifest."""
    why = supports_export(model)
    if why:
        raise ArtifactError(f"cannot export {model.key}: {why}")
    buckets = sorted({int(b) for b in (buckets or default_buckets())
                      if int(b) > 0})
    if not buckets:
        raise ArtifactError("at least one positive row bucket is required")
    os.makedirs(out_dir, exist_ok=True)
    from h2o3_tpu_torch.models.glm import GLMModel

    if isinstance(model, GLMModel):
        return _export_glm(model, out_dir, buckets)

    forest, spec = model.forest, model.spec
    arrays = packer.pack_forest(forest, spec)
    meta = packer.forest_meta(forest, spec)
    checksum = packer.model_checksum(forest, spec)
    forest_entry = manifest.write_payload(out_dir, FOREST_FILE,
                                          packer.dump_npz(arrays))
    progs = _programs(out_dir, checksum, "forest", buckets,
                      lambda b: aot.export_forest_bucket(b, meta, arrays))
    o = model._output
    dist = getattr(model, "_distribution", None)
    m = manifest.new_manifest(
        algo=str(model.algo_name), model_key=str(model.key),
        model_category=str(o.model_category), model_checksum=checksum,
        nclasses=int(meta["nclasses"]),
        per_class_trees=bool(meta["per_class_trees"]),
        max_depth=int(meta["max_depth"]), init_f=float(meta["init_f"]),
        n_trees=int(meta["n_trees"]), names=list(o.names),
        response_name=o.response_name,
        response_domain=list(o.response_domain or []) or None,
        domains={k: list(v) for k, v in (o.domains or {}).items()},
        post=_post_spec(model), default_threshold=_default_threshold(model),
        distribution={"name": getattr(dist, "name", None),
                      "tweedie_power": float(getattr(dist, "power", 1.5))},
        files={"forest": forest_entry}, buckets=buckets, executables=[],
        stablehlo=[], programs=progs)
    manifest.write_manifest(out_dir, m)
    return m
