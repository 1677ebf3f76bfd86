"""Artifact import: artifact directory -> servable model (counterpart of
h2o3_tpu/artifact/loader.py).

A forest artifact re-hydrates the SharedTreeModel (forest, BinSpec,
distribution, labelling threshold), a GLM artifact the GLMModel (its
coefficients and DataInfo), installed under a DKV key; the model then
serves through the same scoring session as one trained here. The
artifact's programs are not needed for that, so an artifact exported by
either package loads. A pipeline artifact (artifact/pipeline.py) imports
as a :class:`~h2o3_tpu_torch.artifact.pipeline.PipelineModel`, which
scores raw frames through the artifact's own programs on the booted
device. Every byte read is checksum-gated by the manifest
(manifest.read_payload) and the npz payload is read with
``allow_pickle=False``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from h2o3_tpu_torch.artifact import manifest, packer
from h2o3_tpu_torch.artifact.manifest import ArtifactError


def _new_model(cls):
    """An empty `cls` model, withdrawn from the DKV until it validates
    (Model.__init__ installs under a fresh key)."""
    from h2o3_tpu_torch.core.dkv import DKV

    model = cls(parms={})
    DKV.remove(str(model.key))
    return model


def _finish(model, m: Dict[str, Any], model_id: Optional[str],
            install: bool):
    from h2o3_tpu_torch.core.dkv import Key
    from h2o3_tpu_torch.models.model import ModelCategory
    from h2o3_tpu_torch.models.mojo import _threshold_metrics

    if model._output.model_category == ModelCategory.Binomial:
        model._output.training_metrics = _threshold_metrics(
            float(m["default_threshold"]))
    dest = str(model_id or m.get("model_key")
               or f"artifact_model_{m['model_checksum'][:12]}")
    model._key = Key(dest)
    if install:
        model.install()
    return model


def load_model(art_dir: str, model_id: Optional[str] = None,
               install: bool = True):
    """Load the artifact at `art_dir` into a Model, installed under
    `model_id` or the exported key (`install=False` builds and validates
    without touching the DKV). Raises ArtifactError on corruption, a
    version mismatch or an unsupported model; nothing reaches the DKV
    before validation completes."""
    from h2o3_tpu_torch import persist
    from h2o3_tpu_torch.models.distribution import get_distribution
    from h2o3_tpu_torch.models.mojo import _model_class
    from h2o3_tpu_torch.models.tree.binning import BinSpec
    from h2o3_tpu_torch.models.tree.compressed import CompressedForest
    from h2o3_tpu_torch.models.tree.shared_tree import SharedTreeModel

    art_dir = persist.resolve(art_dir)
    m = manifest.read_manifest(art_dir)
    mt = m.get("model_type", "forest")
    if mt == "glm":
        return _load_glm(art_dir, m, model_id, install)
    if mt == "pipeline":
        return _load_pipeline(art_dir, m, model_id, install)
    if mt != "forest":
        raise ArtifactError(
            f"artifact model_type {mt!r} cannot be imported (forest, glm "
            "and pipeline artifacts import)")
    arrays = packer.load_npz(
        manifest.read_payload(art_dir, m["files"]["forest"]))
    try:
        cls = _model_class(str(m["algo"]))
    except ValueError as e:
        raise ArtifactError(f"artifact algo {m['algo']!r} is not loadable "
                            f"here: {e}") from None
    if not issubclass(cls, SharedTreeModel):
        raise ArtifactError(
            f"artifact algo {m['algo']!r} is not a forest model")
    model = _new_model(cls)

    edges, pos = [], 0
    for ln in arrays["spec_edges_len"]:
        edges.append(np.asarray(arrays["spec_edges_flat"][pos: pos + int(ln)],
                                np.float32))
        pos += int(ln)
    names = list(m["names"])
    if len(names) != int(arrays["spec_is_cat"].shape[0]):
        raise ArtifactError("manifest names disagree with packed spec width")
    model.spec = BinSpec(names, arrays["spec_is_cat"].astype(bool),
                         arrays["spec_nbins"], edges, arrays["spec_cards"])
    forest = CompressedForest(
        arrays["feat"], arrays["thresh_bin"], arrays["na_left"].astype(bool),
        arrays["left"], arrays["right"],
        arrays["leaf_val"].astype(np.float32), arrays["cat_split"],
        arrays["cat_table"].astype(bool), arrays["tree_class"],
        arrays["na_bins"], max_depth=int(m["max_depth"]),
        init_f=float(m["init_f"]), nclasses=int(m["nclasses"]))
    if "init_class" in arrays:
        forest.init_class = np.asarray(arrays["init_class"], np.float32)
    model.forest = forest
    if packer.model_checksum(forest, model.spec) != m["model_checksum"]:
        raise ArtifactError("model checksum mismatch — the packed forest "
                            "does not match the manifest")
    dist = (m.get("distribution") or {}).get("name")
    if dist:
        model._distribution = get_distribution(
            dist, tweedie_power=float(
                (m.get("distribution") or {}).get("tweedie_power") or 1.5))
    o = model._output
    o.names = names
    o.domains = {k: list(v) for k, v in (m.get("domains") or {}).items()}
    o.response_name = m.get("response_name")
    o.response_domain = list(m.get("response_domain") or []) or None
    o.model_category = str(m["model_category"])
    return _finish(model, m, model_id, install)


def _load_glm(art_dir: str, m: Dict[str, Any], model_id: Optional[str],
              install: bool):
    """GLM artifact -> GLMModel: the DataInfo rebuilt from the packed
    moments and the manifest's layout, checksum-verified before anything
    reaches the DKV."""
    from h2o3_tpu_torch.artifact import glm as artifact_glm
    from h2o3_tpu_torch.models.data_info import DataInfo
    from h2o3_tpu_torch.models.glm import GLMModel

    arrays = packer.load_npz(manifest.read_payload(art_dir, m["files"]["glm"]))
    meta = m.get("glm") or {}
    names = list(m["names"])
    n_cat, n_num = int(meta.get("n_cat", -1)), int(meta.get("n_num", -1))
    if n_cat < 0 or n_num < 0 or n_cat + n_num != len(names):
        raise ArtifactError(
            "glm artifact layout is inconsistent: manifest names "
            f"({len(names)}) != n_cat + n_num ({n_cat}+{n_num})")
    doms = {k: list(v) for k, v in (m.get("domains") or {}).items()}
    for n in names[:n_cat]:
        if n not in doms:
            raise ArtifactError(
                f"glm artifact names categorical predictor {n!r} but "
                "carries no domain for it")
    model = _new_model(GLMModel)
    model.beta = torch.as_tensor(np.asarray(arrays["beta"], np.float32))
    model.linkname = str(meta.get("linkname", "identity"))
    model.link_power = float(meta.get("link_power", 0.0))
    model.dinfo = DataInfo.from_state({
        "response_name": m.get("response_name"),
        "standardize": bool(meta.get("standardize", True)),
        "cat_names": names[:n_cat], "num_names": names[n_cat:],
        "domains": {n: doms[n] for n in names[:n_cat]},
        "cards": [int(c) for c in meta.get(
            "cards", [len(doms[n]) for n in names[:n_cat]])],
        "use_all_factor_levels": bool(meta.get("use_all_factor_levels",
                                               False)),
        "num_means": arrays["num_means"], "num_sigmas": arrays["num_sigmas"],
        "cat_modes": arrays["cat_modes"],
        "impute_values": arrays["impute_values"]})
    if model.beta.shape[0] != model.dinfo.fullN + 1:
        raise ArtifactError(
            f"glm artifact beta length {model.beta.shape[0]} does not "
            f"match the expanded layout ({model.dinfo.fullN}+intercept)")
    o = model._output
    o.names = names
    o.domains = doms
    o.response_name = m.get("response_name")
    o.response_domain = list(m.get("response_domain") or []) or None
    o.model_category = str(m["model_category"])
    if int(meta.get("nclasses", o.nclasses)) != o.nclasses:
        raise ArtifactError(
            "glm artifact nclasses disagrees with its response domain")
    # the checksum spans the packed arrays and the rebuilt meta, so it
    # proves the whole re-hydration round-trips
    if artifact_glm.glm_checksum(model) != m["model_checksum"]:
        raise ArtifactError("model checksum mismatch — the packed glm "
                            "payload does not match the manifest")
    return _finish(model, m, model_id, install)


def _load_pipeline(art_dir: str, m: Dict[str, Any],
                   model_id: Optional[str], install: bool):
    """Pipeline artifact -> PipelineModel over the artifact's programs;
    the manifest's checksum must bind the inner model to the plan."""
    import hashlib

    from h2o3_tpu_torch.artifact import runner
    from h2o3_tpu_torch.artifact.pipeline import PipelineModel
    from h2o3_tpu_torch.core.runtime import cluster

    p = m["pipeline"]
    want = hashlib.sha256((str(p.get("inner_model_checksum")) + "|"
                           + str(p.get("signature"))).encode()).hexdigest()
    if want != m["model_checksum"]:
        raise ArtifactError("model checksum mismatch — the pipeline's plan "
                            "and inner model do not match the manifest")
    scorer = runner.AotScorer(art_dir, device=str(cluster().device),
                              pin_float32=False)
    model = _new_model(PipelineModel)
    model.scorer = scorer
    model.pipeline = dict(p)
    o = model._output
    o.names = list(m["names"])
    o.domains = {k: list(v) for k, v in (m.get("domains") or {}).items()}
    o.response_name = m.get("response_name")
    o.response_domain = list(m.get("response_domain") or []) or None
    o.model_category = str(m["model_category"])
    return _finish(model, m, model_id, install)


def describe(art_dir: str) -> Dict[str, Any]:
    """Validated manifest summary; no payload is read."""
    from h2o3_tpu_torch import persist

    m = manifest.read_manifest(persist.resolve(art_dir))
    return {k: m.get(k) for k in (
        "format", "format_version", "algo", "model_key", "model_category",
        "model_checksum", "nclasses", "n_trees", "max_depth", "buckets",
        "default_threshold", "created_ts")} | {
        "programs": [{"bucket": e.get("bucket"), "backend": e.get("backend"),
                      "bytes": e.get("bytes")}
                     for e in m.get("programs", [])],
        "n_features": len(m.get("names") or []),
    }
