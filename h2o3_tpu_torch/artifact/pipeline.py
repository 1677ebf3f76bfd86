"""Pipeline artifacts: munge→score as one standalone program
(counterpart of h2o3_tpu/artifact/pipeline.py).

Where a forest or GLM artifact scores training-shaped feature rows, a
pipeline artifact (manifest ``model_type="pipeline"``) ships the
captured Rapids feature plan fused with the model core, so the
standalone runner (artifact/runner.py) scores raw, untransformed rows:
the engineered features are computed inside the same program as the
binning and walk (forest) or the expansion, matmul and inverse link
(GLM), bitwise with in-process pipeline serving.

Each row bucket's program is a ``torch.export`` ExportedProgram
(``program_b{N}.pt2``) of :class:`PipelineProgram` over one (bucket, R)
float32 matrix of raw inputs; the model's arrays ride as program inputs
from the artifact's npz, as in the forest and GLM artifacts, and the
plan's constants are baked into the program. The plan itself (the SSA
snapshot of the spliced expressions) is written as ``pipeline.json``,
the auditable record of what was fused; the runner checks its digest
and executes the shipped program.

Export refuses what cannot be one program bitwise:

- feature expressions with the reference's compiler-rewrite boundaries
  (``/ ^ % intDiv``, or a multiply feeding an add or subtract), which
  run in-process as separate sub-programs;
- raw inputs that are not float32 numerics or integer-coded
  categoricals;
- unnamed or name-colliding leaf columns.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch import compat
from h2o3_tpu_torch.artifact import aot, manifest, packer
from h2o3_tpu_torch.artifact.manifest import ArtifactError
from h2o3_tpu_torch.core.frame import T_CAT, Frame
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.rapids import fusion

PIPELINE_FILE = "pipeline.json"


# ---------------------------------------------------------------------------
# capture and eligibility
# ---------------------------------------------------------------------------

def capture_for_export(model, frame):
    """(Capture, inner) for a model over a frame carrying a pending lazy
    feature pipeline; ArtifactError with the reason otherwise."""
    from h2o3_tpu_torch import pipeline as pl
    from h2o3_tpu_torch.models.glm import GLMModel

    key = getattr(model, "key", model)
    if isinstance(model, GLMModel):
        from h2o3_tpu_torch.artifact.glm import supports_glm_export

        why = supports_glm_export(model) or pl.glm_eligible(model, frame)
        if why:
            raise ArtifactError(f"cannot export pipeline for {key}: "
                                f"{why}")
        d = model.dinfo
        got = pl._owning_planner(frame, d.predictor_names)
        if got is None:
            raise ArtifactError(
                f"cannot export pipeline for {key}: the frame "
                "carries no pending lazy Rapids feature for this model's "
                "predictors (export before anything observes the deferred "
                "columns)")
        planner, _n = got
        with planner._lock:
            cap = pl._capture_pipe(frame, d.predictor_names, planner)
        if cap is None:
            raise ArtifactError(
                f"cannot export pipeline for {key}: a pending "
                "feature does not fuse (sorts/slices and non-fusible ops "
                "stay on the staged path)")
        return cap, "glm"

    from h2o3_tpu_torch import scoring

    if not scoring.supports(model):
        raise ArtifactError(
            f"cannot export pipeline for {key}: not a fused-path "
            "forest model (GBM/DRF/XGBoost) or GLM")
    cap = pl.capture_forest(scoring.session_for(model), frame)
    if cap is None:
        raise ArtifactError(
            f"cannot export pipeline for {key}: the frame does not "
            "splice onto the model (needs >= 1 pending lazy Rapids "
            "feature, concrete columns matching the training schema "
            "exactly, and a fusible expression per engineered feature)")
    return cap, "forest"


def check_exportable(cap) -> None:
    """Refuse captures whose one-program form could not be bitwise."""
    plan = cap.plan
    for leaf in plan.leaves:
        if isinstance(leaf, fusion.Plan):
            raise ArtifactError(
                "pipeline features contain compiler-rewrite boundaries "
                "(/ ^ % intDiv, or a multiply feeding an add/sub); "
                "in-process these run as separate programs and cannot be "
                "fused bitwise into one standalone program — simplify the "
                "feature expressions or precompute those terms")
    names = []
    for i, leaf in enumerate(plan.leaves):
        nm = cap.names_by_token.get(leaf.token)
        if not nm:
            raise ArtifactError(
                "every raw input of a pipeline artifact must be a "
                "uniquely-named frame column (an unnamed or ambiguously "
                "named leaf cannot enter the raw-row schema)")
        names.append(nm)
        dt = str(plan.leaf_dtypes[i])
        if plan.leaf_ctypes[i] == T_CAT:
            # codes only feed comparisons and table gathers, so the code
            # width is immaterial
            if not dt.startswith("int"):
                raise ArtifactError(
                    f"categorical input {nm!r} has dtype {dt}; pipeline "
                    "artifacts require integer level codes")
        elif dt != "float32":
            raise ArtifactError(
                f"numeric input {nm!r} has dtype {dt}; pipeline artifacts "
                "score float32 raw rows — cast the source column to real "
                "first")
    if len(set(names)) != len(names):
        raise ArtifactError(
            "two distinct raw input columns share a name — the raw-row "
            f"schema must be unambiguous (inputs: {names})")


# ---------------------------------------------------------------------------
# plan snapshot (pipeline.json)
# ---------------------------------------------------------------------------

def _tree_json(node):
    if isinstance(node, tuple):
        return [_tree_json(c) for c in node]
    return node


def _inputs_of(cap) -> List[Dict[str, Any]]:
    plan = cap.plan
    out = []
    for i, leaf in enumerate(plan.leaves):
        nm = cap.names_by_token.get(leaf.token)
        cat = plan.leaf_ctypes[i] == T_CAT
        out.append({"name": nm, "kind": "cat" if cat else "num",
                    "domain": list(leaf.domain or []) if cat else None})
    return out


def _plan_payload(cap, inner: str) -> bytes:
    plan = cap.plan
    doc = {
        "inner": inner,
        "signature": plan.signature,
        "root": _tree_json(plan.root),
        "inputs": _inputs_of(cap),
        "consts": [float(v) for v in plan.consts],
        "spliced_nodes": int(cap.spliced),
    }
    return json.dumps(doc, indent=1, sort_keys=True).encode("utf-8")


# ---------------------------------------------------------------------------
# the program: feature plan + model core over raw rows
# ---------------------------------------------------------------------------

class PipelineProgram(torch.nn.Module):
    """run(Xr, *model_inputs) over a (bucket, R) float32 raw matrix:
    typed leaf columns (enum codes from floats, NaN -> -1, as the
    runner's packer writes them), the feature expressions through
    fusion.eval_tree, then score_core (forest; inputs as
    aot.forest_inputs) or the expansion and glm_predict (GLM; inputs as
    aot.glm_inputs). The constants are baked in with `full_like`, so the
    program holds no tensor and runs on any device."""

    def __init__(self, cap, inner: str, meta: Dict[str, Any]):
        super().__init__()
        plan = cap.plan
        self.ctypes = tuple(plan.leaf_ctypes)
        self.feats = tuple(plan.root[1:])
        self.consts = tuple(float(np.float32(v)) for v in plan.consts)
        self.inner = inner
        if inner == "forest":
            self.core = aot.ForestProgram(
                int(meta["max_depth"]), tuple(meta["tree_class"]),
                aot.n_margins(meta))
        else:
            self.core = aot.GLMProgram(meta)

    def forward(self, Xr, *inputs):
        cols = []
        for i, ct in enumerate(self.ctypes):
            x = Xr[:, i].contiguous()
            cols.append(torch.where(torch.isnan(x), -1.0, x)
                        .to(torch.int32) if ct == T_CAT else x)
        consts = [torch.full_like(Xr[0, 0], v) for v in self.consts]
        leaf = fusion.leaf_reader(list(self.ctypes), cols)
        parts = []
        for f in self.feats:
            if f[0] == "L":
                c = cols[f[1]]
                # a forest packs bare enum codes as floats; a GLM reads
                # its categorical predictors as integer codes
                parts.append(c if self.inner == "glm" else c.float())
            else:
                parts.append(fusion.eval_tree(f, leaf, consts.__getitem__))
        if self.inner == "forest":
            return self.core(torch.stack(parts, dim=1), *inputs)
        return self.core(*parts, *inputs)


def _model_meta(model, inner: str) -> Dict[str, Any]:
    if inner == "glm":
        from h2o3_tpu_torch.artifact import glm as artifact_glm

        return artifact_glm.glm_meta(model)
    meta = dict(packer.forest_meta(model.forest, model.spec))
    meta["tree_class"] = [int(c) for c in
                          np.asarray(model.forest.tree_class).tolist()]
    return meta


def _model_inputs(model, inner: str, arrays) -> tuple:
    if inner == "glm":
        return aot.glm_inputs(arrays)
    meta = packer.forest_meta(model.forest, model.spec)
    return aot.forest_inputs(arrays, float(meta["init_f"]))


def export_pipeline_bucket(bucket: int, cap, inner: str, model,
                           arrays) -> bytes:
    """The serialized ExportedProgram of one row bucket."""
    mod = PipelineProgram(cap, inner, _model_meta(model, inner))
    Xr = torch.zeros((int(bucket), len(cap.plan.leaves)),
                     dtype=torch.float32)
    args = (Xr,) + _model_inputs(model, inner, arrays)
    return aot._save(compat.torch_export().export(mod, args, strict=False))


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def export_pipeline(model, frame, out_dir: str,
                    buckets: Optional[List[int]] = None) -> Dict[str, Any]:
    """Export the lazy feature pipeline feeding `frame` fused with `model`
    as a standalone pipeline artifact; returns the manifest. Capture only
    reads the DAG: the frame can still be scored in-process after."""
    from h2o3_tpu_torch.artifact import export as model_export
    from h2o3_tpu_torch.artifact import glm as artifact_glm

    cap, inner = capture_for_export(model, frame)
    check_exportable(cap)
    buckets = sorted({int(b) for b in
                      (buckets or model_export.default_buckets())
                      if int(b) > 0})
    if not buckets:
        raise ArtifactError("at least one positive row bucket is required")
    os.makedirs(out_dir, exist_ok=True)

    o = model._output
    if inner == "glm":
        inner_checksum = artifact_glm.glm_checksum(model)
        arrays = artifact_glm.pack_glm(model)
        model_file = ("glm", artifact_glm.GLM_FILE)
        cat = o.model_category
        post = {"kind": ("glm_binomial" if cat == "Binomial"
                         else "glm_multinomial" if cat == "Multinomial"
                         else "glm_regression")}
        nclasses = int(artifact_glm.glm_meta(model)["nclasses"])
        per_class, max_depth, init_f, n_trees = False, 0, 0.0, 0
        model_names = list(model.dinfo.predictor_names)
    else:
        inner_checksum = packer.model_checksum(model.forest, model.spec)
        arrays = packer.pack_forest(model.forest, model.spec)
        model_file = ("forest", model_export.FOREST_FILE)
        meta = packer.forest_meta(model.forest, model.spec)
        post = model_export._post_spec(model)
        nclasses = int(meta["nclasses"])
        per_class = bool(meta["per_class_trees"])
        max_depth = int(meta["max_depth"])
        init_f = float(meta["init_f"])
        n_trees = int(meta["n_trees"])
        model_names = list(o.names)

    sig_hash = hashlib.sha256(
        (inner_checksum + "|" + cap.plan.signature).encode()).hexdigest()
    plan_entry = manifest.write_payload(out_dir, PIPELINE_FILE,
                                        _plan_payload(cap, inner))
    model_entry = manifest.write_payload(out_dir, model_file[1],
                                         packer.dump_npz(arrays))
    progs = model_export._programs(
        out_dir, sig_hash, "pipeline", buckets,
        lambda b: export_pipeline_bucket(b, cap, inner, model, arrays))
    inputs = _inputs_of(cap)
    m = manifest.new_manifest(
        model_type="pipeline",
        algo=str(model.algo_name),
        model_key=str(model.key),
        model_category=str(o.model_category),
        model_checksum=sig_hash,
        nclasses=nclasses,
        per_class_trees=per_class,
        max_depth=max_depth,
        init_f=init_f,
        n_trees=n_trees,
        names=[i["name"] for i in inputs],
        response_name=o.response_name,
        response_domain=list(o.response_domain or []) or None,
        domains={i["name"]: list(i["domain"]) for i in inputs
                 if i["kind"] == "cat"},
        post=post,
        default_threshold=model_export._default_threshold(model),
        pipeline={
            "inner": inner,
            "inputs": inputs,
            "signature": cap.plan.signature,
            "spliced_nodes": int(cap.spliced),
            "inner_model_checksum": inner_checksum,
            "model_names": model_names,
        },
        glm=(artifact_glm.glm_meta(model) if inner == "glm" else {}),
        files={"pipeline": plan_entry, model_file[0]: model_entry},
        buckets=buckets,
        executables=[],
        stablehlo=[],
        programs=progs,
    )
    manifest.write_manifest(out_dir, m)
    return m


# ---------------------------------------------------------------------------
# import: a pipeline artifact as a model over raw frames
# ---------------------------------------------------------------------------

class PipelineModel(Model):
    """A pipeline artifact imported into the cluster (artifact/loader.py):
    `predict` packs a raw frame's input columns (enum levels by label onto
    the artifact's raw domains, unseen or missing -> NA) and scores them
    through the artifact's programs (the runner's AotScorer on the
    booted device), so it answers what the standalone runner answers."""

    algo_name = "pipeline"

    def __init__(self, parms=None):
        super().__init__(parms=parms)
        self.scorer = None
        self.pipeline: Dict[str, Any] = {}

    def predict(self, frame: Frame) -> Frame:
        sc = self.scorer
        cols = {}
        for name in sc.names:
            if name in frame:
                c = frame.col(name)
                cols[name] = (c.values() if c.ctype == T_CAT
                              else c.to_numpy())
        raw = sc.raw_predict(sc.pack_features(cols))
        raw = {k: torch.as_tensor(v, device=sc.device)
               for k, v in raw.items()}
        return self._raw_to_frame(raw, frame.nrows)
