"""Extended REST routes — the RegisterV3Api.java surface beyond the core
(counterpart of h2o3_tpu/api/routes_ext.py, the same 83 routes).

Frames column/summary/export, binary model and frame save/load, the
ModelMetrics cache family, POJO export, NodePersistentStorage,
admin/diagnostic routes, the observability routes (/3/Metrics,
/3/Trace, /3/Runtime, /3/FlightRecords, /3/Profiler/start|stop), and
the /99 utility tier (Assembly, DCTTransformer, Tabulate, Sample,
Rapids/help).

Handlers follow the server.py conventions: fn(ctx) -> dict | RawReply,
ApiError for failures. Reference route list: water/api/RegisterV3Api.java:23.
"""

from __future__ import annotations

import gc
import glob as _glob
import io
import json
import os
import pickle
import sys
import threading
import time
import traceback
import uuid

import numpy as np
import torch

from h2o3_tpu_torch.api import schemas as S
from h2o3_tpu_torch.api.server import (ApiError, Ctx, RawReply, _frame_or_404,
                                 _model_or_404, _parse_list)
from h2o3_tpu_torch.core.dkv import DKV
from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT, T_NUM
from h2o3_tpu_torch.core.job import Job
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.utils.unpickle import RestrictedUnpickler


# binary artifacts load through the restricted unpickler (the port's own
# types, numpy, and the rebuild functions utils/unpickle.py admits) on
# every path, the network-facing upload route included: they must not be
# able to smuggle arbitrary callables (pickle RCE)
_ArtifactUnpickler = RestrictedUnpickler


def _artifact_dumps(obj) -> bytes:
    """Pickle `obj` with every tensor written as its numpy array (the
    form the restricted loader reads back onto the booted device)."""
    from h2o3_tpu_torch.models.model import _ModelPickler

    buf = io.BytesIO()
    _ModelPickler(buf, protocol=4).dump(obj)
    return buf.getvalue()


def _artifact_dump(obj, path: str) -> None:
    with open(path, "wb") as f:
        f.write(_artifact_dumps(obj))


def _artifact_loads(data: bytes):
    return _ArtifactUnpickler(io.BytesIO(data)).load()


def _artifact_load_file(path: str):
    with open(path, "rb") as f:
        return _ArtifactUnpickler(f).load()


def _done_job(description: str, dest_key=None, dest_type=None) -> Job:
    job = Job(description=description)
    if dest_key:
        job.dest_key = str(dest_key)
    if dest_type:
        job.dest_type = dest_type
    job.status = Job.DONE
    job.progress = 1.0
    job.start_time = job.end_time = time.time()
    return job

# ---------------------------------------------------------------------------
# Capabilities (water/api/CapabilitiesHandler)
# ---------------------------------------------------------------------------

_CORE_CAPABILITIES = [
    {"name": "h2o3_tpu_torch", "description": "H2O-3 runtime on PyTorch/CUDA "
                                              "(one H100)"},
    {"name": "MOJO", "description": "MOJO export/import + standalone "
                                    "h2o3_genmodel scoring runtime"},
    {"name": "POJO", "description": "Java scoring class export (tree/GLM)"},
    {"name": "AutoML", "description": "automatic model search"},
    {"name": "Grid", "description": "cartesian + random hyperparameter search"},
    {"name": "Sharding", "description": "one device now; multi-GPU row "
                                        "sharding to come"},
]


def h_capabilities(ctx: Ctx):
    return {"__meta": S.meta("CapabilitiesV3"),
            "capabilities": list(_CORE_CAPABILITIES)}


def h_capabilities_core(ctx: Ctx):
    return h_capabilities(ctx)


def h_capabilities_api(ctx: Ctx):
    from h2o3_tpu_torch.api.server import ROUTES

    out = [{"name": f"{m} {p}", "description": s}
           for m, p, _h, s in ROUTES]
    return {"__meta": S.meta("CapabilitiesV3"), "capabilities": out}


def h_metadata_endpoint(ctx: Ctx):
    """GET /3/Metadata/endpoints/{path} — one endpoint by number or name
    (water/api/MetadataHandler.fetchRoute)."""
    from h2o3_tpu_torch.api.server import ROUTES

    want = ctx.params["path"]
    for i, (m, p, h, summ) in enumerate(ROUTES):
        if want == str(i) or want == p or want == h.__name__.lstrip("h_"):
            return {"__meta": S.meta("EndpointsListV4"), "endpoints": [{
                "num": i, "http_method": m, "url_pattern": p,
                "summary": summ, "api_name": h.__name__.lstrip("h_")}]}
    raise ApiError(f"endpoint {want!r} not found", 404)


def h_metadata_schemaclass(ctx: Ctx):
    """GET /3/Metadata/schemaclasses/{classname} — schema detail by java
    class name (maps onto our schema registry)."""
    from h2o3_tpu_torch.api.server import _SCHEMA_REGISTRY

    name = ctx.params["classname"].rsplit(".", 1)[-1]
    if name not in _SCHEMA_REGISTRY:
        raise ApiError(f"unknown schema class {name!r}", 404)
    return {"__meta": S.meta("SchemaMetadataV3"),
            "schemas": [{"name": name, "version": 3,
                         "type": name.rstrip("V3"), "fields": []}]}


# ---------------------------------------------------------------------------
# Frames: columns / summaries / chunks / export / binary save-load
# ---------------------------------------------------------------------------

def _col_or_404(fr: Frame, name: str) -> Column:
    if name not in fr:
        raise ApiError(f"Column '{name}' not found in frame {fr.key}", 404)
    return fr.col(name)


def h_frame_columns(ctx: Ctx):
    fr = _frame_or_404(ctx.params["frame_id"])
    off = int(ctx.arg("offset", 0) or 0)
    cnt = int(ctx.arg("column_count", -1) or -1)
    names = fr.names[off:] if cnt < 0 else fr.names[off:off + cnt]
    return {"__meta": S.meta("FramesV3"),
            "frames": [{"frame_id": S.key_ref(str(fr.key)),
                        "column_names": names, "total_column_count": fr.ncols,
                        "columns": [S.col_v3(n, fr.col(n), 0, 10)
                                    for n in names]}]}


def h_frame_column(ctx: Ctx):
    fr = _frame_or_404(ctx.params["frame_id"])
    col = _col_or_404(fr, ctx.params["column"])
    return {"__meta": S.meta("FramesV3"),
            "frames": [{"frame_id": S.key_ref(str(fr.key)),
                        "columns": [S.col_v3(ctx.params["column"], col, 0, 10)]}]}


def h_frame_column_domain(ctx: Ctx):
    fr = _frame_or_404(ctx.params["frame_id"])
    col = _col_or_404(fr, ctx.params["column"])
    return {"__meta": S.meta("FrameV3"),
            "domain": [list(col.domain or [])],
            "map_keys": {"string": list(col.domain or [])}}


def h_frame_column_summary(ctx: Ctx):
    fr = _frame_or_404(ctx.params["frame_id"])
    name = ctx.params["column"]
    col = _col_or_404(fr, name)
    cj = S.col_v3(name, col, 0, 10)
    if col.is_numeric:
        from h2o3_tpu_torch.ops.quantile import quantile_column

        probs = [0.01, 0.1, 0.25, 0.333, 0.5, 0.667, 0.75, 0.9, 0.99]
        try:
            cj["percentiles"] = [float(v) for v in quantile_column(col, probs)]
            cj["default_percentiles"] = probs
        except Exception:   # noqa: BLE001 — summary stays best-effort
            pass
    return {"__meta": S.meta("FramesV3"),
            "frames": [{"frame_id": S.key_ref(str(fr.key)), "columns": [cj]}]}


def h_frame_chunks(ctx: Ctx):
    """GET /3/FrameChunks/{frame_id} — per-shard layout (the reference's
    per-chunk distribution table, water/api/FrameChunksHandler)."""
    fr = _frame_or_404(ctx.params["frame_id"])
    from h2o3_tpu_torch.core.runtime import cluster

    cl = cluster()
    n_dev = max(len(cl.devices), 1)
    per = -(-fr.nrows // n_dev)
    chunks = [{"chunk_id": i, "row_count": max(min(per, fr.nrows - i * per), 0),
               "node_idx": i} for i in range(n_dev)]
    return {"__meta": S.meta("FrameChunksV3"),
            "frame_id": S.key_ref(str(fr.key)), "chunks": chunks}


def _export_frame(fr: Frame, path: str, force: bool, fmt: str = "csv") -> str:
    """CSV through the server's own writer (the bytes the reference's
    pandas export writes); parquet through pyarrow, which raises
    ImportError where it is absent, as the port's parquet import does."""
    if os.path.exists(path) and not force:
        raise ApiError(f"File {path} already exists (force=false)", 400)
    if fmt in ("parquet",):
        import pyarrow as pa
        import pyarrow.parquet as pq

        pq.write_table(pa.table({n: fr.col(n).values() for n in fr.names}),
                       path)
    else:
        from h2o3_tpu_torch.api.server import frame_csv_bytes

        with open(path, "wb") as f:
            f.write(frame_csv_bytes(fr))
    return path


def h_frame_export(ctx: Ctx):
    """POST /3/Frames/{frame_id}/export and the GET
    /3/Frames/{frame_id}/export/{path}/overwrite/{force} legacy spelling —
    write the frame to a server-side file as a Job (FramesHandler.export)."""
    fr = _frame_or_404(ctx.params["frame_id"])
    path = ctx.params.get("path") or str(ctx.arg("path", "") or "").strip('"')
    if not path:
        raise ApiError("path required", 400)
    force_raw = ctx.params.get("force", ctx.arg("force", "true"))
    force = str(force_raw).lower() in ("1", "true")
    fmt = str(ctx.arg("format", "csv") or "csv").strip('"').lower()
    job = Job(description=f"Export frame {fr.key}")

    def run(j: Job):
        _export_frame(fr, path, force, fmt)
        return None

    job.start(run, background=False)        # small metadata op: sync
    return {"__meta": S.meta("FramesV3"), "job": S.job_v3(job)}


def h_frame_save(ctx: Ctx):
    """POST /3/Frames/{frame_id}/save — binary frame artifact
    (water/api/FramesHandler.save; reference writes its Iced binary form,
    we write a self-contained pickle of host-materialized columns)."""
    fr = _frame_or_404(ctx.params["frame_id"])
    d = str(ctx.arg("dir", "") or "").strip('"')
    if not d:
        raise ApiError("dir required", 400)
    force = str(ctx.arg("force", "true")).lower() in ("1", "true")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, str(fr.key))
    if os.path.exists(path) and not force:
        raise ApiError(f"{path} exists (force=false)", 400)
    _artifact_dump(fr, path)
    job = _done_job(f"Save frame {fr.key}")
    return {"__meta": S.meta("FramesV3"), "job": S.job_v3(job)}


def h_frame_load(ctx: Ctx):
    """POST /3/Frames/load — restore a frame saved by /save."""
    d = str(ctx.arg("dir", "") or "").strip('"')
    fid = str(ctx.arg("frame_id", "") or "").strip('"')
    path = os.path.join(d, fid) if (d and fid) else (d or fid)
    if not os.path.exists(path):
        raise ApiError(f"no saved frame at {path}", 404)
    fr = _artifact_load_file(path)
    if not isinstance(fr, Frame):
        raise ApiError(f"{path} is not a saved frame", 400)
    fr.install()
    job = _done_job(f"Load frame {fr.key}", str(fr.key), "Key<Frame>")
    return {"__meta": S.meta("FramesV3"), "job": S.job_v3(job)}


# ---------------------------------------------------------------------------
# Models: binary save/load/upload, POJO, v99 aliases
# ---------------------------------------------------------------------------

def h_model_fetch_bin(ctx: Ctx):
    """GET /3/Models.fetch.bin/{model_id} (+ /99/Models.bin alias) — the
    model's binary artifact (reference: Iced serialization; here a pickle
    that restores the full model incl. metrics — same-version contract as
    the reference's .bin)."""
    m = _model_or_404(ctx.params["model_id"])
    data = _artifact_dumps(m)
    return RawReply(data, "application/octet-stream",
                    headers={"Content-Disposition":
                             f'attachment; filename="{m.key}.bin"'})


def h_model_save_bin(ctx: Ctx):
    """POST /99/Models.bin/{model_id}?dir=... — h2o.save_model."""
    m = _model_or_404(ctx.params["model_id"])
    d = str(ctx.arg("dir", "") or "").strip('"')
    if not d:
        raise ApiError("dir required", 400)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, str(m.key))
    force = str(ctx.arg("force", "true")).lower() in ("1", "true")
    if os.path.exists(path) and not force:
        raise ApiError(f"{path} exists (force=false)", 400)
    _artifact_dump(m, path)
    return {"__meta": S.meta("ModelsV3"), "dir": d,
            "models": [{"model_id": S.key_ref(str(m.key), "Key<Model>")}]}


def h_model_load_bin(ctx: Ctx):
    """POST /99/Models.bin/ with dir=path — h2o.load_model."""
    d = str(ctx.arg("dir", "") or "").strip('"')
    if not d or not os.path.exists(d):
        raise ApiError(f"no saved model at {d!r}", 404)
    m = _artifact_load_file(d)
    if not isinstance(m, Model):
        raise ApiError(f"{d} is not a saved model", 400)
    m.install()
    return {"__meta": S.meta("ModelsV3"),
            "models": [S.model_v3(m)]}


def h_model_upload_bin(ctx: Ctx):
    """POST /99/Models.upload.bin/{model_id} — raw model bytes upload."""
    raw = ctx.body.get("__raw__") or ctx.body.get("__file__")
    if not raw:
        raise ApiError("no model bytes uploaded", 400)
    try:
        m = _artifact_loads(raw)
    except pickle.UnpicklingError as e:
        raise ApiError(f"rejected model upload: {e}", 400) from None
    if not isinstance(m, Model):
        raise ApiError("uploaded bytes are not a model", 400)
    mid = ctx.params.get("model_id", "").strip()
    if mid:
        from h2o3_tpu_torch.core.dkv import Key

        m._key = Key(mid)
    m.install()
    return {"__meta": S.meta("ModelsV3"),
            "models": [{"model_id": S.key_ref(str(m.key), "Key<Model>")}]}


def h_model_java(ctx: Ctx):
    """GET /3/Models.java/{model_id} — POJO source (toJava analog)."""
    from h2o3_tpu_torch.models import pojo

    m = _model_or_404(ctx.params["model_id"])
    try:
        src = pojo.pojo_source(m)
    except ValueError as e:
        raise ApiError(str(e), 400) from None
    return RawReply(src.encode(), "text/x-java-source",
                    headers={"Content-Disposition":
                             f'attachment; filename="{m.key}.java"'})


def h_model_java_preview(ctx: Ctx):
    from h2o3_tpu_torch.models import pojo

    m = _model_or_404(ctx.params["model_id"])
    try:
        src = pojo.pojo_source(m)
    except ValueError as e:
        raise ApiError(str(e), 400) from None
    lines = src.splitlines()[:1000]
    return RawReply(("\n".join(lines) + "\n").encode(), "text/plain")


def h_model_json(ctx: Ctx):
    m = _model_or_404(ctx.params["model_id"])
    return {"__meta": S.meta("ModelsV3"), "models": [S.model_v3(m)]}


def h_models_delete_all(ctx: Ctx):
    from h2o3_tpu_torch import scoring

    for k in list(DKV.keys()):
        if isinstance(DKV.get(k), Model):
            DKV.remove(k)
            purge_metrics(model_key=k)
    scoring.purge()
    return {"__meta": S.meta("ModelsV3")}


def h_frames_delete_all(ctx: Ctx):
    for k in list(DKV.keys()):
        if isinstance(DKV.get(k), Frame):
            DKV.remove(k)
            purge_metrics(frame_key=k)
    return {"__meta": S.meta("FramesV3")}


# ---------------------------------------------------------------------------
# ModelMetrics cache family (water/api/ModelMetricsHandler)
# ---------------------------------------------------------------------------

_MM_STORE: list = []        # {"model": str, "frame": str, "mm": ModelMetrics}


_MM_CAP = 512      # FIFO bound — reference stores metrics in the DKV


def record_metrics(model_key: str, frame_key: str, mm) -> None:
    _MM_STORE[:] = [e for e in _MM_STORE
                    if not (e["model"] == model_key and e["frame"] == frame_key)]
    _MM_STORE.append({"model": model_key, "frame": frame_key, "mm": mm})
    if len(_MM_STORE) > _MM_CAP:
        del _MM_STORE[: len(_MM_STORE) - _MM_CAP]


def purge_metrics(model_key=None, frame_key=None) -> None:
    """Drop cached metrics tied to a deleted model/frame (DKV-removal
    parity: the reference reclaims metrics with their key)."""
    _MM_STORE[:] = [e for e in _MM_STORE
                    if not ((model_key and e["model"] == model_key)
                            or (frame_key and e["frame"] == frame_key))]


def _mm_entries(model=None, frame=None):
    out = []
    for e in _MM_STORE:
        if model and e["model"] != model:
            continue
        if frame and e["frame"] != frame:
            continue
        out.append(e)
    # training metrics of live models count as cached metrics too
    if not frame:
        for k in DKV.keys():
            m = DKV.get(k)
            if isinstance(m, Model) and (not model or str(m.key) == model):
                tm = m._output.training_metrics
                if tm is not None and not any(
                        e["model"] == str(m.key) and e["frame"] is None
                        for e in out):
                    out.append({"model": str(m.key), "frame": None, "mm": tm})
    return out


def h_modelmetrics_list(ctx: Ctx):
    model = ctx.params.get("model") or None
    frame = ctx.params.get("frame") or None
    if model:
        _model_or_404(model)
    if frame:
        _frame_or_404(frame)
    ents = _mm_entries(model, frame)
    return {"__meta": S.meta("ModelMetricsListSchemaV3"),
            "model_metrics": [S.metrics_v3(e["mm"], e["model"], e["frame"])
                              for e in ents]}


def h_modelmetrics_delete(ctx: Ctx):
    model = ctx.params.get("model") or None
    frame = ctx.params.get("frame") or None
    before = len(_MM_STORE)
    _MM_STORE[:] = [e for e in _MM_STORE
                    if (model and e["model"] != model)
                    or (frame and e["frame"] != frame)]
    return {"__meta": S.meta("ModelMetricsListSchemaV3"),
            "deleted": before - len(_MM_STORE)}


def h_modelmetrics_predictions_vs_actuals(ctx: Ctx):
    """POST /3/ModelMetrics/predictions_frame/{pf}/actuals_frame/{af} —
    h2o.make_metrics: metrics straight from a predictions frame."""
    from h2o3_tpu_torch.models import metrics as M

    pf = _frame_or_404(ctx.params["predictions_frame"])
    af = _frame_or_404(ctx.params["actuals_frame"])
    domain = _parse_list(ctx.arg("domain")) or None
    act = af.col(af.names[0])
    w = torch.ones(act.data.shape[0], dtype=torch.float32,
                   device=act.data.device)
    if act.is_categorical or domain:
        dom = domain or list(act.domain)
        y = act.data.to(torch.int32)
        if len(dom) == 2:
            # predictions frame: predict, p0, p1 — use p1
            p = pf.col(pf.names[-1]).data
            mm = M.make_binomial_metrics(y.to(torch.float32), p, w, dom)
            schema = "ModelMetricsBinomialV3"
        else:
            probs = torch.stack([pf.col(nm).data
                                 for nm in pf.names[-len(dom):]], dim=-1)
            mm = M.make_multinomial_metrics(y, probs, w, dom)
            schema = "ModelMetricsMultinomialV3"
    else:
        f = pf.col(pf.names[0]).data
        mm = M.make_regression_metrics(act.data, f, w)
        schema = "ModelMetricsRegressionV3"
    del schema
    return {"__meta": S.meta("ModelMetricsListSchemaV3"),
            "model_metrics": [S.metrics_v3(mm, None, str(af.key))]}


# ---------------------------------------------------------------------------
# NodePersistentStorage (water/api/NodePersistentStorageHandler)
# ---------------------------------------------------------------------------

def _nps_root() -> str:
    root = os.environ.get("H2O_TPU_NPS_DIR") or os.path.join(
        os.path.expanduser("~"), ".h2o3_tpu_torch", "nps")
    os.makedirs(root, exist_ok=True)
    return root


def _nps_path(category: str, name: str = "") -> str:
    safe = lambda s: "".join(c for c in s if c.isalnum() or c in "-_.")
    p = os.path.join(_nps_root(), safe(category))
    return os.path.join(p, safe(name)) if name else p


def h_nps_configured(ctx: Ctx):
    return {"__meta": S.meta("NodePersistentStorageV3"), "configured": True}


def h_nps_category_exists(ctx: Ctx):
    return {"__meta": S.meta("NodePersistentStorageV3"),
            "exists": os.path.isdir(_nps_path(ctx.params["category"]))}


def h_nps_name_exists(ctx: Ctx):
    return {"__meta": S.meta("NodePersistentStorageV3"),
            "exists": os.path.isfile(_nps_path(ctx.params["category"],
                                               ctx.params["name"]))}


def h_nps_list(ctx: Ctx):
    d = _nps_path(ctx.params["category"])
    entries = []
    if os.path.isdir(d):
        for nm in sorted(os.listdir(d)):
            st = os.stat(os.path.join(d, nm))
            entries.append({"name": nm, "size": st.st_size,
                            "timestamp_millis": int(st.st_mtime * 1000)})
    return {"__meta": S.meta("NodePersistentStorageV3"),
            "category": ctx.params["category"], "entries": entries}


def h_nps_get(ctx: Ctx):
    p = _nps_path(ctx.params["category"], ctx.params["name"])
    if not os.path.isfile(p):
        raise ApiError(f"NPS entry {ctx.params['category']}/"
                       f"{ctx.params['name']} not found", 404)
    with open(p, "rb") as f:
        return RawReply(f.read(), "application/octet-stream")


def h_nps_put(ctx: Ctx):
    cat = ctx.params["category"]
    name = ctx.params.get("name") or f"{uuid.uuid4().hex[:12]}"
    value = ctx.body.get("__raw__", ctx.body.get("__file__"))
    if value is None:
        value = str(ctx.arg("value", "") or "").encode()
    os.makedirs(_nps_path(cat), exist_ok=True)
    with open(_nps_path(cat, name), "wb") as f:
        f.write(value)
    return {"__meta": S.meta("NodePersistentStorageV3"),
            "category": cat, "name": name}


def h_nps_delete(ctx: Ctx):
    p = _nps_path(ctx.params["category"], ctx.params["name"])
    if os.path.isfile(p):
        os.remove(p)
    return {"__meta": S.meta("NodePersistentStorageV3")}


# ---------------------------------------------------------------------------
# Admin / diagnostics
# ---------------------------------------------------------------------------

def h_jstack(ctx: Ctx):
    """GET /3/JStack — per-thread stack dump (water/api/JStackHandler;
    the JVM thread dump maps to Python thread frames here)."""
    frames = sys._current_frames()
    traces = []
    for t in threading.enumerate():
        try:
            frm = frames.get(t.ident)
            buf = traceback.format_stack(frm) if frm is not None else []
        except Exception:   # noqa: BLE001 — frame may die mid-walk
            buf = []
        traces.append({"thread_name": t.name,
                       "is_daemon": t.daemon,
                       "stack": "".join(buf)})
    node = {"node_name": "local", "thread_traces": traces}
    return {"__meta": S.meta("JStackV3"), "traces": [node],
            "nodes": [node]}


def h_kill_minus_3(ctx: Ctx):
    """GET /3/KillMinus3 — log a thread dump (reference sends SIGQUIT to
    itself so stacks land in the log)."""
    from h2o3_tpu_torch.utils.log import get_logger

    dump = h_jstack(ctx)
    for tr in dump["traces"][0]["thread_traces"]:
        get_logger().info("thread %s daemon=%s\n%s", tr["thread_name"],
                          tr["is_daemon"], tr["stack"])
    return {"__meta": S.meta("KillMinus3V3")}


def h_log_and_echo(ctx: Ctx):
    from h2o3_tpu_torch.utils.log import get_logger

    msg = str(ctx.arg("message", "") or "")
    get_logger().info("LogAndEcho: %s", msg)
    return {"__meta": S.meta("LogAndEchoV3"), "message": msg}


def h_logs_node_file(ctx: Ctx):
    """GET /3/Logs/nodes/{nodeidx}/files/{name} — reference per-node log
    fetch; single logical node here, every idx serves the local log."""
    from h2o3_tpu_torch.api.server import h_logs

    out = h_logs(ctx)
    return {"__meta": S.meta("LogsV3"),
            "nodeidx": int(ctx.params.get("nodeidx", -1)),
            "name": ctx.params.get("name", "default"), "log": out["log"]}


def h_typeahead_files(ctx: Ctx):
    """GET /3/Typeahead/files — filesystem path completion
    (water/api/TypeaheadHandler)."""
    src = str(ctx.arg("src", "") or "").strip('"')
    limit = int(ctx.arg("limit", 100) or 100)
    pat = src + "*" if src else "*"
    matches = sorted(_glob.glob(os.path.expanduser(pat)))[:limit]
    return {"__meta": S.meta("TypeaheadV3"), "matches": matches}


def h_find(ctx: Ctx):
    """GET /3/Find?key=frame&column=c&row=N&match=v — next row >= N whose
    cell matches (water/api/FindHandler)."""
    fr = _frame_or_404(str(ctx.arg("key", "") or "").strip('"'))
    colname = str(ctx.arg("column", "") or "").strip('"')
    row = int(ctx.arg("row", 0) or 0)
    match = ctx.arg("match")
    cols = [colname] if colname else fr.names
    for nm in cols:
        col = fr.col(nm)
        vals = col.to_numpy()[row:]
        if col.domain:
            codes = np.asarray(vals, np.int64)
            labels = np.asarray(col.domain, object)[np.maximum(codes, 0)]
            # NA codes (-1) must never match a level
            hit = np.nonzero((codes >= 0)
                             & (labels.astype(str) == str(match)))[0]
        elif match in (None, "", "nan", "NaN"):
            hit = np.nonzero(np.isnan(np.asarray(vals, float)))[0]
        else:
            try:
                target = float(match)
            except (TypeError, ValueError):
                continue       # non-numeric needle, numeric column: no match
            hit = np.nonzero(np.asarray(vals, float) == target)[0]
        if hit.size:
            return {"__meta": S.meta("FindV3"), "prev": -1,
                    "next": row + int(hit[0])}
    return {"__meta": S.meta("FindV3"), "prev": -1, "next": -1}


def h_cloud_lock(ctx: Ctx):
    from h2o3_tpu_torch.core.runtime import cluster

    cluster().locked = True
    return {"__meta": S.meta("CloudLockV3"), "reason":
            str(ctx.arg("reason", "") or "")}


def h_gc(ctx: Ctx):
    from h2o3_tpu_torch.core import cleaner

    gc.collect()
    freed = 0
    try:
        freed = cleaner.sweep(0)
    except Exception:   # noqa: BLE001 — GC stays best-effort
        pass
    return {"__meta": S.meta("GarbageCollectV3"), "freed_bytes": int(freed or 0)}


def h_unlock_keys(ctx: Ctx):
    from h2o3_tpu_torch.core import dkv as _dkv

    n = _dkv.unlock_all()
    return {"__meta": S.meta("UnlockKeysV3"), "unlocked": int(n or 0)}


def h_steam_metrics(ctx: Ctx):
    from h2o3_tpu_torch.core.runtime import cluster_info

    info = cluster_info()
    jobs = [j for j in (DKV.get(k) for k in DKV.keys())
            if isinstance(j, Job)]
    return {"__meta": S.meta("SteamMetricsV3"),
            "idle": all(not j.is_running for j in jobs),
            "idle_millis": 0, "cloud_size": info["cloud_size"]}


def _search_stats() -> dict:
    """Engine counters for the CloudStatus search block (import kept out
    of module load so the API layer stays light)."""
    from h2o3_tpu_torch.automl import search

    return search.stats()


def h_cloud_status(ctx: Ctx):
    """GET /3/CloudStatus — the supervised cloud health state machine
    (HEALTHY/DEGRADED/FAILED/RECOVERING) with its evidence: per-process
    heartbeat ages + incarnations + ack lag, follower replay failures
    (remote tracebacks), rejoin progress, checkpoint/epoch coordinates,
    and the recent transition history — the fields an operator needs to
    watch a recovery. The terse headline rides on /3/Cloud as
    ``cloud_status``; this route is the drill-down."""
    from h2o3_tpu_torch.core.failure import cluster_health, heartbeat_stale_s
    from h2o3_tpu_torch.parallel import ckpt, oplog, supervisor, watchdog
    from h2o3_tpu_torch.parallel import distributed as D

    st = supervisor.status()
    # fold replay progress (last acked seq, ack lag, incarnation) into the
    # per-process heartbeat rows so one table tells the recovery story
    lag_by = {r["process"]: r for r in oplog.follower_lag()}
    health = []
    for row in cluster_health():
        lr = lag_by.pop(row["process"], None)
        if lr is not None:
            row = dict(row, last_acked_seq=lr["last_acked_seq"],
                       ack_lag=lr["ack_lag"])
        health.append(row)
    # followers with acks but no heartbeat row yet still show up
    for p, lr in sorted(lag_by.items()):
        health.append({"process": p, "age_s": None, "healthy": False,
                       "incarnation": lr["incarnation"],
                       "last_acked_seq": lr["last_acked_seq"],
                       "ack_lag": lr["ack_lag"]})
    return {"__meta": S.meta("CloudStatusV3"),
            "state": st["state"],
            "since": st["since"],
            "reason": st["reason"],
            "remote_trace": st["remote_trace"],
            "transitions": st["transitions"],
            "process_health": health,
            "heartbeat_stale_s": heartbeat_stale_s(),
            "expected_acks": oplog.expected_acks(),
            "current_seq": oplog.current_seq(),
            "checkpoint_seq": ckpt.latest_seq(),
            "checkpoint_interval_ops": ckpt.interval_ops(),
            "epoch": D.epoch(),
            "leader": D.leader(),
            # autonomous recovery watchdog: enabled/running, action
            # counters (elections, rejoins, jobs resumed), last action
            "watchdog": watchdog.status(),
            # durable AutoML/grid searches: engine counters plus every
            # search-state record still on disk/KV (a non-empty list during
            # a healthy cloud means a search is mid-flight; after a
            # coordinator loss it is the watchdog's resume worklist)
            "search": {"stats": _search_stats(),
                       "states": ckpt.search_state_records()},
            "job_progress": ckpt.job_progress_records(),
            "rejoins": oplog.rejoin_records(),
            "oplog_errors": [{"seq": seq, "kind": rec.get("kind"),
                              "trace": rec.get("trace")}
                             for seq, rec in oplog.error_records()]}


def h_scoring_metrics(ctx: Ctx):
    """GET /3/ScoringMetrics — per-model serving fast-path statistics
    (scoring.py ScoringSession): request/batch/row counts, micro-batch
    coalescing, latency percentiles, traversal/fused compile counts and
    the active row buckets; plus the admission-control counters, the
    persistent compile-cache stats, and the per-process sharded data-plane
    counters (``data_plane.packed_rows`` / ``data_plane.gathered_rows`` —
    "no coordinator column gather on the fused path" is asserted against
    gathered_rows staying 0), and the Rapids statement-fusion block
    (``rapids``: statements, fused programs/compiles/cache hits, barrier
    fallbacks, host-materialized cells). The per-dispatch events are also
    in /3/Timeline under kind='scoring'."""
    from h2o3_tpu_torch import admission, pipeline, scoring
    from h2o3_tpu_torch.artifact import compile_cache
    from h2o3_tpu_torch.obs import metrics as obs_metrics
    from h2o3_tpu_torch.rapids import fusion

    return {"__meta": S.meta("ScoringMetricsV3"),
            "models": scoring.metrics_snapshot(),
            "admission": admission.CONTROLLER.snapshot(),
            "compile_cache": compile_cache.stats(),
            "data_plane": obs_metrics.data_plane_counters(),
            # per-flush dispatch accounting: program executions by
            # path (host/leaf_host)
            "dispatches": scoring.dispatch_counters(),
            "rapids": fusion.stats(),
            # munge→score splice: fused pipeline dispatches, spliced
            # plan nodes, and the materialized-column counter whose 0 is
            # the "no intermediate Column" contract's observable
            "pipeline": pipeline.stats()}


def h_metrics(ctx: Ctx):
    """GET /3/Metrics — the cloud's metrics (in one process, this
    process's registry: ``metrics.cluster_aggregate``). Default body is Prometheus text exposition (format 0.0.4) so a stock
    Prometheus scrape config points straight at this route;
    ``?format=json`` returns the structured series instead."""
    from h2o3_tpu_torch.obs import metrics as obs_metrics

    series = obs_metrics.cluster_aggregate()
    fmt = str(ctx.arg("format", "") or "").lower()
    if fmt == "json":
        # JSON consumers get computed p50/p95/p99 per histogram sample
        # (the Prometheus text path keeps raw cumulative buckets — that
        # is its contract; histogram_quantile runs server-side there)
        for m in series:
            if m.get("type") != "histogram":
                continue
            for s in m.get("samples", []):
                s["quantiles"] = obs_metrics.histogram_quantiles(
                    m.get("buckets") or [], s.get("bucket_counts") or [],
                    int(s.get("count", 0)))
        return {"__meta": S.meta("MetricsV3"), "series": series,
                "series_count": len(series)}
    return RawReply(obs_metrics.prometheus_text(series).encode(),
                    "text/plain; version=0.0.4; charset=utf-8")


def h_runtime(ctx: Ctx):
    """GET /3/Runtime — the engine's lifecycle and compile story in one
    page: this process's phase history (``backend_init`` …
    ``server_start``, each with wall ms, status and any deadline
    expiry), the compile-ledger table per program family (compiles /
    memory hits / disk hits / total+max ms; the port's captures and
    builds, obs/compiles.py), and the slowest-N programs with signature
    hash, device kind and measured device bytes. The response carries
    ``X-H2O3-Trace-Id`` like every traced route.

    The ``memory`` block is the device-memory planner's state
    (memory/budget.snapshot): budget/free/live bytes, evicted-column
    count, per-family bytes-per-row estimates, streaming/ladder counters
    and the pressure flag admission sheds on."""
    from h2o3_tpu_torch.memory import budget as membudget
    from h2o3_tpu_torch.obs import compiles, phases

    try:
        n = int(ctx.arg("slowest", 10) or 10)
    except (TypeError, ValueError):
        n = 10
    n = max(min(n, 100), 1)
    # the cloud's: this process's live snapshot and every other
    # process's published one (obs/metrics.maybe_publish)
    snaps = compiles.cluster_runtime(slowest_n=n)
    families = compiles.merge_family_tables(
        [(s.get("compiles") or {}).get("families") or {} for s in snaps])
    slowest = sorted(
        (r for s in snaps
         for r in (s.get("compiles") or {}).get("slowest") or []),
        key=lambda r: float(r.get("ms") or 0.0), reverse=True)[:n]
    return {"__meta": S.meta("RuntimeV3"),
            "phases": phases.history(),
            "phase_report": snaps[0]["phase_report"],
            "wedged_phase": phases.wedged_phase(),
            "compile_families": families,
            "slowest_compiles": slowest,
            "memory": membudget.snapshot(),
            "processes": [{"proc": s.get("proc"), "ts": s.get("ts"),
                           "phase_report": s.get("phase_report"),
                           "rows_recorded":
                           (s.get("compiles") or {}).get("rows_recorded")}
                          for s in snaps]}


def h_trace_list(ctx: Ctx):
    """GET /3/Trace — newest trace ids with root span names."""
    from h2o3_tpu_torch.obs import tracing

    n = int(ctx.arg("count", 50) or 50)
    return {"__meta": S.meta("TraceV3"),
            "traces": tracing.recent_traces(max(min(n, 500), 1))}


def h_trace_get(ctx: Ctx):
    """GET /3/Trace/{trace_id} — one request's span tree."""
    from h2o3_tpu_torch.obs import tracing

    tid = ctx.params["trace_id"]
    spans = tracing.get_trace(tid)
    if not spans:
        raise ApiError(f"trace {tid!r} not found (bounded store — it may "
                       "have been evicted)", 404)
    return S.trace_v3(tid, spans, tracing.span_tree(spans))


def h_flight_list(ctx: Ctx):
    """GET /3/FlightRecords — newest-first postmortem records under the
    flight dir ($H2O_TPU_OBS_FLIGHT_DIR)."""
    from h2o3_tpu_torch.obs import flight

    return S.flight_records_v3(flight.list_records())


def h_flight_get(ctx: Ctx):
    """GET /3/FlightRecords/{name} — one record's raw JSON (the name
    pattern check is the path-traversal gate)."""
    from h2o3_tpu_torch.obs import flight

    data = flight.read_record(ctx.params["name"])
    if data is None:
        raise ApiError(f"flight record {ctx.params['name']!r} not found",
                       404)
    return RawReply(data, "application/json")


# profiler capture state: one capture at a time per process
_PROFILER_LOCK = threading.Lock()
_PROFILER = {"dir": None, "t0": None}


def h_profiler_start(ctx: Ctx):
    """POST /3/Profiler/start — begin a ``torch.profiler`` capture (CPU
    and, on the card, CUDA activities). The stop writes it as a Chrome
    trace. 409 when already capturing."""
    from h2o3_tpu_torch.utils import timeline

    log_dir = str(ctx.arg("dir", "") or "").strip('"')
    if not log_dir:
        import tempfile

        ice = os.environ.get("H2O_TPU_ICE_ROOT") or os.path.join(
            tempfile.gettempdir(), "h2o3_tpu_torch")
        log_dir = os.path.join(ice, "profiler",
                               time.strftime("%Y%m%d_%H%M%S"))
    with _PROFILER_LOCK:
        if _PROFILER["dir"] is not None:
            raise ApiError(f"a profiler capture is already running "
                           f"(dir {_PROFILER['dir']!r}) — stop it first",
                           409)
        try:
            timeline.profiler_start(log_dir)
        except Exception as e:   # noqa: BLE001 — backend refusal -> 400
            raise ApiError(f"profiler start failed: {e}", 400) from None
        _PROFILER["dir"] = log_dir
        _PROFILER["t0"] = time.perf_counter()
    timeline.record("profiler", "start", dir=log_dir)
    return {"__meta": S.meta("ProfilerV3"), "status": "capturing",
            "dir": log_dir}


def h_profiler_stop(ctx: Ctx):
    """POST /3/Profiler/stop — end the capture; returns the trace dir,
    the Chrome trace's path and the capture's duration. 400 when nothing
    is capturing."""
    from h2o3_tpu_torch.utils import timeline

    with _PROFILER_LOCK:
        if _PROFILER["dir"] is None:
            raise ApiError("no profiler capture is running", 400)
        log_dir, t0 = _PROFILER["dir"], _PROFILER["t0"]
        try:
            trace = timeline.profiler_stop()
        except Exception as e:   # noqa: BLE001
            raise ApiError(f"profiler stop failed: {e}", 400) from None
        finally:
            _PROFILER["dir"] = _PROFILER["t0"] = None
    ms = (time.perf_counter() - t0) * 1000
    timeline.record("profiler", "stop", ms=ms, dir=log_dir)
    return {"__meta": S.meta("ProfilerV3"), "status": "stopped",
            "dir": log_dir, "trace": trace, "captured_ms": round(ms, 3)}


def h_watermeter_cpu(ctx: Ctx):
    """GET /3/WaterMeterCpuTicks/{nodeidx} — per-node CPU ticks
    (water/util/WaterMeterCpuTicks); /proc-based on linux."""
    ticks = []
    try:
        with open("/proc/stat") as f:
            for ln in f:
                if ln.startswith("cpu") and ln[3:4].isdigit():
                    ticks.append([int(x) for x in ln.split()[1:5]])
    except OSError:
        pass
    return {"__meta": S.meta("WaterMeterCpuTicksV3"),
            "nodeidx": int(ctx.params.get("nodeidx", 0)),
            "cpu_ticks": ticks}


def h_watermeter_io(ctx: Ctx):
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        persist = [{"backend": "local", "store_count": 0,
                    "read_bytes": ru.ru_inblock * 512,
                    "write_bytes": ru.ru_oublock * 512}]
    except Exception:   # noqa: BLE001
        persist = []
    return {"__meta": S.meta("WaterMeterIoV3"),
            "nodeidx": int(ctx.params.get("nodeidx", -1)),
            "persist_stats": persist}


def h_rapids_help(ctx: Ctx):
    from h2o3_tpu_torch.rapids.eval import PRIMS

    return {"__meta": S.meta("RapidsHelpV3"),
            "syntax": sorted(PRIMS.keys())}


def h_sample(ctx: Ctx):
    """GET /99/Sample?dataset=frame&rows=N — uniform row sample."""
    fr = _frame_or_404(str(ctx.arg("dataset", ctx.arg("frame_id", ""))
                           or "").strip('"'))
    rows = int(ctx.arg("rows", 100) or 100)
    seed = int(ctx.arg("seed", -1) or -1)
    rng = np.random.default_rng(None if seed < 0 else seed)
    idx = np.sort(rng.choice(fr.nrows, size=min(rows, fr.nrows),
                             replace=False))
    out = fr.take_rows(idx) if hasattr(fr, "take_rows") else _take(fr, idx)
    out.install()
    return {"__meta": S.meta("FramesV3"), "frames": [
        {"frame_id": S.key_ref(str(out.key)), "rows": out.nrows}]}


def _take(fr: Frame, idx: np.ndarray) -> Frame:
    out = Frame()
    for nm in fr.names:
        c = fr.col(nm)
        dev_idx = torch.as_tensor(idx, dtype=torch.int64,
                                  device=c.data.device)
        out.add(nm, Column(c.data.index_select(0, dev_idx), c.ctype,
                           len(idx), domain=list(c.domain or []) or None))
    return out


# ---------------------------------------------------------------------------
# Frame utilities: MissingInserter / Interaction / ParseSVMLight / DCT /
# Tabulate
# ---------------------------------------------------------------------------

def h_missing_inserter(ctx: Ctx):
    """POST /3/MissingInserter — randomly NA-out a fraction of cells
    (water/api/MissingInserterHandler). In-place on the named frame."""
    fr = _frame_or_404(str(ctx.arg("dataset", "") or "").strip('"'))
    frac = float(ctx.arg("fraction", 0.1) or 0.1)
    seed = int(ctx.arg("seed", 42) or 42)
    rng = np.random.default_rng(seed)
    for nm in fr.names:
        c = fr.col(nm)
        if not (c.is_numeric or c.is_categorical):
            continue
        mask = torch.as_tensor(rng.random(c.data.shape[0]) < frac,
                               device=c.data.device)
        if c.is_categorical:
            c.data = torch.where(mask, torch.full_like(c.data, -1), c.data)
        else:
            c.data = torch.where(mask, torch.full_like(c.data, float("nan")),
                                 c.data)
    job = _done_job(f"MissingInserter {fr.key}", str(fr.key), "Key<Frame>")
    return {"__meta": S.meta("JobV3"), "job": S.job_v3(job),
            "key": S.key_ref(str(fr.key))}


def h_interaction(ctx: Ctx):
    """POST /3/Interaction — categorical interaction frame
    (hex/Interaction.java: pairwise or n-way combined factor columns)."""
    fr = _frame_or_404(str(ctx.arg("source_frame", "") or "").strip('"'))
    factors = _parse_list(ctx.arg("factor_columns")) or []
    if len(factors) < 2:
        raise ApiError("factor_columns needs >= 2 categorical columns", 400)
    pairwise = str(ctx.arg("pairwise", "false")).lower() in ("1", "true")
    max_factors = int(ctx.arg("max_factors", 100) or 100)
    dest = str(ctx.arg("dest", "") or "").strip('"') or \
        f"interaction_{uuid.uuid4().hex[:8]}"
    for nm in factors:
        if not _col_or_404(fr, nm).is_categorical:
            raise ApiError(f"column {nm!r} is not categorical", 400)

    def combine(cols):
        codes = [np.asarray(fr.col(nm).to_numpy(), np.int64) for nm in cols]
        doms = [list(fr.col(nm).domain) for nm in cols]
        combo = np.where(codes[0] < 0, 0, codes[0])   # NA -> level 0
        for c, d in zip(codes[1:], doms[1:]):
            combo = combo * len(d) + np.where(c < 0, 0, c)
        labels, combo = np.unique(combo, return_inverse=True)
        names = []
        for v in labels:
            parts = []
            for d in reversed(doms[1:]):
                parts.append(d[int(v % len(d))])
                v //= len(d)
            parts.append(doms[0][int(v)])
            names.append("_".join(reversed(parts)))
        if len(names) > max_factors:    # collapse tail to 'other'
            keep = set(range(max_factors - 1))
            combo = np.where(np.isin(combo, list(keep)), combo,
                             max_factors - 1)
            names = names[:max_factors - 1] + ["other"]
        return combo.astype(np.int32), names

    out = Frame(key=dest)
    if pairwise:
        for i in range(len(factors)):
            for j in range(i + 1, len(factors)):
                codes, names = combine([factors[i], factors[j]])
                out.add(f"{factors[i]}_{factors[j]}",
                        Column.from_numpy(codes, ctype="enum", domain=names))
    else:
        codes, names = combine(factors)
        out.add("_".join(factors),
                Column.from_numpy(codes, ctype="enum", domain=names))
    out.install()
    job = _done_job("Interaction", dest, "Key<Frame>")
    return {"__meta": S.meta("JobV3"), "job": S.job_v3(job)}


def h_parse_svmlight(ctx: Ctx):
    from h2o3_tpu_torch.ingest.parser import import_file

    srcs = _parse_list(ctx.arg("source_frames")) or \
        _parse_list(ctx.arg("source_keys")) or []
    if not srcs:
        raise ApiError("source_frames required", 400)
    path = str(srcs[0]).strip('"')
    if path.startswith("nfs:/"):
        path = path[len("nfs:"):]
    dest = str(ctx.arg("destination_frame", "") or "").strip('"') or None
    fr = import_file(path, destination_frame=dest, parse_type="SVMLight")
    job = _done_job("ParseSVMLight", str(fr.key), "Key<Frame>")
    return {"__meta": S.meta("JobV3"), "job": S.job_v3(job)}


def h_dct_transformer(ctx: Ctx):
    """POST /99/DCTTransformer — orthonormal DCT-II over each row window
    (hex/util/DCTTransformer.java; device matmul with the cosine basis)."""
    from h2o3_tpu_torch.core.runtime import full_float32

    fr = _frame_or_404(str(ctx.arg("dataset", "") or "").strip('"'))
    dims = _parse_list(ctx.arg("dimensions")) or [fr.ncols, 1, 1]
    N = int(dims[0])
    if N <= 0 or N > fr.ncols:
        raise ApiError(f"dimensions[0]={N} out of range", 400)
    dest = str(ctx.arg("destination_frame", "") or "").strip('"') or \
        f"dct_{uuid.uuid4().hex[:8]}"
    X = torch.stack([fr.col(nm).data.to(torch.float32)
                     for nm in fr.names[:N]], dim=-1)
    k = np.arange(N)[None, :]
    n = np.arange(N)[:, None]
    basis = (np.cos(np.float32(np.pi) * (2 * n + 1) * k / (2 * N))
             * np.sqrt(2.0 / N)).astype(np.float32)
    basis[:, 0] *= np.float32(1.0 / np.sqrt(2.0))
    with full_float32():
        Y = X @ torch.from_numpy(basis).to(X.device)
    out = Frame(key=dest)
    for j in range(N):
        out.add(f"DCT_{j}", Column(Y[:, j], T_NUM, fr.nrows))
    out.install()
    job = _done_job("DCTTransformer", dest, "Key<Frame>")
    return {"__meta": S.meta("JobV3"), "job": S.job_v3(job)}


def h_tabulate(ctx: Ctx):
    """POST /99/Tabulate — 2-D histogram/response table of predictor vs
    response (hex/Tabulate.java; drives h2o-py h2o.tabulate)."""
    fr = _frame_or_404(str(ctx.arg("dataset", "") or "").strip('"'))
    pred = str(ctx.arg("predictor", "") or "").strip('"')
    resp = str(ctx.arg("response", "") or "").strip('"')
    nbins_p = int(ctx.arg("nbins_predictor", 20) or 20)
    nbins_r = int(ctx.arg("nbins_response", 10) or 10)
    pc, rc = _col_or_404(fr, pred), _col_or_404(fr, resp)

    def bins(col, nb):
        v = np.asarray(col.to_numpy(), float)
        if col.domain:
            edges = None
            b = np.asarray(col.to_numpy(), np.int64)
            labels = list(col.domain)
            return b, labels
        lo, hi = np.nanmin(v), np.nanmax(v)
        edges = np.linspace(lo, hi, nb + 1)
        b = np.clip(np.searchsorted(edges, v, side="right") - 1, 0, nb - 1)
        labels = [f"{edges[i]:.4g}" for i in range(nb)]
        return b, labels

    pb, plabels = bins(pc, nbins_p)
    rb, rlabels = bins(rc, nbins_r)
    P, R = len(plabels), len(rlabels)
    pv_na = (np.asarray(pc.to_numpy(), float) != np.asarray(pc.to_numpy(), float)) \
        if not pc.domain else (np.asarray(pc.to_numpy(), np.int64) < 0)
    rv_all = np.asarray(rc.to_numpy(), float) if not rc.domain else None
    rv_na = np.isnan(rv_all) if rv_all is not None else \
        (np.asarray(rc.to_numpy(), np.int64) < 0)
    ok = ~(pv_na | rv_na)
    counts = np.zeros((P, R))
    np.add.at(counts, (np.clip(pb[ok], 0, P - 1), np.clip(rb[ok], 0, R - 1)), 1)
    count_table = S.twodim(
        f"Tabulate {pred} vs {resp}",
        [(pred, "string")] + [(str(rl), "double") for rl in rlabels],
        [list(plabels)] + [counts[:, j].tolist() for j in range(R)])
    rv = np.asarray(rc.to_numpy(), float)
    sums = np.zeros(P)
    np.add.at(sums, np.clip(pb[ok], 0, P - 1), np.nan_to_num(rv[ok]))
    denom = np.maximum(counts.sum(axis=1), 1)
    resp_table = S.twodim(
        f"Mean {resp} by {pred}",
        [(pred, "string"), ("mean_response", "double")],
        [list(plabels), (sums / denom).tolist()])
    return {"__meta": S.meta("TabulateV3"),
            "count_table": count_table, "response_table": resp_table}


# ---------------------------------------------------------------------------
# Grid import/export (water/api/GridImportExportHandler)
# ---------------------------------------------------------------------------

def h_grid_export(ctx: Ctx):
    from h2o3_tpu_torch.grid import H2OGridSearch

    gid = ctx.params["grid_id"]
    grid = DKV.get(gid)
    if not isinstance(grid, H2OGridSearch):
        raise ApiError(f"grid {gid!r} not found", 404)
    d = str(ctx.arg("grid_directory", ctx.arg("dir", "")) or "").strip('"')
    if not d:
        raise ApiError("grid_directory required", 400)
    os.makedirs(d, exist_ok=True)
    grid.save(d)
    return {"__meta": S.meta("GridSearchV99"), "grid_id":
            S.key_ref(gid, "Key<Grid>")}


def h_grid_import(ctx: Ctx):
    from h2o3_tpu_torch.grid import H2OGridSearch

    path = str(ctx.arg("grid_path", ctx.arg("dir", "")) or "").strip('"')
    if not path or not os.path.exists(path):
        raise ApiError(f"no grid at {path!r}", 404)
    try:
        grid = H2OGridSearch.load(path)
    except TypeError as e:
        raise ApiError(str(e), 400) from None
    return {"__meta": S.meta("GridSearchV99"),
            "grid_id": S.key_ref(str(grid.key), "Key<Grid>")}


def h_grids_list(ctx: Ctx):
    from h2o3_tpu_torch.grid import H2OGridSearch

    grids = [DKV.get(k) for k in DKV.keys()]
    grids = [g for g in grids if isinstance(g, H2OGridSearch)]
    return {"__meta": S.meta("GridsV99"),
            "grids": [{"grid_id": S.key_ref(str(g.key), "Key<Grid>"),
                       "model_count": len(g.models)} for g in grids]}


# ---------------------------------------------------------------------------
# Assembly (water/api/AssemblyV99)
# ---------------------------------------------------------------------------

def h_assembly_fit(ctx: Ctx):
    """POST /99/Assembly — run a munging pipeline on a frame (h2o-py
    H2OAssembly.fit); steps arrive as the stringified ast list."""
    from h2o3_tpu_torch import assembly as A

    fr = _frame_or_404(str(ctx.arg("frame", "") or "").strip('"'))
    steps_raw = ctx.arg("steps")
    steps = _parse_list(steps_raw) or []
    aid = str(ctx.arg("assembly_id", "") or "").strip('"') or \
        f"assembly_{uuid.uuid4().hex[:8]}"
    try:
        pipe = A.H2OAssembly.from_steps(steps)
    except ValueError as e:
        raise ApiError(str(e), 400) from None
    out = pipe.fit(fr)
    out.install()
    DKV.put(aid, pipe)
    return {"__meta": S.meta("AssemblyV99"),
            "assembly": {"name": aid},
            "assembly_id": S.key_ref(aid, "Key<Assembly>"),
            "result": {"name": str(out.key)}}


def h_assembly_pipeline(ctx: Ctx):
    """POST /99/Assembly/{assembly_id}/pipeline — export the assembly's
    munge fused with a model as a standalone *pipeline artifact*
    (artifact/pipeline.py): one program from raw columns to prediction,
    scored by the artifact runner with no munge replay."""
    from h2o3_tpu_torch import artifact
    from h2o3_tpu_torch import assembly as A

    pipe = DKV.get(ctx.params["assembly_id"])
    if not isinstance(pipe, A.H2OAssembly):
        raise ApiError(
            f"assembly {ctx.params['assembly_id']!r} not found", 404)
    fr = _frame_or_404(str(ctx.arg("frame", "") or "").strip('"'))
    m = _model_or_404(str(ctx.arg("model_id", "") or "").strip('"'))
    out_dir = str(ctx.arg("dir", "") or "").strip('"')
    if not out_dir:
        raise ApiError("dir required (server-side artifact directory)", 400)
    raw_buckets = _parse_list(ctx.arg("buckets")) or None
    try:
        buckets = [int(b) for b in raw_buckets] if raw_buckets else None
    except (TypeError, ValueError):
        raise ApiError(f"buckets must be integers, got {raw_buckets!r}",
                       400) from None
    try:
        man = pipe.export_pipeline(m, fr, out_dir, buckets=buckets)
    except artifact.ArtifactError as e:
        raise ApiError(str(e), 400) from None
    return {"__meta": S.meta("AssemblyPipelineV99"),
            "assembly_id": S.key_ref(ctx.params["assembly_id"],
                                     "Key<Assembly>"),
            "model_id": str(m.key),
            "dir": out_dir,
            "model_type": man.get("model_type"),
            "inner": (man.get("pipeline") or {}).get("inner"),
            "inputs": [i.get("name")
                       for i in (man.get("pipeline") or {}).get("inputs",
                                                                [])],
            "buckets": man.get("buckets"),
            "executables": len(man.get("executables") or [])}


def h_assembly_java(ctx: Ctx):
    """GET /99/Assembly.java/{assembly_id}/{pojo_name} — the munging
    pipeline as source (reference emits a Java MungeTransformer; we emit a
    self-contained numpy transform for the same steps)."""
    pipe = DKV.get(ctx.params["assembly_id"])
    if pipe is None:
        raise ApiError(f"assembly {ctx.params['assembly_id']!r} not found", 404)
    name = ctx.params.get("pojo_name", "MungePipeline")
    src = getattr(pipe, "to_source", lambda n: None)(name)
    if src is None:
        src = f"# assembly {ctx.params['assembly_id']}: " \
              f"steps={getattr(pipe, 'describe', lambda: [])()}\n"
    return RawReply(src.encode(), "text/plain",
                    headers={"Content-Disposition":
                             f'attachment; filename="{name}.java"'})


# ---------------------------------------------------------------------------
# Gated integrations (route exists, actionable error when SDK absent)
# ---------------------------------------------------------------------------

def h_import_hive(ctx: Ctx):
    from h2o3_tpu_torch.ingest.sql import import_sql_table

    table = str(ctx.arg("table_name", "") or "").strip('"')
    url = str(ctx.arg("hive_jdbc_url", ctx.arg("database", "")) or "").strip('"')
    if not table:
        raise ApiError("table_name required", 400)
    try:
        fr = import_sql_table(url or "hive://", table)
    except Exception as e:   # noqa: BLE001 — map driver absence to 501
        raise ApiError(
            f"Hive import needs a DB-API Hive driver (pyhive/impyla) on the "
            f"server: {e}", 501) from None
    fr.install()
    job = _done_job("ImportHiveTable", str(fr.key), "Key<Frame>")
    return {"__meta": S.meta("JobV3"), "job": S.job_v3(job)}


def h_save_to_hive(ctx: Ctx):
    raise ApiError("SaveToHiveTable needs a DB-API Hive driver "
                   "(pyhive/impyla) on the server", 501)


def h_decryption_setup(ctx: Ctx):
    """POST /3/DecryptionSetup — register a decryption tool for parse
    (water/parser/DecryptionTool). The null tool (passthrough) is built in;
    AES-SPEC tools need the 'cryptography' package."""
    from h2o3_tpu_torch.ingest import decrypt

    tool = str(ctx.arg("decrypt_tool", "") or "").strip('"') or \
        "water.parser.NullDecryptionTool"
    tool_id = str(ctx.arg("decrypt_impl", "") or "").strip('"') or \
        f"decrypt_{uuid.uuid4().hex[:8]}"
    params = {
        "keystore_type": str(ctx.arg("keystore_type", "") or "").strip('"'),
        "key_alias": str(ctx.arg("key_alias", "") or "").strip('"'),
        "password": str(ctx.arg("password", "") or "").strip('"'),
        "cipher_spec": str(ctx.arg("cipher_spec", "") or "").strip('"'),
    }
    decrypt.register_tool(tool_id, tool, params)
    return {"__meta": S.meta("DecryptionSetupV3"), "decrypt_tool_id":
            S.key_ref(tool_id, "Key<DecryptionTool>")}


# ---------------------------------------------------------------------------
# route table extension
# ---------------------------------------------------------------------------

EXTRA_ROUTES = [
    ("GET", "/3/Capabilities", h_capabilities, "All capabilities"),
    ("GET", "/3/Capabilities/API", h_capabilities_api, "REST capabilities"),
    ("GET", "/3/Capabilities/Core", h_capabilities_core, "Core capabilities"),
    ("GET", "/3/Frames/{frame_id}/columns", h_frame_columns, "Frame columns"),
    ("GET", "/3/Frames/{frame_id}/columns/{column}", h_frame_column,
     "One column"),
    ("GET", "/3/Frames/{frame_id}/columns/{column}/domain",
     h_frame_column_domain, "Column domain"),
    ("GET", "/3/Frames/{frame_id}/columns/{column}/summary",
     h_frame_column_summary, "Column summary"),
    ("GET", "/3/FrameChunks/{frame_id}", h_frame_chunks, "Frame chunk layout"),
    ("POST", "/3/Frames/{frame_id}/export", h_frame_export, "Export frame"),
    ("GET", "/3/Frames/{frame_id}/export/{path}/overwrite/{force}",
     h_frame_export, "Export frame (legacy)"),
    ("POST", "/3/Frames/{frame_id}/save", h_frame_save, "Save frame binary"),
    ("POST", "/3/Frames/load", h_frame_load, "Load saved frame"),
    ("DELETE", "/3/Frames", h_frames_delete_all, "Delete all frames"),
    ("DELETE", "/3/Models", h_models_delete_all, "Delete all models"),
    ("GET", "/3/Models.fetch.bin/{model_id}", h_model_fetch_bin,
     "Model binary artifact"),
    ("GET", "/99/Models.bin/{model_id}", h_model_fetch_bin,
     "Model binary artifact (v99)"),
    ("POST", "/99/Models.bin/{model_id}", h_model_save_bin,
     "Save model binary to dir"),
    ("POST", "/99/Models.bin/", h_model_load_bin, "Load model binary"),
    ("POST", "/99/Models.upload.bin/{model_id}", h_model_upload_bin,
     "Upload model binary"),
    ("GET", "/99/Models.mojo/{model_id}",
     None, "Export MOJO (v99 alias)"),                      # filled below
    ("GET", "/3/Models.java/{model_id}", h_model_java, "POJO source"),
    ("GET", "/3/Models.java/{model_id}/preview", h_model_java_preview,
     "POJO preview"),
    ("GET", "/99/Models/{model_id}/json", h_model_json, "Model JSON (v99)"),
    ("GET", "/3/ModelMetrics", h_modelmetrics_list, "All cached metrics"),
    ("GET", "/3/ModelMetrics/models/{model}", h_modelmetrics_list,
     "Metrics for model"),
    ("GET", "/3/ModelMetrics/frames/{frame}", h_modelmetrics_list,
     "Metrics on frame"),
    ("GET", "/3/ModelMetrics/models/{model}/frames/{frame}",
     h_modelmetrics_list, "Metrics for model on frame"),
    ("GET", "/3/ModelMetrics/frames/{frame}/models/{model}",
     h_modelmetrics_list, "Metrics for model on frame"),
    ("DELETE", "/3/ModelMetrics", h_modelmetrics_delete, "Drop cached metrics"),
    ("DELETE", "/3/ModelMetrics/models/{model}", h_modelmetrics_delete,
     "Drop metrics for model"),
    ("DELETE", "/3/ModelMetrics/frames/{frame}", h_modelmetrics_delete,
     "Drop metrics on frame"),
    ("DELETE", "/3/ModelMetrics/models/{model}/frames/{frame}",
     h_modelmetrics_delete, "Drop metrics"),
    ("DELETE", "/3/ModelMetrics/frames/{frame}/models/{model}",
     h_modelmetrics_delete, "Drop metrics"),
    ("POST", "/3/ModelMetrics/predictions_frame/{predictions_frame}"
             "/actuals_frame/{actuals_frame}",
     h_modelmetrics_predictions_vs_actuals, "Metrics from predictions"),
    ("GET", "/3/NodePersistentStorage/configured", h_nps_configured,
     "NPS configured?"),
    ("GET", "/3/NodePersistentStorage/categories/{category}/exists",
     h_nps_category_exists, "NPS category exists?"),
    ("GET", "/3/NodePersistentStorage/categories/{category}/names/{name}"
            "/exists", h_nps_name_exists, "NPS entry exists?"),
    ("GET", "/3/NodePersistentStorage/{category}", h_nps_list, "NPS list"),
    ("GET", "/3/NodePersistentStorage/{category}/{name}", h_nps_get,
     "NPS fetch"),
    ("POST", "/3/NodePersistentStorage/{category}", h_nps_put, "NPS store"),
    ("POST", "/3/NodePersistentStorage/{category}/{name}", h_nps_put,
     "NPS store named"),
    ("DELETE", "/3/NodePersistentStorage/{category}/{name}", h_nps_delete,
     "NPS delete"),
    ("GET", "/3/JStack", h_jstack, "Thread stack dump"),
    ("GET", "/3/KillMinus3", h_kill_minus_3, "Log thread dump"),
    ("POST", "/3/LogAndEcho", h_log_and_echo, "Log a message"),
    ("GET", "/3/Logs/nodes/{nodeidx}/files/{name}", h_logs_node_file,
     "Per-node log file"),
    ("GET", "/3/Typeahead/files", h_typeahead_files, "Path completion"),
    ("GET", "/3/Find", h_find, "Find value in frame"),
    ("POST", "/3/CloudLock", h_cloud_lock, "Lock the cloud"),
    ("POST", "/3/GarbageCollect", h_gc, "Run GC + cleaner sweep"),
    ("POST", "/3/UnlockKeys", h_unlock_keys, "Unlock all keys"),
    ("GET", "/3/SteamMetrics", h_steam_metrics, "Steam health metrics"),
    ("GET", "/3/CloudStatus", h_cloud_status,
     "Supervised cloud health state machine"),
    ("GET", "/3/ScoringMetrics", h_scoring_metrics,
     "Serving fast-path scoring metrics"),
    ("GET", "/3/Metrics", h_metrics,
     "Cluster-wide metrics (Prometheus text / JSON)"),
    ("GET", "/3/Runtime", h_runtime,
     "Lifecycle phase history + cluster compile ledger"),
    ("GET", "/3/Trace", h_trace_list, "Recent trace ids"),
    ("GET", "/3/Trace/{trace_id}", h_trace_get, "One request's span tree"),
    ("GET", "/3/FlightRecords", h_flight_list,
     "List flight-recorder postmortems"),
    ("GET", "/3/FlightRecords/{name}", h_flight_get,
     "Fetch one flight record"),
    ("POST", "/3/Profiler/start", h_profiler_start,
     "Start a torch.profiler capture"),
    ("POST", "/3/Profiler/stop", h_profiler_stop,
     "Stop the profiler capture (Chrome trace)"),
    ("GET", "/3/WaterMeterCpuTicks/{nodeidx}", h_watermeter_cpu,
     "CPU tick counters"),
    ("GET", "/3/WaterMeterIo", h_watermeter_io, "IO counters"),
    ("GET", "/3/WaterMeterIo/{nodeidx}", h_watermeter_io,
     "IO counters (node)"),
    ("GET", "/99/Rapids/help", h_rapids_help, "Rapids primitive list"),
    ("GET", "/99/Sample", h_sample, "Sample rows from a frame"),
    ("POST", "/3/MissingInserter", h_missing_inserter, "Insert missing values"),
    ("POST", "/3/Interaction", h_interaction, "Categorical interactions"),
    ("POST", "/3/ParseSVMLight", h_parse_svmlight, "Parse SVMLight file"),
    ("POST", "/99/DCTTransformer", h_dct_transformer, "Row-window DCT"),
    ("POST", "/99/Tabulate", h_tabulate, "Predictor-response table"),
    ("POST", "/3/Grid.bin/{grid_id}/export", h_grid_export, "Export grid"),
    ("POST", "/3/Grid.bin/import", h_grid_import, "Import grid"),
    ("GET", "/99/Grids", h_grids_list, "List grids"),
    ("POST", "/99/Assembly", h_assembly_fit, "Fit a munging assembly"),
    ("POST", "/99/Assembly/{assembly_id}/pipeline", h_assembly_pipeline,
     "Export assembly+model as a standalone pipeline artifact"),
    ("GET", "/99/Assembly.java/{assembly_id}/{pojo_name}", h_assembly_java,
     "Assembly pipeline source"),
    ("POST", "/3/ImportHiveTable", h_import_hive, "Import a Hive table"),
    ("POST", "/3/SaveToHiveTable", h_save_to_hive, "Save to Hive table"),
    ("POST", "/3/DecryptionSetup", h_decryption_setup,
     "Register a parse decryption tool"),
    ("GET", "/3/Metadata/endpoints/{path}", h_metadata_endpoint,
     "One endpoint's metadata"),
    ("GET", "/3/Metadata/schemaclasses/{classname}", h_metadata_schemaclass,
     "Schema detail by class name"),
]


def register(routes: list, handlers: dict) -> None:
    """Append EXTRA_ROUTES onto the server ROUTES table; `handlers` maps
    names already defined in server.py reused by aliases. Idempotent —
    both server.py's bottom and _ensure_registered may call it."""
    if any(r[2] is h_capabilities for r in routes):
        return
    mojo = handlers["h_model_mojo"]
    importfiles = handlers["h_importfiles"]
    pdp_post = handlers["h_pdp_post"]
    pdp_get = handlers["h_pdp_get"]
    fixed = []
    for m, p, h, s in EXTRA_ROUTES:
        if h is None and "Models.mojo" in p:
            h = mojo
        fixed.append((m, p, h, s))
    fixed += [
        ("POST", "/3/ImportFiles", importfiles, "List importable files"),
        # reference singular spellings of PartialDependence
        ("POST", "/3/PartialDependence/", pdp_post, "Compute PDP"),
        ("GET", "/3/PartialDependence/{key}", pdp_get, "PDP result"),
        # train-with-model_id spelling (TrainModelV3 model_id path segment);
        # the train handler reads model_id from the body either way
        ("POST", "/3/ModelBuilders/{algo}/model_id", handlers.get(
            "h_modelbuilder_train", importfiles), "Train with model_id"),
        ("DELETE", "/3/InitID", handlers.get("h_session_end_legacy",
                                             importfiles), "End session"),
    ]
    routes.extend(fixed)


def _ensure_registered():
    """Import-order independence: when THIS module is imported before
    server.py finishes (server's bottom couldn't call register on the
    partial module), append + recompile here instead."""
    srv = sys.modules.get("h2o3_tpu_torch.api.server")
    if srv is None or not hasattr(srv, "_COMPILED"):
        return      # server mid-import: its bottom registers us
    if any(r[2] is h_capabilities for r in srv.ROUTES):
        return      # already registered
    register(srv.ROUTES, {"h_model_mojo": srv.h_model_mojo,
                          "h_importfiles": srv.h_importfiles,
                          "h_pdp_post": srv.h_pdp_post,
                          "h_pdp_get": srv.h_pdp_get,
                          "h_modelbuilder_train": srv.h_modelbuilder_train,
                          "h_session_end_legacy": srv.h_session_end})
    srv._COMPILED = srv._compile_routes()


_ensure_registered()
