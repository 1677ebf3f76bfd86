"""REST API server: the /3 (+/4, /99) HTTP surface stock h2o-py speaks
(counterpart of h2o3_tpu/api/server.py, with the same routes and wire
format).

Reference: water/api/RequestServer.java:56 with the RegisterV3Api.java
route table and the water/api/schemas3 DTO layer. The HTTP layer is a
stdlib ThreadingHTTPServer: the API carries JSON metadata, and the heavy
data stays on the card.

Design: a declarative ROUTES table (method, pattern, handler, summary)
drives both dispatch and the self-describing /3/Metadata/endpoints
listing (water/api/SchemaServer.java:20).

Contract notes:
- every schema'd response carries __meta.schema_name; h2o-py's
  H2OResponse.__new__ (backend/connection.py:869) dispatches on it.
- jobs flow: POST returns {"job": JobV3}; the client polls
  GET /3/Jobs/{key}.
- model builds are asynchronous background Jobs, like
  hex/ModelBuilder.trainModel() (:359).

The handlers call `parallel/` (oplog, ckpt, supervisor) at the
reference's sites. In one process those calls are no-ops (see
h2o3_tpu_torch/parallel/__init__.py), so every handler runs its work in
this process; the multi-process control plane fills them in without
touching the routes.

A server runs on the device `core/runtime.init` booted: the card unless
the caller booted ``device="cpu"``. `start_server` never falls back to
the CPU: with no booted device and no card it raises.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np
import torch

from h2o3_tpu_torch import admission
from h2o3_tpu_torch.admission import AdmissionRejected
from h2o3_tpu_torch.memory import MemoryPressureError
from h2o3_tpu_torch.api import schemas as S
from h2o3_tpu_torch.obs import metrics as obs_metrics
from h2o3_tpu_torch.obs import tracing
from h2o3_tpu_torch.core.dkv import DKV, Key
from h2o3_tpu_torch.core.failure import CloudUnhealthyError
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.job import Job
from h2o3_tpu_torch.models.model import Model
from h2o3_tpu_torch.parallel.oplog import OplogPublishError, OplogTurnTimeout
from h2o3_tpu_torch.rapids import Session, exec_rapids

_SESSIONS: Dict[str, Session] = {}
_TIMELINE: List[dict] = []          # ring of recent requests (water/TimeLine.java:22)
_TIMELINE_MAX = 2048


def _timeline_record(method: str, path: str, status: int, ms: float):
    _TIMELINE.append({"time_ms": int(time.time() * 1000), "method": method,
                      "path": path, "status": status, "duration_ms": round(ms, 3)})
    if len(_TIMELINE) > _TIMELINE_MAX:
        del _TIMELINE[: len(_TIMELINE) - _TIMELINE_MAX]


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, torch.Tensor):
        # CUDA tensors too: one copy to the host
        return o.detach().cpu().tolist()
    return str(o)


def frame_csv_bytes(fr: Frame) -> bytes:
    """The frame as CSV, in the bytes pandas' ``to_csv(index=False)``
    writes for the reference's ``to_pandas()``: a header, enum labels,
    strings, numbers as their dtype's shortest repr
    (``ndarray.astype(str)``, as pandas formats them; a bf16 column's as
    float64 reprs), NA as an empty
    field, ``\\n`` line ends, minimal quoting. No pandas."""
    import csv

    cols = []
    for name in fr.names:
        c = fr.col(name)
        if c.is_categorical or c.data is None:
            cols.append(["" if v is None or (isinstance(v, float) and v != v)
                         else str(v) for v in c.values()])
        else:
            arr = c.to_numpy()
            # a bf16 column reaches pandas as ml_dtypes bfloat16, which it
            # writes as each value's float64 repr; to_numpy widened it to
            # float32 exactly, and float64 widens that exactly again
            txt = (arr.astype(np.float64) if c.data.dtype == torch.bfloat16
                   else arr).astype(str)
            if arr.dtype.kind == "f":
                txt[np.isnan(arr)] = ""
            cols.append(txt.tolist())
    buf = io.StringIO()
    w = csv.writer(buf, lineterminator="\n")
    w.writerow(fr.names)
    w.writerows(zip(*cols))
    return buf.getvalue().encode()


# unquoted NaN/Infinity as json.dumps emits them: preceded by a structural
# character, never inside a quoted string (dumps escapes quotes, so a
# [,: or space before the token means it is a bare literal)
_BARE_NONFINITE = re.compile(rb"[\[,:\s](?:NaN|-?Infinity)[,\]\}\s]")


def _definite(o):
    """Recursively replace non-finite floats with None (the slow path of
    _reply_json, taken only when the fast serialization contains NaN)."""
    if isinstance(o, float):
        return o if math.isfinite(o) else None
    if isinstance(o, np.floating):
        f = float(o)
        return f if math.isfinite(f) else None
    if isinstance(o, dict):
        return {k: _definite(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_definite(v) for v in o]
    if isinstance(o, np.ndarray):
        return _definite(o.tolist())
    return o


def _parse_list(v) -> Optional[list]:
    """Tolerant list parse: accepts JSON, h2o-py stringify_list ('[a,b]' with
    optionally-quoted items), or an actual list."""
    if v is None:
        return None
    if isinstance(v, list):
        return v
    s = str(v).strip()
    if not s.startswith("["):
        return [s.strip('"')]
    try:
        return json.loads(s)
    except ValueError:
        inner = s[1:-1].strip()
        if not inner:
            return []
        return [p.strip().strip('"').strip("'") for p in inner.split(",")]


def _coerce(v: Any, template: Any) -> Any:
    """Coerce a form-encoded string to the type of a default value."""
    if not isinstance(v, str):
        return v
    s = v.strip()
    if s.startswith("[") or s.startswith("{"):
        try:
            return json.loads(s)
        except ValueError:
            return _parse_list(s)
    if isinstance(template, bool):
        return s.lower() in ("true", "1")
    if isinstance(template, int) and not isinstance(template, bool):
        try:
            return int(float(s))
        except ValueError:
            return s.strip('"')
    if isinstance(template, float):
        try:
            return float(s)
        except ValueError:
            return s.strip('"')
    if isinstance(template, (list, tuple)):
        return _parse_list(s)
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s.strip('"')


def _frame_or_404(fid: str) -> Frame:
    fr = DKV.get(fid)
    if not isinstance(fr, Frame):
        raise ApiError(f"Object '{fid}' not found for argument: frame", 404)
    return fr


def _model_or_404(mid: str) -> Model:
    m = DKV.get(mid)
    if not isinstance(m, Model):
        raise ApiError(f"Object '{mid}' not found for argument: model", 404)
    return m


class ApiError(Exception):
    def __init__(self, msg: str, status: int = 400, schema: str = "H2OErrorV3"):
        super().__init__(msg)
        self.status = status
        self.schema = schema


# ---------------------------------------------------------------------------
# handlers (each: fn(ctx) -> (obj, status)); ctx carries path/query/body
# ---------------------------------------------------------------------------

class Ctx:
    def __init__(self, params: Dict[str, str], query: Dict[str, str],
                 body: Dict[str, Any], server: "ApiServer"):
        self.params = params
        self.query = query
        self.body = body
        self.server = server

    def arg(self, name: str, default=None):
        # parse_qs already URL-decoded form/query values; JSON was never
        # encoded — do NOT unquote again (it corrupts literal '%xx').
        return self.body.get(name, self.query.get(name, default))


def h_cloud(ctx: Ctx):
    from h2o3_tpu_torch.core.failure import cluster_health
    from h2o3_tpu_torch.core.runtime import cluster_info
    from h2o3_tpu_torch.parallel import supervisor

    out = S.cloud_v3(cluster_info())
    hb = cluster_health()
    if hb:          # multi-process cloud: liveness table per process
        from h2o3_tpu_torch.parallel import ckpt, oplog
        from h2o3_tpu_torch.parallel import distributed as D

        out["process_health"] = hb
        out["cloud_healthy"] = bool(out.get("cloud_healthy", True)) and \
            all(r["healthy"] for r in hb)
        out.update(epoch=D.epoch(), leader=D.leader(),
                   checkpoint_seq=ckpt.latest_seq(),
                   rejoins=oplog.rejoin_records())
    info = cluster_info()
    if info.get("row_mesh") is not None:
        # the row mesh: rank, size, backend (and why), generation
        out["row_mesh"] = info["row_mesh"]
    # supervised health state machine (HEALTHY/DEGRADED/FAILED); detail at
    # GET /3/CloudStatus
    out["cloud_status"] = supervisor.state()
    if out["cloud_status"] != supervisor.HEALTHY:
        out["cloud_healthy"] = False
    return out


def h_about(ctx: Ctx):
    return {"__meta": S.meta("AboutV3"), "entries": [
        {"name": "Build project", "value": "h2o3_tpu_torch"},
        {"name": "Build version", "value": S.SERVER_VERSION},
        {"name": "Backend", "value": "PyTorch/CUDA (H100)"}]}


def h_ping(ctx: Ctx):
    return {"__meta": S.meta("PingV3"), "status": "running"}


def h_session_new(ctx: Ctx):
    sid = f"_sid{uuid.uuid4().hex[:12]}"
    _SESSIONS[sid] = Session(sid)
    return {"__meta": S.meta("InitIDV3"), "session_key": sid}


def h_session_end(ctx: Ctx):
    sid = ctx.params.get("session_key", "")
    sess = _SESSIONS.pop(sid, None)
    if sess is not None:
        sess.end()
    return {"__meta": S.meta("InitIDV3"), "session_key": sid}


def h_shutdown(ctx: Ctx):
    threading.Thread(target=ctx.server.stop, daemon=True).start()
    return {"__meta": S.meta("ShutdownV3"), "result": "shutting down"}


def h_logs(ctx: Ctx):
    import logging

    lines: List[str] = []
    for h in logging.getLogger("h2o3_tpu_torch").handlers:
        f = getattr(h, "baseFilename", None)
        if f:
            try:
                with open(f) as fh:
                    lines = fh.read().splitlines()[-500:]
            except OSError:
                pass
    return {"__meta": S.meta("LogsV3"), "log": "\n".join(lines)}


def h_timeline(ctx: Ctx):
    """REST request ring merged with the framework TimeLine (scoring
    flushes, phases, captures, profiler runs, probes) —
    water/TimeLine.java:22 + TimelineHandler."""
    from h2o3_tpu_torch.utils import timeline

    evs = ([dict(e, kind="rest") for e in _TIMELINE] + timeline.events())
    evs.sort(key=lambda e: e.get("time_ms", 0))
    return {"__meta": S.meta("TimelineV3"), "events": evs}


def h_profiler(ctx: Ctx):
    """GET /3/Profiler — per-device memory gauges from the CUDA caching
    allocator (the reference's JVM stack profiles map to device memory
    pressure here)."""
    from h2o3_tpu_torch.utils import timeline

    return {"__meta": S.meta("ProfilerV3"), "nodes": timeline.device_memory()}


def h_flow(ctx: Ctx):
    """Serve the Flow single-page app (api/flow.html): import → parse →
    train → leaderboard → predict over the existing REST routes. Falls back
    to the plain status dashboard if the packaged asset is missing.
    Reference: h2o-web/ Flow notebook packaging."""
    fpath = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "flow.html")
    if os.path.exists(fpath):
        with open(fpath, "rb") as f:
            return RawReply(f.read(), "text/html")
    return h_flow_status(ctx)


def h_flow_status(ctx: Ctx):
    """Plain status dashboard (the landing page when flow.html is
    missing)."""
    from h2o3_tpu_torch.core.runtime import cluster_info

    import html as _html

    esc = _html.escape
    info = cluster_info()
    frames = [str(k) for k in DKV.keys() if isinstance(DKV.get(k), Frame)]
    models = [str(k) for k in DKV.keys() if isinstance(DKV.get(k), Model)]
    # keys are caller-controlled strings: escape everything interpolated
    rows_f = "".join(f"<li><code>{esc(f)}</code></li>" for f in frames[:50])
    rows_m = "".join(f"<li><code>{esc(m)}</code></li>" for m in models[:50])
    html = f"""<!doctype html><html><head><title>h2o3-tpu</title>
<style>body{{font-family:sans-serif;margin:2em}}code{{background:#eee}}</style>
</head><body>
<h1>h2o3-tpu</h1>
<p>cloud <b>{esc(str(info['cloud_name']))}</b> — {info['cloud_size']} devices on
<b>{esc(str(info['platform']))}</b>, healthy: {info['cloud_healthy']}</p>
<h2>Frames ({len(frames)})</h2><ul>{rows_f or '<li>none</li>'}</ul>
<h2>Models ({len(models)})</h2><ul>{rows_m or '<li>none</li>'}</ul>
<p>REST: <a href="/3/Cloud">/3/Cloud</a> ·
<a href="/3/Frames">/3/Frames</a> · <a href="/3/Models">/3/Models</a> ·
<a href="/3/Timeline">/3/Timeline</a> ·
<a href="/3/Metadata/endpoints">/3/Metadata/endpoints</a></p>
</body></html>"""
    return RawReply(html.encode(), "text/html")


# -- import / parse ---------------------------------------------------------

def _list_files(path: str) -> List[str]:
    import glob as _g
    import os

    if any(ch in path for ch in "*?"):
        return sorted(_g.glob(path))
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path))
    return [path] if os.path.exists(path) or "://" in path else []


def h_importfiles(ctx: Ctx):
    path = ctx.arg("path", "")
    files = _list_files(path)
    return {"__meta": S.meta("ImportFilesV3"), "path": path,
            "files": files, "destination_frames": files,
            "fails": [] if files else [path], "dels": []}


def h_importfiles_multi(ctx: Ctx):
    paths = _parse_list(ctx.arg("paths")) or []
    files: List[str] = []
    fails: List[str] = []
    for p in paths:
        got = _list_files(p)
        files.extend(got)
        if not got:
            fails.append(p)
    return {"__meta": S.meta("ImportFilesMultiV3"), "paths": paths,
            "files": files, "destination_frames": files, "fails": fails,
            "dels": []}


def h_postfile(ctx: Ctx):
    """Multipart upload → raw file key (upload_file path)."""
    dest = ctx.query.get("destination_frame") or f"upload_{uuid.uuid4().hex[:8]}"
    data = ctx.body.get("__file__")
    if data is None:
        raise ApiError("no file payload", 400)
    import os
    import tempfile

    d = tempfile.mkdtemp(prefix="h2o3_upload_")
    fpath = os.path.join(d, dest.replace("/", "_"))
    with open(fpath, "wb") as f:
        f.write(data)
    DKV.put(dest, fpath)          # raw file key → local path
    return {"__meta": S.meta("PostFileV3"), "destination_frame": dest,
            "total_bytes": len(data)}


def _resolve_sources(paths: List[str]) -> List[str]:
    """Map source_frames entries (raw upload keys or literal paths) to paths."""
    out = []
    for p in paths:
        v = DKV.get(p)
        out.append(v if isinstance(v, str) else p)
    return out


def h_parsesetup(ctx: Ctx):
    from h2o3_tpu_torch.ingest.parse_setup import guess_setup

    paths = [p.strip('"') for p in (_parse_list(ctx.arg("source_frames")) or [])]
    if not paths:
        raise ApiError("source_frames required", 400)
    real = _resolve_sources(paths)
    setup = guess_setup(real[0])
    col_names = ctx.arg("column_names")
    col_types = ctx.arg("column_types")
    sep = ctx.arg("separator")
    check_header = ctx.arg("check_header")
    names = _parse_list(col_names) if col_names else setup.column_names
    types = _parse_list(col_types) if col_types else setup.column_types
    return {
        "__meta": S.meta("ParseSetupV3"),
        "source_frames": [{"__meta": S.meta("FrameKeyV3"), "name": p} for p in paths],
        "parse_type": "CSV",
        "separator": int(sep) if sep else ord(setup.separator),
        "single_quotes": False,
        "check_header": int(check_header) if check_header is not None else setup.check_header,
        "column_names": names,
        "column_types": types,
        "na_strings": None,
        "number_columns": len(names or types or []),
        "skipped_columns": [],
        "custom_non_data_line_markers": None,
        "partition_by": None,
        "destination_frame": _default_dest(paths[0]),
        "header_lines": 0,
        "chunk_size": 1 << 22,
        "total_filtered_column_count": len(names or types or []),
        "warnings": [],
    }


def _default_dest(path: str) -> str:
    base = path.rstrip("/").split("/")[-1]
    base = re.sub(r"\.(csv|tsv|txt|dat|gz|zip)$", "", base, flags=re.I)
    key = re.sub(r"[^\w.]", "_", base) + ".hex"
    return key


def h_parse(ctx: Ctx):
    from h2o3_tpu_torch.ingest.parser import import_file

    paths = [p.strip('"') for p in (_parse_list(ctx.arg("source_frames")) or [])]
    real = _resolve_sources(paths)
    dest = (str(ctx.arg("destination_frame") or "")).strip('"') or _default_dest(paths[0])
    col_names = [str(c).strip('"') for c in (_parse_list(ctx.arg("column_names")) or [])] or None
    col_types = [str(c).strip('"') for c in (_parse_list(ctx.arg("column_types")) or [])] or None
    check_header = ctx.arg("check_header")
    from h2o3_tpu_torch.parallel import oplog

    if oplog.active() and len(real) > 1:
        # before Job() so a rejected request leaves no phantom CREATED job
        raise ApiError("multi-file parse over REST is not yet "
                       "supported on a multi-process cloud", 501)
    job = Job(description="Parse")
    job.dest_type = "Key<Frame>"
    job.dest_key = dest

    # followers must run the SAME parse so the sharded frame materializes
    # on every process of the cloud
    op_seq = oplog.broadcast("import_file", {
        "path": real[0], "destination_frame": dest,
        "col_names": col_names, "col_types": col_types,
        "header": int(check_header) if check_header is not None else None})

    def run(j: Job):
        from h2o3_tpu_torch.parallel import oplog as _ol

        kw = dict(col_names=col_names, col_types=col_types,
                  header=int(check_header) if check_header is not None else 0)
        with _ol.turn(op_seq):
            fr = import_file(real[0], destination_frame=dest, **kw)
        if len(real) > 1:
            # multi-file import: parse each file and stack (reference
            # MultiFileParseTask parses all byte-chunks into ONE frame,
            # water/parser/ParseDataset.java:623)
            from h2o3_tpu_torch.ops.filters import rbind

            parts = [fr]
            for i, p in enumerate(real[1:]):
                j.update(progress=(i + 1) / len(real), msg=f"parsing {p}")
                parts.append(import_file(p, destination_frame=f"{dest}_part{i+1}", **kw))
            fr = rbind(parts, key=dest)
            for part in parts:
                part.delete()
            fr.install()
        j.dest_key = str(fr.key)
        return fr

    job.start(run, background=True)
    return {"__meta": S.meta("ParseV3"), "job": S.job_v3(job),
            "destination_frame": {"name": dest}}


def h_parsestream(ctx: Ctx):
    """POST /3/ParseStream — stream-append a CSV micro-batch to an
    installed frame (train on static data, score the stream). Body:
    ``destination_frame`` (existing frame), ``data`` (CSV rows, no
    header, columns in frame order), optional ``separator``. Rows land
    through one device concat per column (ingest/chunked.append_csv),
    rollups updated incrementally."""
    dest = (str(ctx.arg("destination_frame") or "")).strip('"')
    fr = _frame_or_404(dest)
    data = ctx.arg("data")
    if not data:
        raise ApiError("data (CSV rows, no header) required", 400)
    from h2o3_tpu_torch.ingest import chunked
    from h2o3_tpu_torch.parallel import oplog

    # default to the separator the frame was IMPORTED with (a tab-separated
    # frame streams tab-separated rows without repeating it per request);
    # the broadcast carries the RESOLVED value so followers parse alike
    sep = chunked.stream_separator(fr, str(ctx.arg("separator") or "") or
                                   None)

    # preflight BEFORE the broadcast (the h_predict_v3 pattern): a batch
    # with a stray delimiter or a non-numeric token in a numeric column
    # must be a clean 400 here — raising inside every follower's mirrored
    # replay would fail the whole cloud. The batch deliberately parses
    # twice (preflight + append): micro-batches are small by design, and
    # threading the parsed result into only the coordinator's append would
    # fork its code path from the follower replay's
    try:
        chunked.validate_batch(fr, str(data), sep)
    except ValueError as e:
        raise ApiError(str(e), 400)
    op_seq = oplog.broadcast("parse_stream", {
        "frame": dest, "data": str(data), "separator": sep})
    with oplog.turn(op_seq):
        added = chunked.append_csv(fr, str(data), sep)
    return {"__meta": S.meta("ParseStreamV3"), "destination_frame": dest,
            "rows_appended": added, "total_rows": fr.nrows}


# -- jobs -------------------------------------------------------------------

def _find_job(key: str) -> Job:
    j = DKV.get(key)
    if not isinstance(j, Job):
        raise ApiError(f"Job {key} not found", 404)
    return j


def h_jobs_list(ctx: Ctx):
    jobs = [v for v in (DKV.get(k) for k in DKV.keys()) if isinstance(v, Job)]
    return {"__meta": S.meta("JobsV3"), "jobs": [S.job_v3(j) for j in jobs]}


def h_job_get(ctx: Ctx):
    return {"__meta": S.meta("JobsV3"), "jobs": [S.job_v3(_find_job(ctx.params["job_id"]))]}


def h_job_cancel(ctx: Ctx):
    _find_job(ctx.params["job_id"]).cancel()
    return {"__meta": S.meta("JobsV3"), "jobs": []}


# -- rapids -----------------------------------------------------------------

def h_rapids(ctx: Ctx):
    """POST /99/Rapids — execute (or defer) one statement.

    Lazy-session semantics (rapids/planner.py): a deferrable assignment
    returns immediately with the temp's key/nrows/ncols — its columns
    are lazy, so the reply costs no device work. The flush points are
    (a) any later statement the planner cannot defer, and (b) ANY data
    access on the temp — `GET /3/Frames/{key}` (the fetch h2o-py issues
    on frame refresh), CSV export/download, and model builds on the temp
    all materialize it transparently. `DELETE /4/sessions/{id}` retires
    the session's whole DAG without computing dead temps."""
    ast = ctx.arg("ast", "")
    sid = str(ctx.arg("session_id", "default"))
    sess = _SESSIONS.setdefault(sid, Session(sid))
    from h2o3_tpu_torch.obs import metrics as obs_metrics
    from h2o3_tpu_torch.parallel import oplog

    # munging runs device programs too: replay the same AST cloud-wide
    op_seq = oplog.broadcast("rapids", {"ast": str(ast), "session_id": sid})
    t0 = time.perf_counter()
    with oplog.turn(op_seq):
        # exec_rapids emits parse/plan/execute/fused_dispatch child spans
        # on the ingress trace (wall-clock only — no device syncs added)
        val = exec_rapids(ast, sess)
    obs_metrics.observe("h2o3_rapids_statement_seconds",
                        time.perf_counter() - t0)
    out: Dict[str, Any] = {"__meta": S.meta("RapidsFrameV3", "RapidsFrameV3")}
    if isinstance(val, Frame):
        if DKV.get(str(val.key)) is None:
            val.install()
        out.update({"key": {"name": str(val.key)},
                    "num_rows": val.nrows, "num_cols": val.ncols})
        return out
    if isinstance(val, (bool, np.bool_)):
        return {"__meta": S.meta("RapidsScalarV3"), "scalar": bool(val)}
    if isinstance(val, (int, float, np.integer, np.floating)):
        v = float(val)
        return {"__meta": S.meta("RapidsScalarV3"), "scalar": None if v != v else v}
    if isinstance(val, str):
        return {"__meta": S.meta("RapidsStringV3"), "string": val}
    if isinstance(val, (list, tuple, np.ndarray)):
        return {"__meta": S.meta("RapidsScalarV3"),
                "scalar": [None if (isinstance(x, float) and x != x) else x
                           for x in np.asarray(val).tolist()]}
    return {"__meta": S.meta("RapidsScalarV3"), "scalar": None}


# -- frames -----------------------------------------------------------------

def _frame_reply(fr: Frame, ctx: Ctx, with_data: bool = True):
    rc = int(ctx.arg("row_count", 10) or 10)
    ro = int(ctx.arg("row_offset", 0) or 0)
    cc = int(ctx.arg("column_count", -1) or -1)
    co = int(ctx.arg("column_offset", 0) or 0)
    fj = S.frame_v3(fr, row_count=rc, row_offset=ro, column_count=cc,
                    column_offset=co, with_data=with_data)
    fj["column_names"] = fr.names        # in-repo thin-client convenience
    return fj


def h_frames_list(ctx: Ctx):
    frames = [v for v in (DKV.get(k) for k in DKV.keys()) if isinstance(v, Frame)]
    return {"__meta": S.meta("FramesListV3"),
            "frames": [S.frame_v3(f, with_data=False) | {"column_names": f.names}
                       for f in frames]}


def h_frame_get(ctx: Ctx):
    fr = _frame_or_404(ctx.params["frame_id"])
    return {"__meta": S.meta("FramesV3"), "frames": [_frame_reply(fr, ctx)]}


def h_frame_light(ctx: Ctx):
    fr = _frame_or_404(ctx.params["frame_id"])
    return {"__meta": S.meta("FramesV3"), "frames": [_frame_reply(fr, ctx)]}


def h_frame_summary(ctx: Ctx):
    fr = _frame_or_404(ctx.params["frame_id"])
    fj = _frame_reply(fr, ctx)
    fj["summary"] = fr.summary()
    for cj in fj["columns"]:
        col = fr.col(cj["label"])
        if col.is_numeric:
            from h2o3_tpu_torch.ops.quantile import quantile_column

            probs = [0.01, 0.1, 0.25, 0.333, 0.5, 0.667, 0.75, 0.9, 0.99]
            try:
                cj["percentiles"] = [float(v) for v in quantile_column(col, probs)]
                cj["default_percentiles"] = probs
            except Exception:   # noqa: BLE001 — summary stays best-effort
                pass
    return {"__meta": S.meta("FramesV3"), "frames": [fj]}


def h_frame_delete(ctx: Ctx):
    DKV.remove(ctx.params["frame_id"])
    from h2o3_tpu_torch.api import routes_ext

    routes_ext.purge_metrics(frame_key=ctx.params["frame_id"])
    return {"__meta": S.meta("FramesV3")}


def h_dkv_delete(ctx: Ctx):
    DKV.remove(ctx.params["key"])
    return {"__meta": S.meta("RemoveV3")}


def h_dkv_delete_all(ctx: Ctx):
    DKV.clear()
    return {"__meta": S.meta("RemoveAllV3")}


def h_download_dataset(ctx: Ctx):
    fr = _frame_or_404(str(ctx.arg("frame_id", "")))
    if fr.shard is not None:
        # a row-sharded frame's rows are gathered from every rank: a
        # mirrored op, so the followers join the gather
        from h2o3_tpu_torch.parallel import oplog

        seq = oplog.broadcast("gather", {"frame": str(fr.key)})
        with oplog.turn(seq):
            return RawReply(frame_csv_bytes(fr), "text/plain")
    return RawReply(frame_csv_bytes(fr), "text/plain")


# -- model builders ---------------------------------------------------------

def _builders():
    from h2o3_tpu_torch.models.model_builder import BUILDERS

    return BUILDERS


def _builder_schema(name: str, cls) -> dict:
    return {
        "__meta": S.meta("ModelBuilderSchema"),
        "algo": name, "algo_full_name": name.upper(),
        "can_build": ["Supervised" if cls.supervised else "Unsupervised"],
        "visibility": "Stable",
        "parameters": [S.model_parameter_v3(k, v, v)
                       for k, v in cls.default_params().items()],
        "messages": [], "error_count": 0,
    }


def h_modelbuilders_list(ctx: Ctx):
    return {"__meta": S.meta("ModelBuildersV3"),
            "model_builders": {name: _builder_schema(name, cls)
                               for name, cls in _builders().items()}}


def h_modelbuilder_get(ctx: Ctx):
    algo = ctx.params["algo"].lower()
    cls = _builders().get(algo)
    if cls is None:
        raise ApiError(f"unknown algo {algo!r}", 404)
    return {"__meta": S.meta("ModelBuildersV3"),
            "model_builders": {algo: _builder_schema(algo, cls)}}


def _pin_seed_and_wire(params: Dict[str, Any]) -> Dict[str, Any]:
    """Prepare builder params for an oplog broadcast: every process must
    draw the SAME host-side sampling masks, so a wildcard seed is pinned
    IN PLACE before the op ships; the returned copy keeps only
    JSON-serializable values (and drops model_id — the op carries the
    destination separately)."""
    if params.get("seed") in (None, -1):
        params["seed"] = int(uuid.uuid4().int % (2 ** 31))
    wire = {k: v for k, v in params.items()
            if isinstance(v, (int, float, str, bool, type(None), list))}
    wire.pop("model_id", None)
    return wire


def _clear_wallclock_budget(params: Dict[str, Any], what: str) -> bool:
    """Zero ``max_runtime_secs`` IN PLACE ahead of an oplog broadcast.

    The budget is wall clock measured per process: on a mirrored op each
    process would stop training at a different iteration. Returns True
    when a non-zero budget was cleared (callers log the downgrade)."""
    if float(params.get("max_runtime_secs") or 0.0) <= 0:
        return False
    params["max_runtime_secs"] = 0.0
    import logging

    logging.getLogger("h2o3_tpu_torch").warning(
        "%s: max_runtime_secs ignored on a multi-process cloud (per-"
        "process wall clock would desynchronize the mirrored device "
        "program sequence); bound the build by iterations/trees instead",
        what)
    return True


def _extract_train_params(cls, body: Dict[str, Any]):
    defaults = cls.default_params()
    params: Dict[str, Any] = {}
    ignored = []
    for k, v in body.items():
        kk = "lambda_" if k == "lambda" else k
        kk = cls.translate_param(kk)
        if kk not in defaults:
            ignored.append(k)
            continue
        params[kk] = _coerce(v, defaults[kk])
    return params, ignored


def _h_generic_train(cls, params: Dict[str, Any], model_id):
    """ModelBuilders path for Generic: load the MOJO named by `path` (or
    `model_key` pointing at an uploaded blob) and install it like any
    trained model."""
    params.pop("training_frame", None)
    params.pop("validation_frame", None)
    params.pop("response_column", None)
    dest = model_id or f"GENERIC_model_{uuid.uuid4().hex[:12]}"
    try:
        # validate SYNCHRONOUSLY so bad params surface as a 412 response,
        # not a FAILED background job with a raw traceback
        builder = cls(**{k: v for k, v in params.items() if v})
        path = builder.params.get("path") or builder.params.get("model_key")
        if not path:
            raise ValueError("Generic: 'path' to a MOJO file is required")
    except ValueError as e:
        raise ApiError(str(e), 412, "H2OModelBuilderErrorV3") from None
    job = Job(description="generic Model Build", dest=dest)
    job.dest_type = "Key<Model>"
    job.dest_key = dest

    from h2o3_tpu_torch.parallel import oplog

    # followers must install the model under the SAME key (later predict
    # ops broadcast and resolve it by name); the MOJO path rides the
    # shared-filesystem contract like parse sources
    op_seq = oplog.broadcast("generic", {"path": str(path),
                                         "model_id": dest})

    def run(j: Job):
        with oplog.turn(op_seq):
            model = builder.train()
        model._key = Key(dest)
        DKV.put(dest, model)
        return model

    job.start(run, background=True)
    return {"__meta": S.meta("ModelBuilderJobV3", "ModelBuilderJob"),
            "job": S.job_v3(job), "messages": [], "error_count": 0,
            "parameters": [], "algo": "generic"}


def _pop_train_args(params: Dict[str, Any]):
    """Shared extraction of the frame/response/ignored args from a coerced
    param dict (used by the ModelBuilders and Grid build handlers — one
    place for the 404/412 shapes)."""
    train_key = str(params.pop("training_frame", "") or "").strip('"')
    valid_key = str(params.pop("validation_frame", "") or "").strip('"')
    y = str(params.pop("response_column", "") or "").strip('"') or None
    x_ignored = params.pop("ignored_columns", None)
    if not train_key:
        raise ApiError("training_frame required", 412, "H2OModelBuilderErrorV3")
    train = DKV.get(train_key)
    if not isinstance(train, Frame):
        raise ApiError(f"Object '{train_key}' not found for argument: "
                       "training_frame", 404, "H2OModelBuilderErrorV3")
    valid = DKV.get(valid_key) if valid_key else None
    if x_ignored:
        x_ignored = [str(c).strip('"') for c in x_ignored]
    return train, valid, y, x_ignored


def h_modelbuilder_train(ctx: Ctx):
    algo = ctx.params["algo"].lower()
    cls = _builders().get(algo)
    if cls is None:
        raise ApiError(f"unknown algo {algo!r}", 404)
    body = dict(ctx.body)
    params, _ignored = _extract_train_params(cls, body)
    model_id = str(params.pop("model_id", "") or "").strip('"') or None
    if algo == "generic":
        # Generic trains from a MOJO artifact, not a frame (h2o-py
        # H2OGenericEstimator.from_file → train() with no training_frame;
        # hex/generic/Generic.java)
        return _h_generic_train(cls, params, model_id)
    train, valid, y, x_ignored = _pop_train_args(params)

    try:
        builder = cls(**params)
        if x_ignored:
            builder.params["ignored_columns"] = x_ignored
        if model_id:
            builder.params["model_id"] = model_id
    except ValueError as e:
        raise ApiError(str(e), 412, "H2OModelBuilderErrorV3") from None

    dest = model_id or f"{algo.upper()}_model_{uuid.uuid4().hex[:12]}"
    job = Job(description=f"{algo} Model Build", dest=dest)
    job.dest_type = "Key<Model>"
    job.dest_key = dest

    from h2o3_tpu_torch.parallel import ckpt, oplog

    op_seq = None
    wire_params = None
    if oplog.active():
        # cleared on the COORDINATOR'S builder too, not just the wire:
        # both sides must run the identical un-budgeted fit loop
        _clear_wallclock_budget(builder.params, f"{algo} train")
        wire_params = _pin_seed_and_wire(builder.params)
        op_seq = oplog.broadcast("train", {
            "algo": algo, "params": wire_params,
            "training_frame": str(train.key),
            "validation_frame": str(valid.key) if valid is not None else None,
            "y": y, "model_id": dest})
    if ckpt.job_ckpt_iters() > 0 and builder.supports_iteration_resume:
        # crash-survivable build: pin the wildcard seed NOW (a resumed
        # dispatch must re-derive the identical RNG streams) and record
        # the re-dispatch recipe on the job — the trainer's fit loop
        # persists durable progress against it every
        # H2O_TPU_JOB_CKPT_ITERS iterations
        if wire_params is None:
            wire_params = _pin_seed_and_wire(builder.params)
        job.resume_spec = {
            "algo": algo, "params": wire_params,
            "training_frame": str(train.key),
            "validation_frame": str(valid.key) if valid is not None else None,
            "y": y, "model_id": dest, "description": job.description}
        builder._progress_job = job

    def run(j: Job):
        with oplog.turn(op_seq):
            model = builder.train(y=y, training_frame=train,
                                  validation_frame=valid)
            if j.status == Job.FAILED:
                # supervisor failed this job from outside mid-train: don't
                # install the result at dest — Job.start's wrapper is about
                # to discard it, and a pre-installed model would outlive it
                return model
            # the client captured dest at submit time (h2o-py
            # H2OJob.__init__ reads dest.name once) — re-home the model
            # under the advertised key, inside the op's turn, so a
            # control-plane checkpoint taken right after the op holds it
            # under the key the followers replayed it to
            old = str(model.key)
            if old != dest:
                DKV.remove(old)
                model._key = Key(dest)
            DKV.put(dest, model)
            model._parms.setdefault("training_frame", str(train.key))
        return model

    job.start(run, background=True)
    return {"__meta": S.meta("ModelBuilderJobV3", "ModelBuilderJob"),
            "job": S.job_v3(job), "messages": [], "error_count": 0,
            "parameters": [S.model_parameter_v3(k, cls.default_params().get(k), v)
                           for k, v in params.items()],
            "algo": algo}


def h_modelbuilder_validate(ctx: Ctx):
    algo = ctx.params["algo"].lower()
    cls = _builders().get(algo)
    if cls is None:
        raise ApiError(f"unknown algo {algo!r}", 404)
    params, ignored = _extract_train_params(cls, dict(ctx.body))
    msgs = [{"__meta": S.meta("ValidationMessageV3"), "message_type": "WARN",
             "field_name": k, "message": f"unknown parameter {k}"} for k in ignored]
    return {"__meta": S.meta("ModelBuildersV3"), "messages": msgs,
            "error_count": 0, "parameters": []}


# -- models -----------------------------------------------------------------

def _model_json(m: Model) -> dict:
    cls = _builders().get(m.algo_name)
    return S.model_v3(m, builder_cls=cls)


def h_models_list(ctx: Ctx):
    models = [v for v in (DKV.get(k) for k in DKV.keys()) if isinstance(v, Model)]
    return {"__meta": S.meta("ModelsV3"), "models": [_model_json(m) for m in models]}


def h_model_get(ctx: Ctx):
    return {"__meta": S.meta("ModelsV3"),
            "models": [_model_json(_model_or_404(ctx.params["model_id"]))]}


def h_model_delete(ctx: Ctx):
    DKV.remove(ctx.params["model_id"])
    from h2o3_tpu_torch import scoring
    from h2o3_tpu_torch.api import routes_ext

    routes_ext.purge_metrics(model_key=ctx.params["model_id"])
    scoring.purge(ctx.params["model_id"])     # drop its device-resident session
    return {"__meta": S.meta("ModelsV3")}


def _rekey(fr: Frame, dest: str) -> Frame:
    """Give a result frame the destination key the client was promised
    (the port's predict methods mint their own key)."""
    if str(fr.key) != dest:
        DKV.remove(str(fr.key))
        fr._key = Key(dest)
    return fr


def _wants_contributions(ctx: Ctx) -> bool:
    return str(ctx.arg("predict_contributions", "")).lower() in ("1", "true")


def _check_contributions_size(fr: Frame) -> None:
    if fr.nrows > 100_000:
        raise ApiError("predict_contributions over REST is capped at "
                       "100k rows (host-side TreeSHAP); subset the "
                       "frame first", 400)


def h_predict_v3(ctx: Ctx):
    m = _model_or_404(ctx.params["model_id"])
    fr = _frame_or_404(ctx.params["frame_id"])
    from h2o3_tpu_torch.parallel import oplog

    # column-compatibility preflight BEFORE any oplog broadcast: an
    # adapt_test raise after the broadcast would kill every follower's
    # replay loop (the 137d938 pattern) — reject as a clean 400 instead
    err = m.check_test_compat(fr)
    if err:
        raise ApiError(err, 400)
    dest = str(ctx.arg("predictions_frame", "") or "").strip('"') or None
    if str(ctx.arg("leaf_node_assignment", "")).lower() in ("1", "true"):
        # ModelBase.predict_leaf_node_assignment (tree models only). The
        # bin+leaf_index pass is a DEVICE program over sharded columns, so
        # followers must replay it like any other predict op
        la_type = str(ctx.arg("leaf_node_assignment_type", "Path") or
                      "Path").strip('"') or "Path"
        if not hasattr(m, "predict_leaf_node_assignment"):
            raise ApiError(f"{m.algo_name} has no leaf node assignments "
                           "(tree models only)", 400)
        if la_type not in ("Path", "Node_ID"):
            # validate BEFORE the broadcast: a post-broadcast raise would
            # kill every follower's replay loop
            raise ApiError(f"leaf_node_assignment_type {la_type!r} "
                           "(Path or Node_ID)", 400)
        dest = dest or f"leaf_assignment_{m.key}_on_{fr.key}"
        # explainability rides the same admission gate as predictions:
        # an overloaded model sheds leaf-assignment traffic
        # with 429/Retry-After too, instead of queueing it past the SLO
        with admission.CONTROLLER.slot(str(m.key)):
            op_seq = oplog.broadcast("leaf_assignment", {
                "model": str(m.key), "frame": str(fr.key),
                "type": la_type, "destination_frame": dest})
            with oplog.turn(op_seq):
                pred = _rekey(m.predict_leaf_node_assignment(
                    fr, type=la_type), dest)
                pred.install()
        return {"__meta": S.meta("ModelMetricsListSchemaV3"),
                "predictions_frame": {"name": str(pred.key)},
                "model_metrics": []}
    if str(ctx.arg("predict_staged_proba", "")).lower() in ("1", "true"):
        # ModelBase.staged_predict_proba (GBM only) — device leaf pass, so
        # mirrored like leaf assignment
        if not hasattr(m, "staged_predict_proba"):
            raise ApiError(f"{m.algo_name} has no staged probabilities "
                           "(GBM only)", 400)
        if m._output.model_category not in ("Binomial", "Multinomial"):
            # validate BEFORE the broadcast (post-broadcast raises are
            # follower-fatal); matches the model-side check
            raise ApiError("staged_predict_proba needs a classification "
                           "GBM", 400)
        dest = dest or f"staged_proba_{m.key}_on_{fr.key}"
        with admission.CONTROLLER.slot(str(m.key)):
            op_seq = oplog.broadcast("staged_proba", {
                "model": str(m.key), "frame": str(fr.key),
                "destination_frame": dest})
            with oplog.turn(op_seq):
                pred = _rekey(m.staged_predict_proba(fr), dest)
                pred.install()
        return {"__meta": S.meta("ModelMetricsListSchemaV3"),
                "predictions_frame": {"name": str(pred.key)},
                "model_metrics": []}
    if _wants_contributions(ctx):
        # genmodel TreeSHAP surfaced over REST (h2o-py predict_contributions)
        _check_contributions_size(fr)
        dest = dest or f"contributions_{m.key}_on_{fr.key}"
        # contributions bin through the same fused pack program training
        # and serving use (ShardedFrame.pack_binned); the TreeSHAP walk
        # itself is host-side by design — admission-gate it so heavy
        # explainability traffic sheds instead of starving serving
        with admission.CONTROLLER.slot(str(m.key)):
            op_seq = oplog.broadcast("predict", {
                "model": str(m.key), "frame": str(fr.key),
                "destination_frame": dest, "contributions": True,
                "with_metrics": False})
            with oplog.turn(op_seq):
                pred = m.predict_contributions(fr, key=dest)
                pred.install()
        return {"__meta": S.meta("ModelMetricsListSchemaV3"),
                "predictions_frame": {"name": str(pred.key)},
                "model_metrics": []}
    # followers must mirror EVERY device program this handler runs —
    # predict AND the model_performance metrics pass below — and the
    # coordinator must run them inside its turnstile slot so they cannot
    # interleave out of broadcast order vs the follower's sequential replay.
    # The destination key ships explicitly (default included) so every
    # process installs the prediction frame under the SAME DKV name.
    dest = dest or f"prediction_{m.key}_on_{fr.key}"
    from h2o3_tpu_torch import scoring

    # on a multi-process cloud the mirrored predict op below runs the
    # request: the micro-batcher's coalesced op is ROADMAP A14.7
    if scoring.supports(m) and not oplog.active():
        # serving fast path: compile-once bucketed traversal; concurrent
        # requests for the same model coalesce into ONE dispatch (and ONE
        # "score_batch" oplog op on a multi-process cloud) inside the
        # micro-batcher's window. The scoring raw pass is reused for the
        # metrics too, so the whole request is a single forest traversal.
        pred, mm = scoring.score_request(m, fr, dest, with_metrics=True)
        with tracing.span("schema"):
            return {"__meta": S.meta("ModelMetricsListSchemaV3"),
                    "predictions_frame": {"name": str(pred.key)},
                    "model_metrics": [S.metrics_v3(mm, str(m.key),
                                                   str(fr.key))]
                    if mm else []}
    op_seq = oplog.broadcast("predict", {"model": str(m.key),
                                         "frame": str(fr.key),
                                         "destination_frame": dest,
                                         "with_metrics": True})
    with oplog.turn(op_seq):
        pred = _rekey(m.predict(fr), dest)
        pred.install()
        mm = m.model_performance(fr)
    return {"__meta": S.meta("ModelMetricsListSchemaV3"),
            "predictions_frame": {"name": str(pred.key)},
            "model_metrics": [S.metrics_v3(mm, str(m.key), str(fr.key))] if mm else []}


def h_predict_v4(ctx: Ctx):
    m = _model_or_404(ctx.params["model_id"])
    fr = _frame_or_404(ctx.params["frame_id"])
    # same pre-broadcast preflight as the v3 route: bad column types must
    # surface as a 400 BEFORE the op ships (post-broadcast raises are
    # follower-fatal)
    err = m.check_test_compat(fr)
    if err:
        raise ApiError(err, 400)
    contribs = str(ctx.arg("predict_contributions", "")).lower() in ("1", "true")
    if contribs:
        _check_contributions_size(fr)  # same 400 as the sync v3 route
    from h2o3_tpu_torch import scoring

    use_fused = not contribs and scoring.supports(m)
    if use_fused:
        # surface saturation BEFORE detaching into a background job: a
        # request the gate would shed right now gets the synchronous 429
        # + Retry-After (a failed async job carries no backoff hint).
        # Non-consuming probe — the job's own slot() still gates.
        admission.CONTROLLER.check(str(m.key))
    job = Job(description=f"{m.algo_name} "
                          f"{'contributions' if contribs else 'prediction'}")
    job.dest_type = "Key<Frame>"
    pred_key = (f"contributions_{m.key}_on_{fr.key}" if contribs
                else f"prediction_{m.key}_on_{fr.key}")
    job.dest_key = pred_key

    from h2o3_tpu_torch.parallel import oplog

    if use_fused:
        # fused /4 route: the async prediction rides the SAME
        # admission-controlled, coalescing, compile-once fast path as the
        # sync v3 route — score_request broadcasts its own coalesced
        # "score_batch" op from the job thread, so async clients no
        # longer fall off the fast path. Results are bitwise-identical
        # to the eager predict (the fused-path contract).
        def run_fused(j: Job):
            pred, _mm = scoring.score_request(m, fr, pred_key,
                                              with_metrics=False)
            return pred

        job.start(run_fused, background=True)
    else:
        op_seq = oplog.broadcast("predict", {
            "model": str(m.key), "frame": str(fr.key),
            "destination_frame": pred_key, "contributions": contribs,
            "with_metrics": False})

        def run(j: Job):
            with oplog.turn(op_seq):
                if contribs:
                    # genuine h2o-py predict_contributions rides this
                    # async route (model_base.py:199: POST /4/Predictions
                    # + flag)
                    pred = m.predict_contributions(fr, key=pred_key)
                else:
                    pred = _rekey(m.predict(fr), pred_key)
            pred.install()
            return pred

        job.start(run, background=True)
    # h2o-r predict.H2OModel reads key/dest at the TOP level of the v4
    # response (models.R:679 res$key$name, res$dest$name); h2o-py reads
    # the nested job — serve both shapes
    jv = S.job_v3(job)
    return {"__meta": S.meta("JobV4"), "job": jv,
            "key": jv.get("key"), "dest": jv.get("dest")}


def _automl_tables(aml):
    """Leaderboard + event-log TwoDimTables in the shapes the genuine
    h2o-py AutoML client parses (autoh2o.py _fetch_state/_fetch_table:
    a leading index column the client strips with lb[1:], and an event log
    carrying name/value columns for _training_info)."""
    from h2o3_tpu_torch.automl.automl import _leaderboard_metric
    from h2o3_tpu_torch.utils.twodim import TwoDimTable

    metric = aml._metric_name
    lb = TwoDimTable("Leaderboard", ["", "model_id", metric],
                     ["string", "string", "double"])
    cache = getattr(aml, "_lb_cache", {})
    lbf = getattr(aml, "_leaderboard_frame", None)
    ranked = aml._ranked()
    for i, m in enumerate(ranked):
        # model_id must be the fetchable DKV key (h2o.get_model uses it)
        lb.add_row(str(i), str(m.key),
                   float(_leaderboard_metric(m, metric, lbf, cache)))
    el = TwoDimTable("Event Log",
                     ["", "timestamp", "level", "stage", "message",
                      "name", "value"],
                     ["string", "string", "string", "string", "string",
                      "string", "string"])
    for i, ev in enumerate(aml.event_log):
        # "Info" capitalization matters: the client filters levels against
        # ['Debug','Info','Warn'] (EventLogEntry.Level spellings)
        el.add_row(str(i), str(ev.get("timestamp", "")), "Info", "run",
                   str(ev.get("message", "")), "", "")
    el.add_row(str(len(aml.event_log)), "", "Info", "run", "",
               "project_name", aml.project_name)
    return lb, el, ranked


def h_automl_build(ctx: Ctx):
    """POST /99/AutoMLBuilder (ai.h2o.automl AutoMLBuildSpec; genuine
    h2o-py H2OAutoML.train posts build_control/build_models/input_spec)."""
    spec = ctx.body or {}
    input_spec = spec.get("input_spec") or {}
    build_control = spec.get("build_control") or {}
    build_models = spec.get("build_models") or {}
    sc = build_control.get("stopping_criteria") or {}
    train = _frame_or_404(str(input_spec.get("training_frame", "")))
    y = str(input_spec.get("response_column", "") or "")
    if not y:
        raise ApiError("response_column required", 412)
    valid_key = input_spec.get("validation_frame")
    lb_key = input_spec.get("leaderboard_frame")
    project = str(build_control.get("project_name", "") or "") or \
        f"AutoML_{uuid.uuid4().hex[:8]}"

    from h2o3_tpu_torch.automl.automl import H2OAutoML

    nf = build_control.get("nfolds")
    mm = sc.get("max_models")
    aml = H2OAutoML(
        # explicit 0 is meaningful for both (no CV / no model cap) — only
        # ABSENT values take the defaults
        max_models=int(mm) if mm is not None else 10,
        max_runtime_secs=float(sc.get("max_runtime_secs") or 0.0),
        seed=int(sc.get("seed", -1) if sc.get("seed") is not None else -1),
        nfolds=int(nf) if nf is not None else 5,
        sort_metric=str(input_spec.get("sort_metric") or "AUTO"),
        include_algos=build_models.get("include_algos"),
        exclude_algos=build_models.get("exclude_algos"),
        project_name=project)
    ignored = set(input_spec.get("ignored_columns") or [])
    x = [c for c in train.names if c != y and c not in ignored] or None
    job = Job(description="AutoML", dest=project)
    job.dest_type = "Key<AutoML>"
    job.dest_key = project
    # durable search: the engine checkpoints member state under this Job's
    # key so a watchdog on a surviving node can resume the search in place
    aml._search_job = job

    from h2o3_tpu_torch.parallel import oplog

    op_seq = None
    if oplog.active():
        # multi-process cloud: every process must walk the IDENTICAL model
        # sequence, so the seed is already pinned (H2OAutoML.__init__) and
        # the wall-clock budget — which would diverge across processes —
        # is cleared in favor of the max_models cap
        if aml.max_runtime_secs > 0:
            import logging

            logging.getLogger("h2o3_tpu_torch").warning(
                "AutoML max_runtime_secs ignored on a multi-process cloud "
                "(nondeterministic across processes); bounded by "
                "max_models=%d instead", aml.max_models)
            aml.max_runtime_secs = 0.0
        op_seq = oplog.broadcast("automl", {
            "spec": {"max_models": aml.max_models, "max_runtime_secs": 0.0,
                     "seed": aml.seed, "nfolds": aml.nfolds,
                     "sort_metric": aml.sort_metric,
                     "include_algos": aml.include_algos,
                     "exclude_algos": aml.exclude_algos,
                     "project_name": aml.project_name,
                     "preprocessing": aml.preprocessing},
            "training_frame": str(train.key),
            "validation_frame": str(valid_key) if valid_key else None,
            "leaderboard_frame": str(lb_key) if lb_key else None,
            "x": x, "y": y})

    def run(j: Job):
        # Job.start installs the result under job.dest (= project) itself
        with oplog.turn(op_seq):
            aml.train(x=x, y=y, training_frame=train,
                      validation_frame=DKV.get(str(valid_key)) if valid_key else None,
                      leaderboard_frame=DKV.get(str(lb_key)) if lb_key else None)
        return aml

    job.start(run, background=True)
    return {"__meta": S.meta("AutoMLBuilderV99"), "job": S.job_v3(job),
            "build_control": {"project_name": project}}


def h_automl_get(ctx: Ctx):
    """GET /99/AutoML/{aml_id} — the AutoMLV99 state json h2o-py reads."""
    from h2o3_tpu_torch.automl.automl import H2OAutoML

    aml = DKV.get(ctx.params["aml_id"])
    if not isinstance(aml, H2OAutoML):
        raise ApiError(f"AutoML {ctx.params['aml_id']!r} not found", 404)
    lb, el, ranked = _automl_tables(aml)
    return {"__meta": S.meta("AutoMLV99"),
            "project_name": aml.project_name,
            "leaderboard": {"models": [{"name": str(m.key)} for m in ranked]},
            "leaderboard_table": lb.to_v3(),
            "event_log_table": el.to_v3()}


def h_leaderboard_get(ctx: Ctx):
    """GET /99/Leaderboards/{aml_id} (h2o.automl.get_leaderboard)."""
    from h2o3_tpu_torch.automl.automl import H2OAutoML

    aml = DKV.get(ctx.params["aml_id"])
    if not isinstance(aml, H2OAutoML):
        raise ApiError(f"AutoML {ctx.params['aml_id']!r} not found", 404)
    lb, _el, _ranked = _automl_tables(aml)
    return {"__meta": S.meta("LeaderboardV99"),
            "project_name": aml.project_name,
            "table": lb.to_v3()}


def h_grid_build(ctx: Ctx):
    """POST /99/Grid/{algo} — hyperparameter search job (water/api
    GridSearchHandler; genuine h2o-py H2OGridSearch.train rides this)."""
    algo = ctx.params["algo"].lower()
    cls = _builders().get(algo)
    if cls is None:
        raise ApiError(f"unknown algo {algo!r}", 404)
    body = dict(ctx.body)
    hp_raw = body.pop("hyper_parameters", None)
    if not hp_raw:
        raise ApiError("hyper_parameters required", 412)
    hyper = hp_raw if isinstance(hp_raw, dict) else json.loads(str(hp_raw))
    defaults = cls.default_params()
    hyper = {("lambda_" if k == "lambda" else cls.translate_param(k)):
             list(v) for k, v in hyper.items()}
    unknown = [k for k in hyper if k not in defaults]
    if unknown:
        raise ApiError(f"unknown hyper parameters {unknown}", 412)
    sc_raw = body.pop("search_criteria", None)
    criteria = (sc_raw if isinstance(sc_raw, dict)
                else json.loads(str(sc_raw)) if sc_raw else None)
    grid_id = str(body.pop("grid_id", "") or "").strip('"') or \
        f"Grid_{algo.upper()}_{uuid.uuid4().hex[:10]}"
    params, _ignored = _extract_train_params(cls, body)
    train, valid, y, x_ignored = _pop_train_args(params)
    if x_ignored:
        params["ignored_columns"] = x_ignored

    from h2o3_tpu_torch.grid import H2OGridSearch

    parallelism = int(body.pop("parallelism", 1) or 1)
    recovery_dir = str(body.pop("recovery_dir", "") or "").strip('"') or None
    job = Job(description=f"{algo} Grid Build", dest=grid_id)
    job.dest_type = "Key<Grid>"

    from h2o3_tpu_torch.parallel import oplog

    op_seq = None
    if oplog.active():
        # one deterministic op: every process walks the identical combo
        # sequence. Parallel building would interleave device programs
        # nondeterministically across processes — force sequential there.
        sc_seed = (criteria or {}).get("seed")
        if str((criteria or {}).get("strategy", "")).lower() == "randomdiscrete" \
                and (not isinstance(sc_seed, (int, float)) or int(sc_seed) < 0):
            criteria = dict(criteria or {})
            criteria["seed"] = int(uuid.uuid4().int % (2 ** 31))
        parallelism = 1
        # the walker's wall-clock budget break and each member build's
        # deadline are per-process time: zero BOTH before the op ships
        # (local run() and followers then walk the identical combo/model
        # sequence) — same mirrored-program invariant as train/automl
        if criteria and float(criteria.get("max_runtime_secs") or 0.0) > 0:
            criteria = dict(criteria)
            _clear_wallclock_budget(criteria, f"{algo} grid criteria")
        _clear_wallclock_budget(params, f"{algo} grid build")
        wire_params = _pin_seed_and_wire(params)
        op_seq = oplog.broadcast("grid", {
            "algo": algo, "params": wire_params, "hyper": hyper,
            "criteria": criteria, "grid_id": grid_id, "y": y,
            "training_frame": str(train.key),
            "validation_frame": str(valid.key) if valid is not None else None})

    def run(j: Job):
        base = cls(**params)
        grid = H2OGridSearch(base, hyper, grid_id=grid_id,
                             search_criteria=criteria)
        # durable search: member state checkpoints under this Job's key
        grid._search_job = j
        with oplog.turn(op_seq):
            grid.train(y=y, training_frame=train, validation_frame=valid,
                       parallelism=parallelism, recovery_dir=recovery_dir)
        return grid

    job.start(run, background=True)
    return {"__meta": S.meta("GridSearchV99"), "job": S.job_v3(job)}


def h_grid_get(ctx: Ctx):
    """GET /99/Grids/{grid_id} — the GridSchemaV99 fields h2o-py reads:
    model_ids (rank-ordered when sort_by given), hyper_names, failure
    lists, summary_table."""
    grid = DKV.get(ctx.params["grid_id"])
    from h2o3_tpu_torch.grid import H2OGridSearch

    if not isinstance(grid, H2OGridSearch):
        raise ApiError(f"grid {ctx.params['grid_id']!r} not found", 404)
    sort_by = str(ctx.arg("sort_by", "") or "").strip('"') or None
    dec_raw = ctx.arg("decreasing")
    decreasing = None if dec_raw is None else \
        str(dec_raw).lower() in ("1", "true")
    g = grid.get_grid(sort_by=sort_by, decreasing=decreasing) \
        if grid.models else grid
    return {"__meta": S.meta("GridSchemaV99"),
            "grid_id": S.key_ref(str(grid.key), "Key<Grid>"),
            "model_ids": [{"name": str(m.key)} for m in g.models],
            "hyper_names": list(grid.hyper_params),
            "failure_details": [f["error"] for f in grid.failed],
            "failed_params": [f["params"] for f in grid.failed],
            "failure_stack_traces": [f["error"] for f in grid.failed],
            "export_checkpoints_dir": None,
            "summary_table": None}


def h_import_sql(ctx: Ctx):
    """POST /99/ImportSQLTable (water/jdbc SQLManager; h2o-py
    import_sql_table/import_sql_select)."""
    from h2o3_tpu_torch.ingest.sql import import_sql_select, import_sql_table

    url = str(ctx.arg("connection_url", "") or "").strip('"')
    user = str(ctx.arg("username", "") or "").strip('"') or None
    pw = str(ctx.arg("password", "") or "").strip('"') or None
    select = str(ctx.arg("select_query", "") or "").strip('"')
    table = str(ctx.arg("table", "") or "").strip('"')
    if not url or not (select or table):
        raise ApiError("connection_url and table/select_query required", 400)
    if select:
        fr = import_sql_select(url, select, username=user, password=pw)
    else:
        cols = _parse_list(ctx.arg("columns")) or None
        fr = import_sql_table(url, table, columns=cols,
                              username=user, password=pw)
    fr.install()
    job = Job(description="ImportSQLTable")
    job.dest_key = str(fr.key)
    job.status = Job.DONE
    job.progress = 1.0
    return {"__meta": S.meta("JobV3"), "job": S.job_v3(job),
            "key": S.key_ref(str(fr.key))}


def h_network_test(ctx: Ctx):
    """GET /3/NetworkTest (water/api/NetworkTestHandler + NetworkBench):
    the device probes — matmul GFLOP/s, memory stream GB/s, and a
    latency probe (a device-local reduction on one card)."""
    from h2o3_tpu_torch.core.runtime import cluster

    b = cluster().self_benchmark(
        size=max(16, min(int(ctx.arg("size", 512) or 512), 4096)))
    return {"__meta": S.meta("NetworkTestV3"), "bench": b}


def h_create_frame(ctx: Ctx):
    """POST /3/CreateFrame (hex/createframe/CreateFrameHandler — synthetic
    frame generation; h2o.create_frame)."""
    from h2o3_tpu_torch.frame_factory import create_frame

    kw = {}
    # templates drive _coerce's type parsing — fractions coerce as FLOATS
    # even though their unset default is None
    for name, template in (("rows", 100), ("cols", 4), ("randomize", True),
                           ("real_fraction", 0.0), ("categorical_fraction", 0.0),
                           ("integer_fraction", 0.0), ("binary_fraction", 0.0),
                           ("factors", 2), ("real_range", 100.0),
                           ("integer_range", 100), ("missing_fraction", 0.0),
                           ("has_response", False), ("response_factors", 2),
                           ("seed", -1)):
        v = ctx.arg(name)
        if v is not None:
            kw[name] = _coerce(v, template)
    if int(kw.get("seed", -1)) < 0:
        kw.pop("seed", None)     # h2o's -1 sentinel = pick a random seed
    if kw.pop("randomize", True) is False:
        # frame_factory's generator is always randomized; honor the contract
        # by rejecting rather than silently ignoring
        raise ApiError("randomize=false is not supported", 400)
    dest = str(ctx.arg("dest", "") or ctx.arg("destination_frame", "") or "")
    if dest.strip('"'):
        kw["key"] = dest.strip('"')
    fr = create_frame(**kw)
    job = Job(description="CreateFrame")
    job.dest_key = str(fr.key)
    job.status = Job.DONE
    job.progress = 1.0
    return {"__meta": S.meta("JobV3"), "job": S.job_v3(job),
            "key": S.key_ref(str(fr.key))}


def h_split_frame(ctx: Ctx):
    """POST /3/SplitFrame (hex/splitframe/SplitFrameHandler;
    h2o.split_frame non-rapids path)."""
    fr = _frame_or_404(str(ctx.arg("dataset", "")).strip('"'))
    ratios = [float(r) for r in (_parse_list(ctx.arg("ratios")) or [0.75])]
    dests = _parse_list(ctx.arg("destination_frames")) or None
    from h2o3_tpu_torch.frame_factory import H2OFrame

    if not isinstance(fr, H2OFrame):
        fr = H2OFrame._wrap(fr)
    # split parts are installed by H2OFrame._wrap inside split_frame
    parts = fr.split_frame(ratios=ratios, destination_frames=dests)
    job = Job(description="SplitFrame")
    job.status = Job.DONE
    job.progress = 1.0
    return {"__meta": S.meta("SplitFrameV3"), "job": S.job_v3(job),
            "destination_frames": [S.key_ref(str(p.key)) for p in parts]}


def h_pdp_post(ctx: Ctx):
    """POST /3/PartialDependences (hex/PartialDependence.java; h2o-py
    partial_plot). Runs synchronously; results land in DKV under the
    destination key for the follow-up GET."""
    from h2o3_tpu_torch import explain

    m = _model_or_404(str(ctx.arg("model_id", "")).strip('"'))
    fr = _frame_or_404(str(ctx.arg("frame_id", "")).strip('"'))
    cols = _parse_list(ctx.arg("cols")) or None
    nbins = int(ctx.arg("nbins", 20) or 20)
    ri = ctx.arg("row_index", -1)
    # explicit None/empty check: row_index=0 (ICE for the first row) is falsy
    row_index = int(ri) if ri not in (None, "") else -1
    wc = str(ctx.arg("weight_column", "") or "").strip('"') or None
    dest = (str(ctx.arg("destination_key", "") or "").strip('"')
            or f"pdp_{m.key}_{fr.key}")
    tables = explain.partial_dependence(m, fr, cols, nbins=nbins,
                                        weight_column=wc, row_index=row_index)
    DKV.put(dest, tables)
    job = Job(description="PartialDependence")
    job.dest_key = dest
    job.status = Job.DONE
    job.progress = 1.0
    return {"__meta": S.meta("PartialDependenceV3"), "job": S.job_v3(job),
            "destination_key": dest}


def h_pdp_get(ctx: Ctx):
    tables = DKV.get(ctx.params["key"])
    if tables is None:
        raise ApiError(f"no partial dependence result {ctx.params['key']!r}", 404)
    out = [{"name": t["column"],
            "columns": [{"name": t["column"]}, {"name": "mean_response"},
                        {"name": "stddev_response"}],
            "data": [t["values"], t["mean_response"], t["stddev_response"]]}
           for t in tables]
    return {"__meta": S.meta("PartialDependenceV3"),
            "partial_dependence_data": out}


def h_feature_interaction(ctx: Ctx):
    """POST /3/FeatureInteraction (hex/tree FeatureInteraction analog)."""
    from h2o3_tpu_torch import explain

    m = _model_or_404(str(ctx.arg("model_id", "")).strip('"'))
    depth = int(ctx.arg("max_interaction_depth", 2) or 2)
    rows = explain.feature_interactions(m, max_interaction_depth=depth)
    return {"__meta": S.meta("FeatureInteractionV3"),
            "feature_interaction": rows}


def h_model_metrics(ctx: Ctx):
    m = _model_or_404(ctx.params["model_id"])
    fr = _frame_or_404(ctx.params["frame_id"])
    mm = m.model_performance(fr)
    out = []
    if mm is not None:
        from h2o3_tpu_torch.api import routes_ext

        routes_ext.record_metrics(str(m.key), str(fr.key), mm)
        out.append(S.metrics_v3(mm, str(m.key), str(fr.key)))
    return {"__meta": S.meta("ModelMetricsListSchemaV3"), "model_metrics": out}


def h_model_mojo(ctx: Ctx):
    try:
        from h2o3_tpu_torch.models import mojo
    except ImportError:
        raise ApiError("MOJO export not available in this build", 501) from None
    m = _model_or_404(ctx.params["model_id"])
    fmt = str(ctx.arg("format", "") or "").lower()
    if fmt in ("reference", "java"):
        # reference byte format (SharedTreeMojoModel v1.20): scoreable by
        # the stock dependency-free genmodel jar
        from h2o3_tpu_torch.models.mojo_java import export_java_mojo_bytes

        try:
            data = export_java_mojo_bytes(m)
        except ValueError as e:
            raise ApiError(str(e), 400) from None
    else:
        data = mojo.export_mojo_bytes(m)
    return RawReply(data, "application/zip",
                    headers={"Content-Disposition":
                             f'attachment; filename="{m.key}.zip"'})


def h_te_transform(ctx: Ctx):
    """GET /3/TargetEncoderTransform (h2o-py targetencoder.transform)."""
    m = _model_or_404(str(ctx.arg("model", "")))
    fr = _frame_or_404(str(ctx.arg("frame", "")))
    if not hasattr(m, "transform"):
        raise ApiError(f"model {m.key} is not a TargetEncoder", 400)

    def _opt_f(name):
        v = ctx.arg(name)
        return None if v in (None, "", "null", "None") else float(v)

    blending = ctx.arg("blending")
    out = m.transform(
        fr,
        as_training=str(ctx.arg("as_training", "false")).lower() == "true",
        blending=None if blending in (None, "", "null") else
        str(blending).lower() == "true",
        inflection_point=_opt_f("inflection_point"),
        smoothing=_opt_f("smoothing"),
        noise=_opt_f("noise"))
    out.install()
    return {"__meta": S.meta("TargetEncoderTransformV3"),
            "name": str(out.key)}


# -- AOT scoring artifacts (the standalone deployment surface) --------------

def _artifact_summary(info: Dict[str, Any]) -> Dict[str, Any]:
    return S.artifact_v3(info)


def h_artifact_export(ctx: Ctx):
    """POST /3/Artifacts/models/{model_id} — export a trained forest model
    as a standalone scoring artifact directory (manifest, packed
    constants, one ``torch.export`` program per bucket)."""
    from h2o3_tpu_torch import artifact

    m = _model_or_404(ctx.params["model_id"])
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
        artifact.export_model(m, out_dir, buckets=buckets)
        info = artifact.describe(out_dir)
    except artifact.ArtifactError as e:
        raise ApiError(str(e), 400) from None
    return _artifact_summary(info | {"dir": out_dir,
                                     "model_id": str(m.key)})


def h_artifact_import(ctx: Ctx):
    """POST /3/Artifacts/import — load an artifact directory into a
    servable model under `model_id` (defaults to the exported key). On a
    multi-process cloud the load is mirrored as one oplog op so every
    process installs the model under the SAME key (the dir rides the
    shared-filesystem contract like parse sources)."""
    from h2o3_tpu_torch import artifact
    from h2o3_tpu_torch.parallel import oplog

    art_dir = str(ctx.arg("dir", "") or "").strip('"')
    if not art_dir:
        raise ApiError("dir required (artifact directory to load)", 400)
    model_id = str(ctx.arg("model_id", "") or "").strip('"') or None
    try:
        # FULL load-and-validate (manifest, checksums, packed forest,
        # algo) BEFORE the broadcast, without installing: a post-broadcast
        # raise would kill every follower's replay loop, so anything a
        # replayed load could reject must be rejected as a 400 right here
        artifact.load_model(art_dir, model_id, install=False)
    except artifact.ArtifactError as e:
        raise ApiError(str(e), 400) from None
    op_seq = oplog.broadcast("artifact_import", {"dir": art_dir,
                                                 "model_id": model_id})
    with oplog.turn(op_seq):
        try:
            model = artifact.load_model(art_dir, model_id)
        except artifact.ArtifactError as e:
            raise ApiError(str(e), 400) from None
    return _artifact_summary({"dir": art_dir, "model_id": str(model.key),
                              "algo": model.algo_name})


def h_artifact_info(ctx: Ctx):
    """GET /3/Artifacts?dir=... — validated manifest summary of an
    artifact directory (no payload loads)."""
    from h2o3_tpu_torch import artifact

    art_dir = str(ctx.arg("dir", "") or "").strip('"')
    if not art_dir:
        raise ApiError("dir required", 400)
    try:
        info = artifact.describe(art_dir)
    except artifact.ArtifactError as e:
        raise ApiError(str(e), 400) from None
    return _artifact_summary(info | {"dir": art_dir})


# -- metadata (schema introspection, water/api/SchemaServer.java:20) --------

def h_metadata_endpoints(ctx: Ctx):
    routes = []
    for i, (method, pattern, handler, summary) in enumerate(ROUTES):
        routes.append({
            "__meta": S.meta("EndpointV4"),
            "num": i,
            "http_method": method,
            "url_pattern": pattern,
            "summary": summary,
            "api_name": handler.__name__.lstrip("h_"),
            "input_schema": "Iced", "output_schema": "Iced",
        })
    return {"__meta": S.meta("EndpointsListV4"), "endpoints": routes,
            "routes": routes}


_SCHEMA_REGISTRY = [
    "CloudV3", "JobV3", "JobsV3", "FrameV3", "FramesV3", "ColV3",
    "ParseSetupV3", "ParseV3", "ParseStreamV3", "ImportFilesV3", "InitIDV3",
    "RapidsFrameV3", "RapidsScalarV3", "RapidsStringV3",
    "ModelsV3", "ModelBuildersV3", "ModelParameterSchemaV3",
    "ModelMetricsBinomialV3", "ModelMetricsMultinomialV3",
    "ModelMetricsRegressionV3", "ModelMetricsClusteringV3",
    "TwoDimTableV3", "KeyV3", "H2OErrorV3", "H2OModelBuilderErrorV3",
    "TimelineV3", "LogsV3", "AboutV3", "ArtifactV3",
    "MetricsV3", "TraceV3", "FlightRecordsV3", "ProfilerV3",
]


def h_metadata_schemas(ctx: Ctx):
    return {"__meta": S.meta("SchemaMetadataV3"),
            "schemas": [{"__meta": S.meta("SchemaMetadataV3"),
                         "name": s, "version": 3, "type": s.rstrip("V3")}
                        for s in _SCHEMA_REGISTRY]}


def h_metadata_schema(ctx: Ctx):
    name = ctx.params["schema_name"]
    if name not in _SCHEMA_REGISTRY:
        raise ApiError(f"unknown schema {name!r}", 404)
    return {"__meta": S.meta("SchemaMetadataV3"),
            "schemas": [{"name": name, "version": 3, "type": name.rstrip("V3"),
                         "fields": []}]}


# ---------------------------------------------------------------------------
# route table (RegisterV3Api.java analog)
# ---------------------------------------------------------------------------

ROUTES: List[Tuple[str, str, Callable, str]] = [
    ("GET", "/3/Cloud", h_cloud, "Cluster status"),
    ("HEAD", "/3/Cloud", h_cloud, "Cluster status (head)"),
    ("GET", "/3/About", h_about, "Server build info"),
    ("GET", "/3/Ping", h_ping, "Liveness probe"),
    ("GET", "/4/sessions", h_session_new, "Open session (legacy GET)"),
    ("POST", "/4/sessions", h_session_new, "Open a new session"),
    ("DELETE", "/4/sessions/{session_key}", h_session_end, "End a session"),
    ("POST", "/3/InitID", h_session_new, "Open session (legacy)"),
    ("GET", "/3/InitID", h_session_new, "Open session (legacy)"),
    ("POST", "/3/Shutdown", h_shutdown, "Shut the server down"),
    ("GET", "/3/Logs", h_logs, "Server log tail"),
    ("GET", "/3/Timeline", h_timeline, "Recent request timeline"),
    ("GET", "/3/Profiler", h_profiler, "Per-device memory gauges"),
    ("GET", "/", h_flow, "Flow SPA (import-parse-train-predict)"),
    ("GET", "/flow/index.html", h_flow, "Flow SPA (import-parse-train-predict)"),
    ("GET", "/3/ImportFiles", h_importfiles, "List importable files"),
    ("POST", "/3/ImportFilesMulti", h_importfiles_multi, "List files for many paths"),
    ("POST", "/3/PostFile", h_postfile, "Upload a raw file"),
    ("POST", "/3/PostFile.bin", h_postfile, "Upload a raw file (binary)"),
    ("POST", "/3/ParseSetup", h_parsesetup, "Guess parse setup"),
    ("POST", "/3/Parse", h_parse, "Parse files into a Frame"),
    ("POST", "/3/ParseStream", h_parsestream,
     "Stream-append CSV micro-batch rows to a frame"),
    ("GET", "/3/Jobs", h_jobs_list, "List jobs"),
    ("GET", "/3/Jobs/{job_id}", h_job_get, "Job status"),
    ("POST", "/3/Jobs/{job_id}/cancel", h_job_cancel, "Cancel a job"),
    ("POST", "/99/Rapids", h_rapids, "Execute a Rapids AST"),
    ("GET", "/3/Frames", h_frames_list, "List frames"),
    ("GET", "/3/Frames/{frame_id}", h_frame_get, "Frame preview"),
    ("GET", "/3/Frames/{frame_id}/light", h_frame_light, "Frame preview (light)"),
    ("GET", "/3/Frames/{frame_id}/summary", h_frame_summary, "Frame summary"),
    ("DELETE", "/3/Frames/{frame_id}", h_frame_delete, "Delete a frame"),
    ("DELETE", "/3/DKV/{key}", h_dkv_delete, "Delete a DKV key"),
    ("DELETE", "/3/DKV", h_dkv_delete_all, "Delete all DKV keys"),
    ("GET", "/3/DownloadDataset", h_download_dataset, "Frame as CSV"),
    ("GET", "/3/DownloadDataset.bin", h_download_dataset, "Frame as CSV (binary)"),
    ("GET", "/3/ModelBuilders", h_modelbuilders_list, "List algorithms"),
    ("GET", "/3/ModelBuilders/{algo}", h_modelbuilder_get, "Algorithm parameters"),
    ("POST", "/3/ModelBuilders/{algo}", h_modelbuilder_train, "Train a model"),
    ("POST", "/3/ModelBuilders/{algo}/parameters", h_modelbuilder_validate,
     "Validate parameters"),
    ("GET", "/3/Models", h_models_list, "List models"),
    ("GET", "/3/Models/{model_id}", h_model_get, "Model details"),
    ("DELETE", "/3/Models/{model_id}", h_model_delete, "Delete a model"),
    ("GET", "/3/Models/{model_id}/mojo", h_model_mojo, "Export MOJO artifact"),
    ("POST", "/3/Artifacts/models/{model_id}", h_artifact_export,
     "Export a standalone AOT scoring artifact"),
    ("POST", "/3/Artifacts/import", h_artifact_import,
     "Import an AOT artifact as a servable model"),
    ("GET", "/3/Artifacts", h_artifact_info,
     "Inspect an AOT artifact directory"),
    ("POST", "/3/Predictions/models/{model_id}/frames/{frame_id}", h_predict_v3,
     "Score a frame (sync)"),
    ("POST", "/4/Predictions/models/{model_id}/frames/{frame_id}", h_predict_v4,
     "Score a frame (async job)"),
    ("POST", "/3/ModelMetrics/models/{model_id}/frames/{frame_id}", h_model_metrics,
     "Compute model metrics on a frame"),
    ("POST", "/99/AutoMLBuilder", h_automl_build, "Run AutoML"),
    ("GET", "/99/AutoML/{aml_id}", h_automl_get, "AutoML state"),
    ("GET", "/99/Leaderboards/{aml_id}", h_leaderboard_get, "AutoML leaderboard"),
    ("POST", "/99/Grid/{algo}", h_grid_build, "Hyperparameter grid search"),
    ("GET", "/99/Models/{model_id}", h_model_get, "Model details (v99 alias)"),
    ("GET", "/99/Grids/{grid_id}", h_grid_get, "Grid results"),
    ("POST", "/99/ImportSQLTable", h_import_sql, "Import a SQL table/query"),
    ("GET", "/3/NetworkTest", h_network_test, "Mesh compute/BW/latency probes"),
    ("POST", "/3/CreateFrame", h_create_frame, "Generate a synthetic frame"),
    ("POST", "/3/SplitFrame", h_split_frame, "Split a frame by ratios"),
    ("POST", "/3/PartialDependences", h_pdp_post, "Compute partial dependence"),
    ("GET", "/3/PartialDependences/{key}", h_pdp_get, "Partial dependence result"),
    ("POST", "/3/FeatureInteraction", h_feature_interaction,
     "Tree-path feature interaction statistics"),
    ("GET", "/3/TargetEncoderTransform", h_te_transform,
     "Apply a trained TargetEncoder to a frame"),
    ("GET", "/3/Metadata/endpoints", h_metadata_endpoints, "List REST endpoints"),
    ("GET", "/3/Metadata/schemas", h_metadata_schemas, "List schemas"),
    ("GET", "/3/Metadata/schemas/{schema_name}", h_metadata_schema, "Schema detail"),
]


def _compile_routes():
    compiled = []
    for method, pattern, handler, summary in ROUTES:
        parts = pattern.strip("/").split("/")
        compiled.append((method, parts, handler))
    return compiled


_COMPILED = _compile_routes()


def _match(method: str, path: str):
    parts = [unquote(p) for p in path.strip("/").split("/")]
    best = None
    for m, pat, handler in _COMPILED:
        if m != method or len(pat) != len(parts):
            continue
        params = {}
        ok = True
        for pp, vp in zip(pat, parts):
            if pp.startswith("{"):
                params[pp[1:-1]] = vp
            elif pp != vp:
                ok = False
                break
        if ok:
            # prefer literal-only matches over parameterized ones
            score = sum(1 for pp in pat if not pp.startswith("{"))
            if best is None or score > best[2]:
                best = (handler, params, score)
    if best is None:
        return None, None
    return best[0], best[1]


class RawReply:
    def __init__(self, data: bytes, content_type: str,
                 headers: Optional[Dict[str, str]] = None):
        self.data = data
        self.content_type = content_type
        self.headers = headers or {}


# ---------------------------------------------------------------------------
# HTTP plumbing
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # per-connection socket timeout: a silent client (or a TLS client that
    # never completes the deferred handshake) releases its handler thread
    # instead of pinning it forever. Generous enough that a keep-alive
    # client polling a long job never sees a surprise close mid-exchange.
    timeout = 300
    server_ref: "ApiServer" = None    # set by ApiServer

    def log_message(self, fmt, *args):    # quiet; reference logs to file
        pass

    # -- body parsing -----------------------------------------------------
    def _read_body(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        ctype = self.headers.get("Content-Type", "")
        if not raw:
            return {}
        if "multipart/form-data" in ctype:
            return self._parse_multipart(raw, ctype)
        if "json" in ctype:
            return json.loads(raw.decode())
        if "octet-stream" in ctype or "zip" in ctype:
            return {"__raw__": raw}
        out: Dict[str, Any] = {}
        for k, vs in parse_qs(raw.decode(), keep_blank_values=True).items():
            out[k] = vs[0]
        return out

    @staticmethod
    def _parse_multipart(raw: bytes, ctype: str) -> Dict[str, Any]:
        """RFC 2046 byte-exact parsing: each body part is delimited by
        CRLF--boundary; strip exactly the framing CRLFs, never content bytes."""
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            return {}
        delim = b"--" + m.group(1).encode()
        out: Dict[str, Any] = {}
        chunks = raw.split(delim)
        # chunks[0] = preamble; last chunk starts with b"--" (close delimiter)
        for part in chunks[1:]:
            if part.startswith(b"--"):
                break
            if part.startswith(b"\r\n"):
                part = part[2:]
            if part.endswith(b"\r\n"):       # CRLF that precedes the next delimiter
                part = part[:-2]
            if b"\r\n\r\n" not in part:
                continue
            head, _, payload = part.partition(b"\r\n\r\n")
            headtext = head.decode(errors="replace")
            if "filename=" in headtext:
                out["__file__"] = payload
                fm = re.search(r'filename="([^"]*)"', headtext)
                if fm:
                    out["__filename__"] = fm.group(1)
            else:
                nm = re.search(r'name="([^"]*)"', headtext)
                if nm:
                    out[nm.group(1)] = payload.decode(errors="replace")
        return out

    # -- replies ----------------------------------------------------------
    def _send(self, code: int, body: bytes, content_type: str,
              extra: Optional[Dict[str, str]] = None):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        tid = tracing.current_trace_id()
        if tid:
            # hand the client its span tree's address (GET /3/Trace/{id})
            self.send_header("X-H2O3-Trace-Id", tid)
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def _reply_json(self, obj: Any, code: int = 200,
                    headers: Optional[Dict[str, str]] = None):
        body = json.dumps(obj, default=_json_default).encode()
        # bare (UNQUOTED) NaN/Infinity tokens are NOT valid JSON: strict
        # parsers (simplejson>=3.19 as vendored by `requests` — i.e.
        # genuine h2o-py — and every browser JSON.parse) reject the whole
        # payload. The quoted "NaN" STRINGS in frame previews (ColV3
        # convention) are fine and must not trigger the slow path.
        if _BARE_NONFINITE.search(body):
            body = json.dumps(_definite(obj), default=_json_default,
                              allow_nan=False).encode()
        self._send(code, body, "application/json", headers)

    def _reply_error(self, msg: str, code: int, schema: str = "H2OErrorV3",
                     stack: Optional[List[str]] = None,
                     headers: Optional[Dict[str, str]] = None):
        self._reply_json(S.error_v3(msg, code, stacktrace=stack,
                                    schema=schema), code, headers)

    # -- auth (reference: hash-file basic auth, water.webserver
    #    BasicAuth/-hash_login; enabled via H2O_TPU_AUTH_FILE) -------------
    def _authorized(self) -> bool:
        auth = getattr(self.server_ref, "auth", None)
        login = getattr(self.server_ref, "login_module", None)
        if not auth and login is None:
            return True
        import base64
        import hashlib

        hdr = self.headers.get("Authorization", "")
        if not hdr.startswith("Basic "):
            return False
        try:
            user, _, pw = base64.b64decode(hdr[6:]).decode().partition(":")
        except Exception:   # noqa: BLE001 — malformed header
            return False
        if login is not None:
            # pluggable authenticator (reference: JAAS login modules —
            # h2o-security LDAP/PAM/Kerberos realms plug in the same way):
            # any callable(user, password) -> bool
            try:
                return bool(login(user, pw))
            except Exception:   # noqa: BLE001 — authenticator fault = deny
                return False
        import hmac

        want = auth.get(user)
        return bool(want) and hmac.compare_digest(
            hashlib.sha256(pw.encode()).hexdigest(), want)

    # -- dispatch ---------------------------------------------------------

    # routes that poll/scrape (metrics scrapers, job pollers, the
    # observability surfaces themselves): tracing them would evict the
    # interesting traces from the bounded store
    _UNTRACED = ("/3/Metrics", "/3/Trace", "/3/FlightRecords", "/3/Ping",
                 "/3/Timeline", "/3/Jobs", "/3/CloudStatus")

    def _handle(self):
        t0 = time.time()
        u = urlparse(self.path)
        traced = not any(u.path.startswith(p) for p in self._UNTRACED)
        span_cm = (tracing.root_span("ingress", method=self.command,
                                     path=u.path)
                   if traced else contextlib.nullcontext())
        try:
            with span_cm:
                try:
                    return self._dispatch(u)
                finally:
                    if traced:
                        span_cm.set(status=self._last_status)
        finally:
            dt = time.time() - t0
            _timeline_record(self.command, u.path, self._last_status, dt * 1000)
            obs_metrics.inc("h2o3_rest_requests_total",
                            status=f"{self._last_status // 100}xx")
            obs_metrics.observe("h2o3_rest_request_seconds", dt)

    _last_status = 200

    def _dispatch(self, u):
        status = 200
        try:
            # the body must ALWAYS be drained FIRST — before auth/route
            # early returns: h2o-py sends form bodies on GET too (e.g. GET
            # /99/Grids with sort_by), and any unread body bytes desync the
            # keep-alive stream so the NEXT request on the connection hangs
            body = self._read_body()
            if not self._authorized():
                status = 401
                return self._send(401, b'{"error":"unauthorized"}',
                                  "application/json",
                                  {"WWW-Authenticate": 'Basic realm="h2o3"'})
            handler, params = _match(self.command, u.path)
            if handler is None:
                status = 404
                return self._reply_error(f"unknown route {self.command} {u.path}", 404)
            query = {k: v[0] for k, v in parse_qs(u.query, keep_blank_values=True).items()}
            ctx = Ctx(params, query, body, self.server_ref)
            out = handler(ctx)
            if isinstance(out, RawReply):
                return self._send(200, out.data, out.content_type, out.headers)
            with tracing.span("reply"):
                return self._reply_json(out)
        except ApiError as e:
            status = e.status
            return self._reply_error(str(e), e.status, e.schema)
        except AdmissionRejected as e:
            # serving-tier overload: refuse fast with the standard backoff
            # hint instead of letting the request pile onto a saturated
            # model (429 queue overflow / 503 queued-request timeout)
            status = e.status
            return self._reply_error(
                str(e), e.status,
                headers={"Retry-After":
                         str(int(math.ceil(e.retry_after_s)))})
        except MemoryPressureError as e:
            # exhausted OOM degradation ladder: the typed pressure error
            # carries its own cooldown-derived backoff hint — a clean 503
            # + Retry-After, never a raw RESOURCE_EXHAUSTED 500
            status = e.status
            return self._reply_error(
                str(e), e.status,
                headers={"Retry-After":
                         str(int(math.ceil(e.retry_after_s)))})
        except (CloudUnhealthyError, OplogPublishError,
                OplogTurnTimeout) as e:
            # supervised degraded-mode fail-fast: the cloud cannot complete
            # multi-process work (dead/stale/crashed follower, lost op
            # publish, wedged turnstile) — 503 with the diagnosis (incl.
            # any remote traceback) instead of a hang
            status = 503
            return self._reply_error(str(e), 503)
        except NotImplementedError as e:
            from h2o3_tpu_torch.errors import CapabilityGate

            if isinstance(e, CapabilityGate):
                # deliberate capability gates (XLS/Avro parsers, cloud SDKs)
                status = 501
                return self._reply_error(str(e), 501)
            # abstract-hook NotImplementedError is a server bug, not a gate
            status = 500
            return self._reply_error(
                f"{type(e).__name__}: {e}", 500,
                stack=traceback.format_exc().splitlines()[-12:])
        except BrokenPipeError:
            status = 499
        except Exception as e:          # noqa: BLE001 — API boundary
            status = 500
            return self._reply_error(
                f"{type(e).__name__}: {e}", 500,
                stack=traceback.format_exc().splitlines()[-12:])
        finally:
            self._last_status = status

    do_GET = do_POST = do_DELETE = do_PUT = do_HEAD = _handle


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: Python's default of 5 resets connections when
    # more clients than that connect at once (16 concurrent scoring
    # clients do); the reference keeps the default (ROADMAP C35)
    request_queue_size = 128


class ApiServer:
    """Owns the HTTP thread (reference: water.webserver jetty adapters)."""

    def __init__(self, port: int = 54321,
                 auth_file: Optional[str] = None,
                 host: Optional[str] = None,
                 ssl_certfile: Optional[str] = None,
                 ssl_keyfile: Optional[str] = None):
        # bind address: loopback by default; containers/pods set
        # H2O_TPU_BIND=0.0.0.0 (deploy/ manifests do)
        self.host = host or os.environ.get("H2O_TPU_BIND", "127.0.0.1")
        self.port = port
        self.httpd: Optional[ThreadingHTTPServer] = None
        self.thread: Optional[threading.Thread] = None
        # a multi-process cloud's beater and supervisor (start_server)
        self.heartbeat_thread = None
        self.supervisor = None
        # TLS on the REST bind (reference: water/network/SSLProperties +
        # jetty h2o_ssl_jks options; here a PEM cert/key pair, the
        # standard python-stack equivalent)
        self.ssl_certfile = ssl_certfile or os.environ.get("H2O_TPU_SSL_CERT")
        self.ssl_keyfile = ssl_keyfile or os.environ.get("H2O_TPU_SSL_KEY")
        if bool(self.ssl_certfile) != bool(self.ssl_keyfile):
            raise ValueError("TLS needs BOTH H2O_TPU_SSL_CERT and "
                             "H2O_TPU_SSL_KEY (PEM paths)")
        # pluggable login module (reference: -login_conf JAAS realms —
        # LDAP/PAM/Kerberos): H2O_TPU_LOGIN_MODULE="pkg.mod:callable",
        # callable(user, password) -> bool. Takes precedence over the
        # hash-file table when both are configured.
        self.login_module = None
        spec = os.environ.get("H2O_TPU_LOGIN_MODULE", "")
        if spec:
            import importlib

            mod_name, _, fn_name = spec.partition(":")
            if not fn_name:
                raise ValueError("H2O_TPU_LOGIN_MODULE must be "
                                 "'module:callable'")
            self.login_module = getattr(importlib.import_module(mod_name),
                                        fn_name)
        # {user: sha256(password) hex} from "user:hash" lines
        self.auth: Optional[Dict[str, str]] = None
        path = auth_file or os.environ.get("H2O_TPU_AUTH_FILE")
        if path:
            self.auth = {}
            with open(path) as f:
                for ln in f:
                    ln = ln.strip()
                    if ln and not ln.startswith("#"):
                        user, _, h = ln.partition(":")
                        self.auth[user] = h.strip()
            if not self.auth:
                # fail CLOSED: a configured-but-empty hash file must not
                # silently disable auth (template files, bad parses)
                raise ValueError(f"auth file {path!r} contains no "
                                 "user:sha256hex entries")

    def start(self) -> "ApiServer":
        handler = type("_BoundHandler", (_Handler,), {"server_ref": self})
        self.httpd = _HTTPServer((self.host, self.port), handler)
        if self.ssl_certfile:
            import ssl

            sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            sctx.minimum_version = ssl.TLSVersion.TLSv1_2
            sctx.load_cert_chain(self.ssl_certfile, self.ssl_keyfile)
            # handshake must happen in the per-connection handler thread,
            # NOT the accept loop: with on-connect handshakes one idle TCP
            # connection (port scan, health probe) wedges serve_forever and
            # the whole API with it
            self.httpd.socket = sctx.wrap_socket(
                self.httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        return self

    @property
    def scheme(self) -> str:
        return "https" if self.ssl_certfile else "http"

    def stop(self):
        """Stop serving and close the listening socket; idempotent."""
        if self.httpd:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None
        if self.thread is not None:
            self.thread.join(timeout=10)
            self.thread = None
        if self.heartbeat_thread is not None:
            self.heartbeat_thread.stop()
            self.heartbeat_thread = None
        if self.supervisor is not None:
            self.supervisor.stop()
            self.supervisor = None
        from h2o3_tpu_torch.parallel import oplog

        oplog.REST_SERVING = False


def start_server(port: int = 54321, auth_file: Optional[str] = None,
                 host: Optional[str] = None,
                 ssl_certfile: Optional[str] = None,
                 ssl_keyfile: Optional[str] = None,
                 device=None) -> ApiServer:
    """Bind the REST server (``port=0``: an ephemeral port, read back
    from ``.port``) on a background thread. It serves the runtime
    `core/runtime.init` booted; with none booted it boots `device`
    (None: the card, raising when there is none). On a cloud of more than
    one process (`parallel/distributed.initialize`) it also starts this
    process's heartbeat thread and the supervisor (which owns the
    recovery watchdog), both stopped by ``stop()``."""
    from h2o3_tpu_torch.core import runtime
    from h2o3_tpu_torch.obs import flight, phases
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import oplog

    if runtime._CLUSTER is None or device is not None:
        runtime.init(device)
    oplog.REST_SERVING = True
    # fatal-signal flight hooks (H2O_TPU_OBS_SIGNALS=0 disables; a no-op
    # off the main thread)
    flight.install_signal_hooks()
    with phases.enter("server_start", port=port):
        srv = ApiServer(port, auth_file=auth_file, host=host,
                        ssl_certfile=ssl_certfile,
                        ssl_keyfile=ssl_keyfile).start()
        if D.process_count() > 1:
            from h2o3_tpu_torch.core.failure import HeartbeatThread
            from h2o3_tpu_torch.parallel import supervisor

            # a restarted cloud starts from evidence, not from an earlier
            # verdict: the first evaluate() re-derives FAILED from any
            # error records still in the KV
            supervisor.reset()
            # a runtime booted on the cloud already beats (its beater
            # outlives stop(): the process stays a cloud member)
            if getattr(runtime._CLUSTER, "_heartbeat", None) is None:
                srv.heartbeat_thread = HeartbeatThread().start()
            srv.supervisor = supervisor.Supervisor().start()
        return srv


def assume_coordination(port: int = 54321, caught_up_seq=None,
                        force: bool = False, **server_kw) -> ApiServer:
    """Standby-coordinator handoff, REST side: win the election
    (``oplog.assume_coordination``: the lowest live process wins, only
    past ``H2O_TPU_ELECTION_GRACE_S`` of coordinator silence), then bind
    this process's REST server so ``/3/*`` is served under the new
    epoch. Raises ``oplog.ElectionLost`` without side effects when this
    process is not the winner, the coordinator is not silent long
    enough, or (in one process) there is no coordinator to take over
    from."""
    from h2o3_tpu_torch.parallel import oplog

    oplog.assume_coordination(caught_up_seq=caught_up_seq, force=force)
    return start_server(port=port, **server_kw)


# ---------------------------------------------------------------------------
# extended surface (routes_ext.py) — appended after every server name exists
# so dispatch and /3/Metadata/endpoints see the full table. If routes_ext
# was imported FIRST (it is mid-import here and `register` not yet defined),
# its own module bottom self-registers + recompiles instead.
# ---------------------------------------------------------------------------
from h2o3_tpu_torch.api import routes_ext as _ext  # noqa: E402

if hasattr(_ext, "register"):
    _ext.register(ROUTES, {"h_model_mojo": h_model_mojo,
                           "h_importfiles": h_importfiles,
                           "h_pdp_post": h_pdp_post,
                           "h_pdp_get": h_pdp_get,
                           "h_modelbuilder_train": h_modelbuilder_train,
                           "h_session_end_legacy": h_session_end})
    _COMPILED = _compile_routes()
