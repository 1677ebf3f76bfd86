"""Process-wide metrics registry and its aggregation (counterpart of
h2o3_tpu/obs/metrics.py), served on ``GET /3/Metrics`` as Prometheus
text exposition (``text/plain; version=0.0.4``) and as JSON.

- **One registration site**: every metric is registered once, in
  :func:`_install_default_metrics`, with the reference's name, type and
  labels; names match ``^h2o3_[a-z0-9_]+$``. Producers increment by
  name (:func:`inc`, :func:`observe`) or are read at snapshot time
  through a collector callback over the counters their modules keep
  (scoring, admission, the compile cache, Rapids fusion and the lazy
  planner, the pipeline, ingest, the memory planner, search); the
  callbacks import lazily, so this module never pulls the stack in.
- **Bounded label sets**: a metric stores at most ``_LABEL_CAP``
  distinct label tuples; overflow lands on one ``{"overflow": "true"}``
  sample.
- **Aggregation**: every process of a cloud publishes its snapshot to
  the cloud KV under ``obs/metrics/{proc}`` (`publish_snapshot`, and
  its /3/Runtime part under ``obs/runtime/{proc}``;
  `maybe_publish`, throttled by ``H2O_TPU_OBS_PUBLISH_S``, runs after
  each op a follower replays and on each watchdog tick), and
  `cluster_aggregate` merges this process's live registry with the
  others' published snapshots: counters and histograms sum, gauges
  follow their declared aggregation (sum or max). In one process it is
  this registry.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

NAME_RE = re.compile(r"^h2o3_[a-z0-9_]+$")

_LABEL_CAP = 32           # distinct label tuples per metric
_OVERFLOW_LABELS = (("overflow", "true"),)

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0, 30.0)


class Metric:
    """One registered series: a direct counter/gauge (incremented /set by
    name), a histogram, or a callback-collected series whose values are
    read from their owning module at snapshot time."""

    __slots__ = ("name", "mtype", "help", "agg", "labels", "buckets",
                 "_values", "_hist", "_fn", "_lock")

    def __init__(self, name: str, mtype: str, help_: str, agg: str = "sum",
                 fn: Optional[Callable] = None,
                 buckets: Tuple[float, ...] = _DEFAULT_BUCKETS):
        if not NAME_RE.match(name):
            raise ValueError(f"metric name {name!r} must match "
                             f"{NAME_RE.pattern}")
        self.name = name
        self.mtype = mtype           # counter | gauge | histogram
        self.help = help_
        self.agg = agg               # gauges: sum | max
        self.buckets = tuple(sorted(buckets))
        self._values: Dict[tuple, float] = {}
        self._hist: Dict[tuple, List] = {}   # labels -> [counts..., sum, n]
        self._fn = fn
        self._lock = threading.Lock()

    def _label_key(self, labels: Dict[str, str], store) -> tuple:
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        if key not in store and len(store) >= _LABEL_CAP:
            return _OVERFLOW_LABELS
        return key

    def inc(self, n: float = 1.0, **labels) -> None:
        with self._lock:
            key = self._label_key(labels, self._values)
            self._values[key] = self._values.get(key, 0.0) + float(n)

    def set(self, v: float, **labels) -> None:
        with self._lock:
            key = self._label_key(labels, self._values)
            self._values[key] = float(v)

    def observe(self, v: float, **labels) -> None:
        v = float(v)
        with self._lock:
            key = self._label_key(labels, self._hist)
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = [0] * len(self.buckets) + [0.0, 0]
            for i, le in enumerate(self.buckets):
                if v <= le:
                    h[i] += 1
            h[-2] += v
            h[-1] += 1

    def snapshot(self) -> dict:
        out = {"name": self.name, "type": self.mtype, "help": self.help,
               "agg": self.agg}
        if self.mtype == "histogram":
            with self._lock:
                out["buckets"] = list(self.buckets)
                out["samples"] = [
                    {"labels": dict(k), "bucket_counts": list(h[:-2]),
                     "sum": h[-2], "count": h[-1]}
                    for k, h in self._hist.items()]
            return out
        samples: List[dict] = []
        if self._fn is not None:
            try:
                got = self._fn()
            except Exception:   # noqa: BLE001 — one broken collector must
                got = None      # never break the whole scrape
            if isinstance(got, dict):
                samples = [{"labels": dict(k) if isinstance(k, tuple) else {},
                            "value": float(v)} for k, v in got.items()]
            elif got is not None:
                samples = [{"labels": {}, "value": float(got)}]
        else:
            with self._lock:
                samples = [{"labels": dict(k), "value": v}
                           for k, v in self._values.items()]
            if not samples and self.mtype in ("counter", "gauge"):
                samples = [{"labels": {}, "value": 0.0}]
        out["samples"] = samples
        return out


class Registry:
    """Named metrics; registering the same name twice raises (the
    consistency suite additionally guards the source for drift)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _register(self, m: Metric) -> Metric:
        with self._lock:
            if m.name in self._metrics:
                raise ValueError(f"metric {m.name!r} is already registered")
            self._metrics[m.name] = m
        return m

    def counter(self, name: str, help_: str) -> Metric:
        return self._register(Metric(name, "counter", help_))

    def gauge(self, name: str, help_: str, agg: str = "sum") -> Metric:
        return self._register(Metric(name, "gauge", help_, agg=agg))

    def histogram(self, name: str, help_: str,
                  buckets: Tuple[float, ...] = _DEFAULT_BUCKETS) -> Metric:
        return self._register(Metric(name, "histogram", help_,
                                     buckets=buckets))

    def counter_fn(self, name: str, help_: str, fn: Callable) -> Metric:
        return self._register(Metric(name, "counter", help_, fn=fn))

    def gauge_fn(self, name: str, help_: str, fn: Callable,
                 agg: str = "sum") -> Metric:
        return self._register(Metric(name, "gauge", help_, agg=agg, fn=fn))

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> List[dict]:
        with self._lock:
            ms = list(self._metrics.values())
        return [m.snapshot() for m in ms]


REGISTRY = Registry()


# -- producer-facing helpers (never raise: observability must not take the
#    serving path down) ------------------------------------------------------

def inc(name: str, n: float = 1.0, **labels) -> None:
    m = REGISTRY.get(name)
    if m is not None:
        m.inc(n, **labels)


def set_gauge(name: str, v: float, **labels) -> None:
    m = REGISTRY.get(name)
    if m is not None:
        m.set(v, **labels)


def observe(name: str, v: float, **labels) -> None:
    m = REGISTRY.get(name)
    if m is not None:
        m.observe(v, **labels)


_KV_PREFIX = "obs/metrics/"
_PUB_LOCK = threading.Lock()
_LAST_PUBLISH = 0.0


def _publish_interval_s() -> float:
    """Seconds between throttled snapshot publishes
    (``H2O_TPU_OBS_PUBLISH_S``, default 2)."""
    return float(os.environ.get("H2O_TPU_OBS_PUBLISH_S", "2"))


def _proc_index() -> int:
    from h2o3_tpu_torch.parallel import distributed as D

    return D.process_index()


def publish_snapshot(proc: Optional[int] = None) -> bool:
    """Publish this process's snapshot under ``obs/metrics/{proc}`` (the
    coordinator merges them into the cloud's series); False without a
    cloud KV."""
    from h2o3_tpu_torch.parallel import distributed as D

    p = _proc_index() if proc is None else int(proc)
    try:
        return D.kv_put(_KV_PREFIX + str(p),
                        json.dumps({"proc": p, "ts": time.time(),
                                    "metrics": REGISTRY.snapshot()}))
    except Exception:   # noqa: BLE001 — best effort by contract
        return False


def maybe_publish() -> None:
    """`publish_snapshot` at most once per ``H2O_TPU_OBS_PUBLISH_S`` (after
    a follower's replayed op, on a watchdog tick); a no-op in one
    process."""
    global _LAST_PUBLISH
    from h2o3_tpu_torch.parallel import distributed as D

    if D.process_count() <= 1:
        return
    now = time.monotonic()
    with _PUB_LOCK:
        if now - _LAST_PUBLISH < _publish_interval_s():
            return
        _LAST_PUBLISH = now
    publish_snapshot()
    from h2o3_tpu_torch.obs import compiles

    compiles.publish_runtime()       # /3/Runtime rides the same throttle


def cluster_snapshots() -> List[dict]:
    """This process's live snapshot and every other process's published
    one, as [{proc, ts, metrics}]."""
    from h2o3_tpu_torch.parallel import distributed as D

    me = _proc_index()
    out = [{"proc": me, "ts": time.time(), "metrics": REGISTRY.snapshot()}]
    for _k, v in D.kv_dir(_KV_PREFIX):
        try:
            rec = json.loads(v)
        except (ValueError, TypeError):
            continue
        if not isinstance(rec, dict) or rec.get("proc") == me:
            continue
        out.append(rec)
    return out


def aggregate(snaps: List[dict]) -> List[dict]:
    """Merge per-process snapshots into the cloud's series by name, with
    the labels as strings and a ``buckets`` key on every series (None but
    for histograms): counters and histograms sum, gauges follow their
    declared aggregation (sum or max)."""
    merged: Dict[str, dict] = {}
    for snap in snaps:
        for m in snap.get("metrics", []):
            name = m.get("name")
            if not name:
                continue
            agg = merged.get(name)
            if agg is None:
                agg = merged[name] = {"name": name, "type": m.get("type"),
                                      "help": m.get("help", ""),
                                      "agg": m.get("agg", "sum"),
                                      "buckets": m.get("buckets"),
                                      "_samples": {}}
            for smp in m.get("samples", []):
                key = tuple(sorted((str(k), str(v)) for k, v in
                                   (smp.get("labels") or {}).items()))
                cur = agg["_samples"].get(key)
                if agg["type"] == "histogram":
                    bc = list(smp.get("bucket_counts", []))
                    if cur is None:
                        agg["_samples"][key] = {
                            "labels": dict(key), "bucket_counts": bc,
                            "sum": float(smp.get("sum", 0.0)),
                            "count": int(smp.get("count", 0))}
                    else:
                        cur["bucket_counts"] = ([a + b for a, b in zip(
                            cur["bucket_counts"], bc)]
                            if cur["bucket_counts"] else bc)
                        cur["sum"] += float(smp.get("sum", 0.0))
                        cur["count"] += int(smp.get("count", 0))
                    continue
                v = float(smp.get("value", 0.0))
                if cur is None:
                    agg["_samples"][key] = {"labels": dict(key), "value": v}
                elif agg["type"] == "gauge" and agg["agg"] == "max":
                    cur["value"] = max(cur["value"], v)
                else:
                    cur["value"] += v
    out = []
    for name in sorted(merged):
        m = merged[name]
        m["samples"] = list(m.pop("_samples").values())
        out.append(m)
    return out


def cluster_aggregate() -> List[dict]:
    """The cloud's series (`aggregate` of `cluster_snapshots`)."""
    return aggregate(cluster_snapshots())


def histogram_quantiles(buckets: List[float], bucket_counts: List[int],
                        count: int,
                        qs: Tuple[float, ...] = (0.5, 0.95, 0.99)
                        ) -> Dict[str, Optional[float]]:
    """Estimated quantiles from cumulative bucket counts (the standard
    histogram_quantile linear interpolation within the owning bucket;
    targets past the last finite bucket report that bucket's bound, the
    Prometheus convention). ``/3/Metrics?format=json`` attaches these so
    JSON consumers get p50/p95/p99 without re-deriving them from raw
    bucket counts."""
    out: Dict[str, Optional[float]] = {}
    total = int(count)
    for q in qs:
        key = f"p{int(q * 100)}"
        if total <= 0 or not buckets:
            out[key] = None
            continue
        target = q * total
        val: Optional[float] = None
        prev_cum = 0
        for i, (le, cum) in enumerate(zip(buckets, bucket_counts)):
            if cum >= target:
                lo = buckets[i - 1] if i > 0 else 0.0
                in_bucket = cum - prev_cum
                frac = ((target - prev_cum) / in_bucket) if in_bucket else 1.0
                val = lo + (le - lo) * frac
                break
            prev_cum = cum
        if val is None:
            # target lands in the +Inf bucket
            val = float(buckets[-1])
        out[key] = round(val, 6)
    return out


# ---------------------------------------------------------------------------
# Prometheus text exposition (format 0.0.4)
# ---------------------------------------------------------------------------

def _esc_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n",
                                                                   r"\n")


def _label_str(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_esc_label(v)}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_text(series: List[dict]) -> str:
    lines: List[str] = []
    for m in series:
        name, mtype = m["name"], m.get("type", "gauge")
        lines.append(f"# HELP {name} {m.get('help', '')}")
        lines.append(f"# TYPE {name} {mtype}")
        for s in m.get("samples", []):
            labels = s.get("labels") or {}
            if mtype == "histogram":
                for le, c in zip(m.get("buckets") or [],
                                 s.get("bucket_counts", [])):
                    # bucket counts are already cumulative
                    le_lab = 'le="%s"' % le
                    lines.append(f"{name}_bucket"
                                 f"{_label_str(labels, le_lab)} {_fmt(c)}")
                inf_lab = 'le="+Inf"'
                lines.append(f"{name}_bucket{_label_str(labels, inf_lab)} "
                             f"{_fmt(s.get('count', 0))}")
                lines.append(f"{name}_sum{_label_str(labels)} "
                             f"{_fmt(s.get('sum', 0.0))}")
                lines.append(f"{name}_count{_label_str(labels)} "
                             f"{_fmt(s.get('count', 0))}")
            else:
                lines.append(f"{name}{_label_str(labels)} "
                             f"{_fmt(s.get('value', 0.0))}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# default metric set — THE single registration site (consistency-guarded):
# the ad-hoc counters that predate this registry (scoring, admission,
# compile cache, data plane, oplog, supervisor, watchdog) re-register here
# as collector callbacks; their modules stay the source of truth and are
# imported lazily at snapshot time.
# ---------------------------------------------------------------------------

_START_TS = time.time()


# series the reference's registry has no counterpart for: the row
# exchange's and DeepLearning's cross-rank traffic (its device mesh moves
# rows inside its programs, uncounted)
PORT_ONLY_SERIES = ("h2o3_data_plane_exchanged_rows_total",
                    "h2o3_data_plane_exchanged_bytes_total",
                    "h2o3_data_plane_dl_batch_rows_total")


def data_plane_counters() -> Dict[str, int]:
    """The sharded data plane's counters (core/sharded_frame.py): rows
    packed from a rank's own rows, rows a device sort ordered, rows of
    sharded columns gathered to this process."""
    from h2o3_tpu_torch.core import sharded_frame

    return sharded_frame.counters()


def _scoring_field(field: str) -> float:
    from h2o3_tpu_torch import scoring

    return float(sum(e.get(field, 0) for e in scoring.metrics_snapshot()))


def _install_default_metrics() -> None:
    r = REGISTRY

    # -- direct counters/histograms (incremented by name at the source) --
    r.counter("h2o3_rest_requests_total",
              "REST requests served, by status class")
    r.histogram("h2o3_rest_request_seconds",
                "REST request wall time (seconds)")
    r.counter("h2o3_trace_spans_total", "trace spans recorded")
    r.counter("h2o3_flight_records_total", "flight records written")
    r.counter("h2o3_oplog_ops_published_total",
              "oplog ops published by this coordinator")
    r.counter("h2o3_oplog_ops_replayed_total",
              "oplog ops replayed by this follower")
    r.counter("h2o3_oplog_errors_total",
              "follower-side oplog error records written")
    r.counter("h2o3_oplog_rejoins_total", "successful rejoin() readmissions")
    r.counter("h2o3_cloud_transitions_total",
              "cloud health state transitions, by target state")
    r.counter("h2o3_tree_trees_built_total",
              "trees built across all forest trainers")
    r.counter("h2o3_log_messages_total",
              "framework log records, by level (warning and up)")

    # -- lifecycle phase tracker (obs/phases.py) --
    r.gauge("h2o3_phase_active",
            "1 while the labeled lifecycle phase is in progress")
    r.histogram("h2o3_phase_duration_seconds",
                "lifecycle phase wall time (backend_init .. server_start)")
    r.counter("h2o3_phase_completed_total",
              "lifecycle phases completed inside their deadline, by phase")
    r.counter("h2o3_phase_deadline_exceeded_total",
              "lifecycle phase hard-deadline expiries, by phase")
    r.counter("h2o3_phase_cpu_fallbacks_total",
              "deadline expiries that engaged the CPU-chain fallback")

    # -- collector-backed series (existing ad-hoc counters re-registered) --
    def _dp(field):
        def fn():
            return float(data_plane_counters()[field])
        return fn

    r.counter_fn("h2o3_data_plane_packed_rows_total",
                 "rows packed shard-locally (no host round-trip)",
                 _dp("packed_rows"))
    r.counter_fn("h2o3_data_plane_device_sorted_rows_total",
                 "rows ordered by device sorts whose permutation never "
                 "crossed to the host", _dp("device_sorted_rows"))
    r.counter_fn("h2o3_data_plane_gathered_rows_total",
                 "rows whose columns were gathered to this host "
                 "(exceptional path)", _dp("gathered_rows"))
    r.counter_fn("h2o3_data_plane_exchanged_rows_total",
                 "rows this process sent to other ranks through the row "
                 "exchange", _dp("exchanged_rows"))
    r.counter_fn("h2o3_data_plane_exchanged_bytes_total",
                 "bytes this process sent to other ranks through the row "
                 "exchange", _dp("exchanged_bytes"))
    r.counter_fn("h2o3_data_plane_dl_batch_rows_total",
                 "DeepLearning batch rows fetched from other ranks",
                 _dp("dl_batch_rows"))

    # -- chunked ingest (ingest/chunked.py) --
    def _ing(field):
        def fn():
            from h2o3_tpu_torch.ingest import chunked

            return float(chunked.counters()[field])
        return fn

    r.counter_fn("h2o3_ingest_chunks_total",
                 "byte-range chunks parsed by this process", _ing("chunks"))
    r.counter_fn("h2o3_ingest_chunk_rows_total",
                 "rows ingested through the chunked sharded parse path",
                 _ing("chunk_rows"))
    r.counter_fn("h2o3_ingest_coordinator_bytes_total",
                 "ingest bytes staged as whole-column host buffers: the "
                 "legacy/fallback paths, plus T_TIME columns (column-wide "
                 "datetime inference) — 0 on the chunked path otherwise",
                 _ing("coordinator_ingest_bytes"))
    r.counter_fn("h2o3_ingest_stream_appends_total",
                 "streaming micro-batch appends (POST /3/ParseStream)",
                 _ing("stream_appends"))
    r.counter_fn("h2o3_ingest_stream_rows_total",
                 "rows appended through the streaming shard-tail path",
                 _ing("stream_rows"))
    r.gauge_fn("h2o3_ingest_overlap_ratio",
               "fraction of aggregate split/parse/resolve/ship seconds "
               "hidden by pipelining (multi-core parse + async H2D) in "
               "the last chunked parse", _ing("overlap_ratio"), agg="max")
    r.histogram("h2o3_ingest_parse_seconds",
                "per-chunk parse wall time (seconds)")

    r.counter_fn("h2o3_scoring_requests_total",
                 "fused-path scoring requests",
                 lambda: _scoring_field("requests"))
    r.counter_fn("h2o3_scoring_batches_total",
                 "coalesced scoring batches dispatched",
                 lambda: _scoring_field("batches"))
    r.counter_fn("h2o3_scoring_rows_total", "rows scored on the fused path",
                 lambda: _scoring_field("rows"))
    r.counter_fn("h2o3_scoring_fused_compiles_total",
                 "scoring-bucket CUDA-graph captures across live sessions",
                 lambda: _scoring_field("fused_compiles"))
    r.counter_fn("h2o3_scoring_compile_cache_hits_total",
                 "fused executables served from the persistent cache",
                 lambda: _scoring_field("compile_cache_hits"))

    # -- per-flush dispatch accounting, by path label --
    def _score_dispatches():
        from h2o3_tpu_torch import scoring

        return {(("path", p),): float(n)
                for p, n in scoring.dispatch_counters().items()}

    r.counter_fn("h2o3_score_dispatches_total",
                 "fused program executions on the serving/explainability "
                 "paths, by path", _score_dispatches)
    r.histogram("h2o3_score_flush_requests",
                "requests coalesced per micro-batch flush",
                buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
    r.histogram("h2o3_score_request_seconds",
                "fused-path request latency (admission + batching + "
                "dispatch), by model — the SLO-adaptive admission signal")

    def _rapids(field):
        def fn():
            from h2o3_tpu_torch.rapids import fusion

            return float(fusion.counters()[field])
        return fn

    r.counter_fn("h2o3_rapids_statements_total",
                 "rapids statements executed", _rapids("statements"))
    r.counter_fn("h2o3_rapids_fused_statements_total",
                 "statements that ran at least one fused program",
                 _rapids("fused_statements"))
    r.counter_fn("h2o3_rapids_fused_programs_total",
                 "fused rapids program executions", _rapids("fused_programs"))
    r.counter_fn("h2o3_rapids_fused_programs_compiled_total",
                 "fused rapids programs actually captured",
                 _rapids("fused_programs_compiled"))
    r.counter_fn("h2o3_rapids_compile_cache_hits_total",
                 "fused rapids programs served warm (signature or disk "
                 "tier)", _rapids("compile_cache_hits"))
    r.counter_fn("h2o3_rapids_barrier_fallbacks_total",
                 "host-fallback prim executions (the exceptional path)",
                 _rapids("barrier_fallbacks"))
    r.counter_fn("h2o3_rapids_host_materialized_cells_total",
                 "cells staged on host by host-fallback prims",
                 _rapids("host_materialized_cells"))
    r.counter_fn("h2o3_rapids_fused_rows_total",
                 "logical rows through fused rapids programs",
                 _rapids("fused_rows"))
    r.histogram("h2o3_rapids_statement_seconds",
                "rapids statement wall time over POST /99/Rapids (seconds)")

    # -- lazy-session planner (cross-statement DAG, rapids/planner.py) --
    def _lazy(field):
        def fn():
            from h2o3_tpu_torch.rapids import planner

            return float(planner.counters()[field])
        return fn

    r.counter_fn("h2o3_rapids_deferred_statements_total",
                 "statements deferred into session DAGs", _lazy("deferred_statements"))
    r.counter_fn("h2o3_rapids_flushes_total",
                 "lazy-session DAG flushes", _lazy("flushes"))
    r.counter_fn("h2o3_rapids_cse_hits_total",
                 "deferred statements served from an identical node "
                 "(common-subexpression elimination)", _lazy("cse_hits"))
    r.counter_fn("h2o3_rapids_dead_temps_eliminated_total",
                 "deferred statements never computed (output overwritten "
                 "or removed before any observation)",
                 _lazy("dead_temps_eliminated"))
    r.counter_fn("h2o3_rapids_inlined_intermediates_total",
                 "deferred intermediates spliced into a consumer's fused "
                 "program without materializing a Column",
                 _lazy("inlined_intermediates"))
    r.counter_fn("h2o3_rapids_fused_sort_selections_total",
                 "sort+row-slice pairs executed as one windowed gather",
                 _lazy("fused_sort_selections"))
    r.gauge_fn("h2o3_rapids_deferred_pending",
               "deferred statements awaiting flush",
               _lazy("deferred_pending"))

    # -- munge→score pipeline fusion (h2o3_tpu_torch/pipeline.py) --------------
    def _pipe(field):
        def fn():
            from h2o3_tpu_torch import pipeline

            return float(pipeline.counters()[field])
        return fn

    r.counter_fn("h2o3_pipeline_captures_total",
                 "predict calls spliced onto a pending feature DAG",
                 _pipe("captures"))
    r.counter_fn("h2o3_pipeline_fused_dispatches_total",
                 "fused munge→score program executions",
                 _pipe("fused_dispatches"))
    r.counter_fn("h2o3_pipeline_spliced_nodes_total",
                 "pending DAG nodes spliced into fused scoring programs",
                 _pipe("spliced_nodes"))
    r.counter_fn("h2o3_pipeline_materialized_columns_total",
                 "engineered Columns materialized on the pipeline path "
                 "(the zero-materialization contract's observable)",
                 _pipe("materialized_columns"))
    r.counter_fn("h2o3_pipeline_fused_rows_total",
                 "logical rows scored through fused pipeline programs",
                 _pipe("fused_rows"))
    r.counter_fn("h2o3_pipeline_programs_compiled_total",
                 "pipeline programs actually built",
                 _pipe("programs_compiled"))
    r.counter_fn("h2o3_pipeline_compile_cache_hits_total",
                 "pipeline programs served warm (signature or disk tier)",
                 _pipe("compile_cache_hits"))
    r.counter_fn("h2o3_pipeline_fallbacks_total",
                 "captured pipelines that fell back to the staged path",
                 _pipe("fallbacks"))

    def _parse_cache_size():
        from h2o3_tpu_torch.rapids import parser as rapids_parser

        return float(rapids_parser.parse_cache_stats()["size"])

    r.gauge_fn("h2o3_rapids_parse_cache_entries",
               "entries in the bounded statement-parse memo",
               _parse_cache_size)

    def _adm(field):
        def fn():
            from h2o3_tpu_torch import admission

            return float(admission.CONTROLLER.snapshot()[field])
        return fn

    r.counter_fn("h2o3_admission_admitted_total",
                 "requests admitted to the fused path", _adm("admitted"))
    r.counter_fn("h2o3_admission_queued_total",
                 "requests that waited in the admission queue",
                 _adm("queued"))
    r.counter_fn("h2o3_admission_rejected_total",
                 "requests rejected 429 at the admission gate",
                 _adm("rejected"))
    r.counter_fn("h2o3_admission_timed_out_total",
                 "queued requests expired 503 before a slot freed",
                 _adm("timed_out"))
    r.counter_fn("h2o3_admission_shed_slo_total",
                 "requests shed 429 by the SLO queue-time gate",
                 _adm("shed_slo"))

    r.counter_fn("h2o3_admission_shed_mem_total",
                 "requests shed 503 under device memory pressure",
                 _adm("shed_mem"))

    def _adm_limits():
        from h2o3_tpu_torch import admission

        return {(("model", k),): float(v)
                for k, v in admission.CONTROLLER.derived_limits().items()}

    r.gauge_fn("h2o3_admission_limit",
               "effective per-model inflight limit (static knob or "
               "SLO-derived)", _adm_limits, agg="max")

    # -- memory planner / OOM degradation ladder (h2o3_tpu_torch/memory) -------
    def _mem(field):
        def fn():
            from h2o3_tpu_torch.memory import stream

            return float(stream.counters()[field])
        return fn

    r.counter_fn("h2o3_mem_chunked_runs_total",
                 "fused dispatches the budget planner chunk-streamed",
                 _mem("chunked_runs"))
    r.counter_fn("h2o3_mem_windows_total",
                 "row-chunk windows dispatched by the stream driver",
                 _mem("windows"))
    r.counter_fn("h2o3_mem_ladder_halvings_total",
                 "OOM-triggered window halvings (degradation ladder)",
                 _mem("ladder_halvings"))
    r.counter_fn("h2o3_mem_ladder_recoveries_total",
                 "dispatches that hit device OOM and still completed",
                 _mem("ladder_recoveries"))
    r.counter_fn("h2o3_mem_pressure_failures_total",
                 "exhausted degradation ladders (MemoryPressureError)",
                 _mem("pressure_failures"))
    r.counter_fn("h2o3_mem_spill_retries_total",
                 "bounded remote-read retries (DKV fetches + persist "
                 "spill reloads)", _mem("spill_retries"))

    def _mem_budget(field):
        def fn():
            from h2o3_tpu_torch.memory import budget as membudget

            v = getattr(membudget, field)()
            return float(v) if v is not None else 0.0
        return fn

    r.gauge_fn("h2o3_mem_budget_bytes",
               "effective device memory budget (0 = unbudgeted)",
               _mem_budget("budget_bytes"), agg="max")
    r.gauge_fn("h2o3_mem_free_bytes",
               "budget minus headroom minus live column residency",
               _mem_budget("free_bytes"), agg="min")
    r.gauge_fn("h2o3_mem_live_bytes",
               "device bytes committed to frame columns",
               _mem_budget("live_bytes"), agg="max")

    def _mem_spilled():
        from h2o3_tpu_torch.core import cleaner

        return float(cleaner.evicted_count())

    r.gauge_fn("h2o3_mem_spilled_columns",
               "columns currently evicted device→host/disk", _mem_spilled,
               agg="max")

    def _cc(field):
        def fn():
            from h2o3_tpu_torch.artifact import compile_cache

            return float(compile_cache.stats()[field])
        return fn

    r.counter_fn("h2o3_compile_cache_compiles_total",
                 "program builds: captures and exports", _cc("compiles"))

    def _compile_secs():
        from h2o3_tpu_torch.artifact import compile_cache

        return float(compile_cache.stats()["compile_ms_total"]) / 1000.0

    r.counter_fn("h2o3_compile_cache_compile_seconds_total",
                 "wall seconds spent building programs",
                 _compile_secs)
    r.counter_fn("h2o3_compile_cache_disk_hits_total",
                 "persistent compile-cache hits", _cc("disk_hits"))
    r.counter_fn("h2o3_compile_cache_disk_misses_total",
                 "persistent compile-cache misses", _cc("disk_misses"))
    r.counter_fn("h2o3_compile_cache_stores_total",
                 "executables stored to the persistent cache", _cc("stores"))

    # -- compile-ledger views (obs/compiles.py) --
    def _ledger(field):
        def fn():
            from h2o3_tpu_torch.obs import compiles

            return {(("family", fam),): float(a.get(field, 0))
                    for fam, a in compiles.family_table().items()}
        return fn

    r.counter_fn("h2o3_compile_ledger_compiles_total",
                 "ledger-recorded compiles, by program family",
                 _ledger("compiles"))
    r.counter_fn("h2o3_compile_ledger_ms_total",
                 "wall milliseconds of ledger-recorded compiles, "
                 "by program family", _ledger("ms_total"))
    r.counter_fn("h2o3_compile_ledger_memory_hits_total",
                 "in-process signature-cache hits, by program family",
                 _ledger("hits_memory"))
    r.counter_fn("h2o3_compile_ledger_disk_hits_total",
                 "persistent compile-cache hits, by program family",
                 _ledger("hits_disk"))

    def _wd(field):
        def fn():
            from h2o3_tpu_torch.parallel import watchdog

            return float(watchdog.status().get(field, 0))
        return fn

    r.counter_fn("h2o3_watchdog_ticks_total", "recovery watchdog ticks",
                 _wd("ticks"))
    r.counter_fn("h2o3_watchdog_elections_total",
                 "standby elections won by this process", _wd("elections"))
    r.counter_fn("h2o3_watchdog_rejoins_total",
                 "watchdog-driven rejoins", _wd("rejoins"))
    r.counter_fn("h2o3_watchdog_jobs_resumed_total",
                 "externally-failed jobs re-dispatched from durable "
                 "progress", _wd("jobs_resumed"))
    r.counter_fn("h2o3_watchdog_searches_resumed_total",
                 "orphaned AutoML/grid searches re-dispatched from durable "
                 "search state", _wd("searches_resumed"))

    def _srch(field):
        def fn():
            from h2o3_tpu_torch.automl import search

            return float(search.stats().get(field, 0))
        return fn

    r.counter_fn("h2o3_search_members_done_total",
                 "AutoML/grid search members trained to completion",
                 _srch("members_done"))
    r.counter_fn("h2o3_search_members_failed_total",
                 "search member attempts that crashed or timed out",
                 _srch("members_failed"))
    r.counter_fn("h2o3_search_members_parked_total",
                 "search members quarantine-parked after MAX_ATTEMPTS or a "
                 "deterministic config error", _srch("members_parked"))
    r.counter_fn("h2o3_search_member_attempts_total",
                 "search member training attempts started",
                 _srch("attempts"))
    r.counter_fn("h2o3_search_resumed_total",
                 "searches resumed from durable state after coordinator "
                 "loss", _srch("searches_resumed"))
    r.counter_fn("h2o3_search_state_saves_total",
                 "durable search-state snapshots written",
                 _srch("state_saves"))
    r.gauge_fn("h2o3_search_members_running",
               "search members currently training", _srch("running"),
               agg="max")
    r.gauge_fn("h2o3_search_members_overlap",
               "high-water mark of concurrently-training search members",
               _srch("overlap"), agg="max")

    def _cloud_state():
        from h2o3_tpu_torch.parallel import supervisor

        order = {supervisor.HEALTHY: 0, supervisor.DEGRADED: 1,
                 supervisor.RECOVERING: 2, supervisor.FAILED: 3}
        return float(order.get(supervisor.state(), -1))

    r.gauge_fn("h2o3_cloud_state",
               "health state (0 HEALTHY, 1 DEGRADED, 2 RECOVERING, "
               "3 FAILED)", _cloud_state, agg="max")

    def _oplog_seq():
        from h2o3_tpu_torch.parallel import oplog

        return float(oplog.current_seq())

    r.gauge_fn("h2o3_oplog_current_seq",
               "next oplog sequence to be claimed", _oplog_seq, agg="max")

    def _timeline_events():
        from h2o3_tpu_torch.utils import timeline

        return float(len(timeline.events()))

    r.gauge_fn("h2o3_timeline_events", "events in the timeline ring",
               _timeline_events, agg="max")
    r.gauge_fn("h2o3_process_uptime_seconds",
               "seconds since this process registered its metrics",
               lambda: time.time() - _START_TS, agg="max")

    def _devices():
        # the booted device; never initializes CUDA itself
        import sys

        rt = sys.modules.get("h2o3_tpu_torch.core.runtime")
        return 1.0 if getattr(rt, "_CLUSTER", None) is not None else 0.0

    r.gauge_fn("h2o3_local_device_count",
               "accelerator devices addressable by this process", _devices)


_install_default_metrics()


def reset_for_tests() -> None:
    """Zero every direct counter/histogram (collector-backed series follow
    their sources). Tests only."""
    for name in REGISTRY.names():
        m = REGISTRY.get(name)
        with m._lock:
            if m._fn is None:
                m._values.clear()
            m._hist.clear()
