"""Serving fast path: device-resident scoring sessions on CUDA graphs
(counterpart of h2o3_tpu/scoring.py, single-device).

A :class:`ScoringSession` keeps one trained forest's scoring inputs on
the device (compressed.ResidentForest: the walk arrays, padded edges,
categorical mask and init margin, copied once; the tree -> class map as
a host tuple) and scores through one program per row bucket:

- **Shape buckets**: requests are padded to row buckets (env
  ``H2O_TPU_SCORE_BUCKETS``, default 256/1k/4k/16k); larger requests are
  chunked at the largest. Padded rows are zero-filled and sliced off
  before anything reads them.
- **One CUDA graph per bucket** on the card: a bucket's first dispatch
  runs the walk (compressed.score_core) eagerly on the bucket's static
  (bucket, F) float32 input, which also measures its memory for the
  planner (memory/budget.note_compiled); then the walk is captured, and
  every later dispatch copies its rows into the static input and
  replays. A replay overwrites the static output, so each window's rows
  are cloned out before the session lock is released. Captures use
  ``capture_error_mode="thread_local"`` under the process-wide capture
  lock (core/runtime.CAPTURE_LOCK). A failed capture raises. On the CPU
  the same bucket ladder runs eagerly.
- **Micro-batching**: concurrent requests against the same model
  coalesce inside a time box (``H2O_TPU_SCORE_BATCH_WINDOW_MS``, default
  2 ms); a flush's feature rows are concatenated on the device and
  chunked at the bucket ladder, so a flush of small requests costs about
  one dispatch per bucket, and each request gets its exact slice back.
- **Memory**: every dispatch runs under memory/stream.run_windows, the
  planner's windows and the OOM ladder.

``H2O_TPU_SCORE_FAST=0`` turns the path off (`supports` is then False).
A traced request (REST ingress) gets the reference's child spans:
``queue_wait`` (submit to flush, in its own trace), then ``pack``,
``dispatch`` per bucket window and ``fetch`` under the flush leader's
trace; none adds a device sync. Flush sizes and request latency feed
``/3/Metrics``, each flush a ``scoring`` timeline event. Multi-process
serving (the sharded twins, degraded local serving, the oplog-mirrored
flush) waits for the control plane (ROADMAP A14).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import widen

_DEFAULT_BUCKETS = (256, 1024, 4096, 16384)

# one increment per scoring-program execution, by path label (host:
# margins, leaf_host: leaf walks)
_DISP_LOCK = threading.Lock()
_DISPATCHES: Dict[str, int] = {}


def note_dispatch(path: str, n: int = 1) -> None:
    with _DISP_LOCK:
        _DISPATCHES[path] = _DISPATCHES.get(path, 0) + int(n)


def dispatch_counters() -> Dict[str, int]:
    with _DISP_LOCK:
        return dict(_DISPATCHES)


def reset_dispatch_counters() -> None:
    with _DISP_LOCK:
        _DISPATCHES.clear()


def _env_buckets() -> Tuple[int, ...]:
    raw = os.environ.get("H2O_TPU_SCORE_BUCKETS", "")
    if not raw.strip():
        return _DEFAULT_BUCKETS
    try:
        vals = sorted({int(v) for v in raw.replace(";", ",").split(",")
                       if v.strip()})
    except ValueError:
        return _DEFAULT_BUCKETS
    return tuple(v for v in vals if v > 0) or _DEFAULT_BUCKETS


def _window_s() -> float:
    try:
        ms = float(os.environ.get("H2O_TPU_SCORE_BATCH_WINDOW_MS", "2"))
    except ValueError:
        ms = 2.0
    return max(ms, 0.0) / 1000.0


def enabled() -> bool:
    return os.environ.get("H2O_TPU_SCORE_FAST", "1").lower() not in (
        "0", "false", "off")


def supports(model) -> bool:
    """True when `model` can ride the session path: a SharedTree forest
    whose raw prediction is pure margin post-processing (subclasses that
    override _predict_raw, IsolationForest's mean lengths, stay on the
    generic path)."""
    if not enabled():
        return False
    from h2o3_tpu_torch.models.tree.shared_tree import SharedTreeModel

    return (isinstance(model, SharedTreeModel)
            and model.forest is not None and model.spec is not None
            and type(model)._predict_raw is SharedTreeModel._predict_raw)


class SessionStats:
    """Per-model serving counters behind a small lock; p50/p99 over a
    bounded latency ring, computed when read."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.rows = 0
        self.dispatches = 0          # program executions (all paths)
        self.max_batch_requests = 0
        self._lat_ms: collections.deque = collections.deque(maxlen=512)

    def record_batch(self, n_requests: int, n_rows: int, ms: float,
                     dispatches: int = 0) -> None:
        with self._lock:
            self.requests += n_requests
            self.batches += 1
            self.rows += n_rows
            self.dispatches += int(dispatches)
            self.max_batch_requests = max(self.max_batch_requests, n_requests)
            self._lat_ms.append(float(ms))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            lat = np.asarray(self._lat_ms, np.float64)
            out = {"requests": self.requests, "batches": self.batches,
                   "rows": self.rows, "dispatches": self.dispatches,
                   "max_batch_requests": self.max_batch_requests}
            if self.batches:
                out["dispatches_per_flush"] = round(
                    self.dispatches / self.batches, 3)
        if lat.size:
            out["p50_ms"] = round(float(np.percentile(lat, 50)), 3)
            out["p99_ms"] = round(float(np.percentile(lat, 99)), 3)
        return out


class BucketProgram:
    """One row bucket of one program: a static (bucket, F) input of
    `dtype` (float32, or bfloat16 for rows staged from bf16 frames) on
    the device and, on the card, the CUDA graph of `fn` over it.

    `run(rows)` copies the (m, F) rows into the static input (rows past
    m zeroed) and returns `fn`'s first m output rows as a tensor nobody
    else writes. The first call runs `fn` eagerly and reports the rise
    of the allocator's peak to `on_first(bytes)` (None on the CPU); on
    the card it then captures `fn` and later calls replay the graph.
    Callers serialize `run` (ScoringSession holds its lock)."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor],
                 bucket: int, F: int, device,
                 on_first: Callable[[Optional[int]], None],
                 on_capture: Callable[[float], None],
                 dtype: torch.dtype = torch.float32):
        self.fn = fn
        self.bucket = int(bucket)
        self.device = torch.device(device)
        self.x = torch.zeros((self.bucket, F), dtype=dtype,
                             device=self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.ran = False
        self._on_first = on_first
        self._on_capture = on_capture

    def _load(self, rows: torch.Tensor) -> None:
        m = rows.shape[0]
        self.x[:m].copy_(rows)
        if m < self.bucket:
            self.x[m:].zero_()

    def run(self, rows: torch.Tensor) -> torch.Tensor:
        m = rows.shape[0]
        self._load(rows)
        if self.graph is not None:
            self.graph.replay()
            # the next replay rewrites self.out: hand out a copy
            return self.out[:m].clone()
        if self.ran:                      # the CPU: eager every time
            return self.fn(self.x)[:m]
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
            base = torch.cuda.memory_allocated(self.device)
        # an OutOfMemoryError here leaves the program unrun, for the
        # memory ladder to retry in a smaller bucket
        out = self.fn(self.x)
        if cuda:
            self._on_first(torch.cuda.max_memory_allocated(self.device)
                           - base)
            self._capture()
        else:
            self._on_first(None)
        self.ran = True
        return out[:m]

    def _capture(self) -> None:
        from h2o3_tpu_torch.core.runtime import CAPTURE_LOCK

        t0 = time.perf_counter()
        g = torch.cuda.CUDAGraph()
        with CAPTURE_LOCK:
            with torch.cuda.graph(g, capture_error_mode="thread_local"):
                out = self.fn(self.x)
        self.graph, self.out = g, out
        self._on_capture((time.perf_counter() - t0) * 1000.0)


class ScoringSession:
    """Device-resident scorer for one trained forest. Every margin it
    returns is bitwise equal to ``model._margin`` on the same rows (the
    same compressed.score_core over the same resident arrays; a graph
    replays the same kernels)."""

    def __init__(self, model):
        from h2o3_tpu_torch.core.runtime import cluster
        from h2o3_tpu_torch.models.tree.compressed import ResidentForest

        self.model = model
        self.forest = model.forest
        self.spec = model.spec
        self.device = cluster().device
        self._res = ResidentForest(self.forest, self.spec, self.device)
        self.buckets = tuple(sorted(set(_env_buckets())))
        self._programs: Dict[Tuple[str, int, torch.dtype],
                             BucketProgram] = {}
        self._lock = threading.Lock()     # static inputs, graphs, replays
        self._traced: set = set()         # score buckets activated so far
        self.fused_compiles = 0           # CUDA-graph captures
        self.stats = SessionStats()

    # -- feature packing ---------------------------------------------------
    def _features(self, adapted) -> torch.Tensor:
        """(n, F) features of an adapted frame on the session's device, in
        training-column order (numerics as-is, NaN = NA; categoricals as
        their codes, NA negative). Rows of a bf16 frame stage in
        bfloat16, half the bytes, when every other feature column is an
        enum whose codes bfloat16 holds exactly (at most 256 levels);
        else in float32. The programs widen them exactly, so both score
        alike, and each dtype has programs of its own."""
        cols = [adapted.col(n) for n in self.spec.names]
        half = [c.data.dtype == torch.bfloat16 for c in cols]
        if any(half) and all(h or (c.is_categorical and c.cardinality <= 256)
                             for h, c in zip(half, cols)):
            return torch.stack([c.data.to(torch.bfloat16) for c in cols],
                               dim=1).to(self.device)
        return self.model._features(adapted).to(self.device)

    def _bucket_for(self, m: int) -> int:
        for b in self.buckets:
            if b >= m:
                return b
        return self.buckets[-1]

    def _window_snap(self, w: int) -> int:
        """Snap a planned window down onto the bucket ladder, so chunk
        streaming reuses the buckets' programs (below the smallest bucket
        the window stays and pads up into it)."""
        for b in reversed(self.buckets):
            if b <= w:
                return b
        return max(w, 1)

    def _out_k(self) -> int:
        return self._res.K

    def _row_bytes_hint(self, itemsize: int = 4) -> float:
        """Static working-set bytes/row of one dispatch: the features in
        and out of packing (`itemsize` bytes a value) plus the float32
        margin lanes; the planner takes the larger of this and the
        measured estimate."""
        F = max(len(self.spec.names), 1)
        return 2.0 * itemsize * F + 4.0 * (self._out_k() + 2)

    # -- bucketed dispatch -------------------------------------------------
    def _program(self, kind: str, bucket: int,
                 dtype: torch.dtype = torch.float32) -> BucketProgram:
        from h2o3_tpu_torch.obs import compiles

        key = (kind, bucket, dtype)
        family = "scoring" if kind == "score" else "explain"
        prog = self._programs.get(key)
        if prog is not None:
            compiles.record_hit(family)
        else:
            from h2o3_tpu_torch.memory import budget

            res = self._res.margins if kind == "score" else self._res.leaves

            def fn(x):
                return res(widen(x))

            def on_capture(ms: float) -> None:
                self.fused_compiles += 1
                compiles.record_compile(
                    family, (str(self.model.key), kind, bucket, str(dtype)),
                    ms, program=f"{kind}_b{bucket}")

            prog = BucketProgram(
                fn, bucket, self.spec.F, self.device,
                on_first=lambda nbytes: budget.note_compiled(
                    budget.family_key(family, dtype), bucket, nbytes),
                on_capture=on_capture, dtype=dtype)
            self._programs[key] = prog
            if kind == "score":
                self._traced.add(bucket)
        return prog

    def _dispatch(self, kind: str, rows: torch.Tensor) -> torch.Tensor:
        with self._lock:
            return self._program(kind, self._bucket_for(rows.shape[0]),
                                 rows.dtype).run(rows)

    def _windows(self, family: str, kind: str, X, path: str,
                 row_bytes: float,
                 dispatched: Optional[list] = None) -> List[torch.Tensor]:
        """Run one program over X's rows in planned bucket windows; X is
        an (n, F) host array (staged double-buffered) or a tensor."""
        from h2o3_tpu_torch.memory import stream

        from h2o3_tpu_torch.memory import budget

        n = X.shape[0]
        maxb = self.buckets[-1]
        if isinstance(X, np.ndarray):
            rows_of = stream.HostStager(X, self.device, maxb).stage
            dtype = torch.float32
        else:
            if X.dtype != torch.bfloat16:
                X = X.to(torch.float32)
            X = X.to(self.device)
            dtype = X.dtype

            def rows_of(pos, m):
                return X[pos: pos + m]

        from h2o3_tpu_torch.obs import tracing

        def dispatch(pos: int, m: int):
            with tracing.span("dispatch", bucket=self._bucket_for(m),
                              rows=m, path=path):
                out = self._dispatch(kind, rows_of(pos, m))
            note_dispatch(path)
            if dispatched is not None:
                dispatched.append(self._bucket_for(m))
            return out

        return stream.run_windows(budget.family_key(family, dtype), n,
                                  dispatch, maxb, row_bytes=row_bytes,
                                  window_sizer=self._window_snap)

    def _margin_x(self, X, dispatched: Optional[list] = None
                  ) -> torch.Tensor:
        """Margins of an (n, F) feature matrix (host array or tensor)
        through bucketed dispatch: an (n,) or (n, K) float32 tensor on
        the session's device, exact per row. Rows beyond the largest
        bucket are chunked at it, so the session never holds more than
        len(buckets) score programs. `dispatched` receives one bucket
        per dispatch."""
        outs = self._windows("scoring", "score", X, "host",
                             self._row_bytes_hint(
                                 2 if getattr(X, "dtype", None)
                                 == torch.bfloat16 else 4), dispatched)
        if not outs:
            K = self._out_k()
            return torch.zeros((0,) if K == 1 else (0, K),
                               dtype=torch.float32, device=self.device)
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    # -- fused explainability (leaf walks) ---------------------------------
    def leaf_matrix(self, adapted, n: int) -> np.ndarray:
        """(n, T) int64 leaf node ids through the bucketed bin + leaf
        programs, bitwise equal to ``spec.bin_columns(adapted)`` +
        ``forest.leaf_index(binned)``."""
        T = self.forest.n_trees
        if n <= 0:
            return np.zeros((0, T), np.int64)
        row_bytes = 4.0 * (2 * max(len(self.spec.names), 1)) + 8.0 * T
        outs = self._windows("explain", "leaf", self._features(adapted)[:n],
                             "leaf_host", row_bytes)
        cat = outs[0] if len(outs) == 1 else torch.cat(outs)
        return cat.cpu().numpy()

    @property
    def traversal_compiles(self) -> int:
        return len(self._traced)

    # -- request-level API -------------------------------------------------
    def predict_batch(self, entries: List[Tuple[Any, Optional[str], bool]],
                      ctxs: Optional[List[Optional[dict]]] = None):
        """Score a coalesced batch: entries = [(frame, dest_key,
        with_metrics)]. Returns [(prediction_frame, metrics_or_None)] in
        entry order; each prediction frame is installed in the DKV under
        dest_key (or a fresh key). `ctxs`, one trace context an entry,
        puts each entry's ``finish`` span (its prediction frame and
        metrics) in that entry's own trace. A frame fed by a pending lazy Rapids
        feature pipeline is captured first, before adapt_test touches a
        column (a lazy column's data access would flush the DAG), and
        scores munge and walk in one program per bucket (pipeline.py).
        The other entries' feature rows are concatenated on the device
        and dispatched once per bucket chunk of the concatenation; each
        entry's margins are its exact slice."""
        from h2o3_tpu_torch import pipeline
        from h2o3_tpu_torch.obs import metrics as obs_metrics
        from h2o3_tpu_torch.obs import tracing
        from h2o3_tpu_torch.utils import timeline

        t0 = time.perf_counter()
        items, piped = [], []
        for i, (frame, dest, with_metrics) in enumerate(entries):
            cap = pipeline.try_capture(self, frame)
            if cap is not None:
                piped.append((i, frame, dest, with_metrics, cap))
                continue
            items.append((i, frame, self.model.adapt_test(frame),
                          frame.nrows, dest, with_metrics))
        results: List[Any] = [None] * len(entries)
        n_disp, n_rows = 0, 0
        if items:
            with tracing.span("pack", rows=sum(it[3] for it in items),
                              path="coalesce"):
                parts = [self._features(a)[:n]
                         for _i, _f, a, n, _d, _w in items]
                X = parts[0] if len(parts) == 1 else torch.cat(parts)
            disp: list = []
            margins = self._margin_x(X, dispatched=disp)
            n_disp += len(disp)
            n_rows += int(X.shape[0])
            off = 0
            with tracing.span("fetch", rows=int(X.shape[0]), path="host"):
                for i, frame, _a, n, dest, with_metrics in items:
                    results[i] = self._finish(frame, margins[off: off + n],
                                              n, dest, with_metrics,
                                              ctxs[i] if ctxs else None)
                    off += n
        for i, frame, dest, with_metrics, cap in piped:
            margins, nd = pipeline.execute_margins(self, cap)
            n_disp += nd
            n_rows += cap.nrows
            with tracing.span("fetch", rows=cap.nrows, path="pipeline"):
                results[i] = self._finish(frame, margins, cap.nrows, dest,
                                          with_metrics,
                                          ctxs[i] if ctxs else None)
        ms = (time.perf_counter() - t0) * 1000
        self.stats.record_batch(len(entries), n_rows, ms,
                                dispatches=n_disp)
        obs_metrics.observe("h2o3_score_flush_requests",
                            float(len(entries)))
        timeline.record("scoring", str(self.model.key), ms=ms,
                        requests=len(entries), rows=n_rows,
                        dispatches=n_disp,
                        compiles=self.traversal_compiles)
        return results

    def _finish(self, frame, margins, n: int, dest, with_metrics,
                ctx: Optional[dict] = None):
        """Margins -> (installed prediction frame, metrics or None), in
        ``finish`` and ``metrics`` spans under `ctx` (else under the
        active span)."""
        from h2o3_tpu_torch.core.dkv import Key
        from h2o3_tpu_torch.core.runtime import full_float32
        from h2o3_tpu_torch.obs import tracing

        mm = None
        with tracing.activate(ctx), full_float32():
            with tracing.span("finish", rows=n):
                raw = self.model._margin_to_raw(margins)
                pred = self.model._raw_to_frame(raw, n)
                if dest:
                    pred._key = Key(dest)
                pred.install()
            if with_metrics:
                with tracing.span("metrics", rows=n):
                    mm = self.model._make_metrics(frame, raw)
        return pred, mm

    def predict(self, frame, key: Optional[str] = None):
        """Single-request convenience (no micro-batching)."""
        return self.predict_batch([(frame, key, False)])[0][0]


# ---------------------------------------------------------------------------
# session registry (bounded; a retrain under the same key gets a fresh
# session because the CompressedForest identity changes)
# ---------------------------------------------------------------------------

_REG_LOCK = threading.Lock()
_REGISTRY: "collections.OrderedDict[tuple, ScoringSession]" = \
    collections.OrderedDict()
_REGISTRY_CAP = 16


def session_for(model) -> ScoringSession:
    key = (str(model.key), id(model.forest))
    with _REG_LOCK:
        sess = _REGISTRY.get(key)
        if sess is not None:
            _REGISTRY.move_to_end(key)
            return sess
    sess = ScoringSession(model)
    with _REG_LOCK:
        cur = _REGISTRY.setdefault(key, sess)
        _REGISTRY.move_to_end(key)
        while len(_REGISTRY) > _REGISTRY_CAP:
            _REGISTRY.popitem(last=False)
        return cur


def purge(model_key: Optional[str] = None) -> None:
    """Drop the sessions of a deleted model (all sessions when key is
    None)."""
    with _REG_LOCK:
        if model_key is None:
            _REGISTRY.clear()
            return
        for k in [k for k in _REGISTRY if k[0] == str(model_key)]:
            del _REGISTRY[k]


def metrics_snapshot() -> List[Dict[str, Any]]:
    with _REG_LOCK:
        items = [(k[0], s) for k, s in _REGISTRY.items()]
    out = []
    for mk, sess in items:
        entry = {"model": mk, "buckets": list(sess.buckets),
                 "traversal_compiles": sess.traversal_compiles,
                 "fused_compiles": sess.fused_compiles}
        entry.update(sess.stats.snapshot())
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# micro-batcher
# ---------------------------------------------------------------------------

class _Pending:
    __slots__ = ("frame", "dest", "with_metrics", "event", "pred", "mm",
                 "error", "promoted", "trace_ctx", "enq_ms")

    def __init__(self, frame, dest, with_metrics):
        from h2o3_tpu_torch.obs import tracing

        self.trace_ctx = tracing.context()
        self.enq_ms = time.time() * 1000.0
        self.frame = frame
        self.dest = dest
        self.with_metrics = with_metrics
        self.event = threading.Event()
        self.pred = None
        self.mm = None
        self.error: Optional[BaseException] = None
        self.promoted = False      # woken to take over flush leadership


def execute_batch(model, entries: List[Tuple[Any, Optional[str], bool]],
                  ctxs: Optional[List[Optional[dict]]] = None):
    """Run one coalesced batch through the model's session."""
    return session_for(model).predict_batch(entries, ctxs)


class ScoreBatcher:
    """Coalesces concurrent scoring requests per model key.

    The first request for a model becomes the flush leader: it sleeps
    the batch window, drains everything queued for that model and scores
    it as one batch. The other requests block on their entry's event and
    get their exact slice back. Per-model queues keep requests against
    different models independent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._queues: Dict[str, List[_Pending]] = {}
        self._leaders: set = set()

    def submit(self, model, frame, dest: Optional[str] = None,
               with_metrics: bool = False, timeout_s: float = 600.0):
        mk = str(model.key)
        ent = _Pending(frame, dest, with_metrics)
        with self._lock:
            self._queues.setdefault(mk, []).append(ent)
            lead = mk not in self._leaders
            if lead:
                self._leaders.add(mk)
        if lead:
            self._lead(model, mk)
        else:
            if not ent.event.wait(timeout=timeout_s):
                # withdraw before erroring: a still-queued entry must not
                # be scored later (its client already got the failure)
                with self._lock:
                    q = self._queues.get(mk)
                    if q and ent in q:
                        q.remove(ent)
                        if ent.promoted:
                            # leadership reached us as we gave up: pass
                            # it on, so the queue does not stall
                            if q:
                                q[0].promoted = True
                                q[0].event.set()
                            else:
                                self._queues.pop(mk, None)
                                self._leaders.discard(mk)
                        raise TimeoutError(
                            f"scoring batch for model {mk!r} did not "
                            f"flush within {timeout_s}s")
                if not ent.event.wait(timeout=60.0):
                    raise TimeoutError(
                        f"scoring dispatch for model {mk!r} wedged "
                        f"mid-batch")
            if ent.promoted and not (ent.pred or ent.error):
                # the previous leader handed leadership over with us still
                # queued: our flush (our own entry included) runs here
                self._lead(model, mk)
        if ent.error is not None:
            raise ent.error
        return ent.pred, ent.mm

    def _lead(self, model, mk: str) -> None:
        """Flush one batch (window sleep, drain, dispatch), then release
        leadership or hand it to the first still-queued waiter."""
        try:
            w = _window_s()
            if w > 0:
                time.sleep(w)
            with self._lock:
                batch = self._queues.get(mk) or []
                self._queues[mk] = []
            if batch:
                self._flush(model, batch)
            with self._lock:
                rest = self._queues.get(mk)
                if rest:
                    rest[0].promoted = True
                    rest[0].event.set()
                    return
                self._queues.pop(mk, None)
                self._leaders.discard(mk)
        except BaseException as ex:   # noqa: BLE001 — never strand waiters
            with self._lock:
                stranded = self._queues.pop(mk, [])
                self._leaders.discard(mk)
            for e in stranded:
                if e.error is None and not e.event.is_set():
                    e.error = ex
                    e.event.set()
            raise

    @staticmethod
    def _flush(model, batch: List[_Pending]) -> None:
        from h2o3_tpu_torch.obs import tracing

        # queue_wait: submit -> flush start, one span in each request's
        # own trace; the batch's shared phases then run under the oldest
        # request's trace, each request's finish (its prediction frame
        # and metrics) under its own, and every other request's trace
        # gets one "batch" span over the whole flush
        now_ms = time.time() * 1000.0
        for e in batch:
            tracing.record_span("queue_wait", e.trace_ctx, e.enq_ms, now_ms,
                                batched_with=len(batch) - 1)
        lead_ctx = next((e.trace_ctx for e in batch if e.trace_ctx), None)
        try:
            with tracing.activate(lead_ctx):
                results = execute_batch(
                    model, [(e.frame, e.dest, e.with_metrics)
                            for e in batch], [e.trace_ctx for e in batch])
            for e, (pred, mm) in zip(batch, results):
                e.pred, e.mm = pred, mm
        except BaseException as ex:   # noqa: BLE001 — propagate per request
            for e in batch:
                e.error = ex
        finally:
            end_ms = time.time() * 1000.0
            for e in batch:
                if e.trace_ctx is not lead_ctx:
                    tracing.record_span(
                        "batch", e.trace_ctx, now_ms, end_ms,
                        requests=len(batch),
                        lead_trace=(lead_ctx or {}).get("trace_id"))
                e.event.set()


BATCHER = ScoreBatcher()


def score_request(model, frame, dest: Optional[str] = None,
                  with_metrics: bool = False):
    """Admission-controlled, coalescing, bucketed scoring of one request:
    (prediction_frame, metrics_or_None). Over the per-model concurrency
    limit requests queue (bounded); overflow raises AdmissionRejected
    (429/503 + Retry-After). Every served request's latency feeds the
    model's admission ring, from which the SLO-adaptive controller
    (``H2O_TPU_SCORE_SLO_MS``) derives its inflight limit."""
    from h2o3_tpu_torch import admission
    from h2o3_tpu_torch.obs import metrics as obs_metrics
    from h2o3_tpu_torch.obs import tracing

    mk = str(model.key)
    t0 = time.perf_counter()
    with tracing.span("score", model=mk), admission.CONTROLLER.slot(mk):
        t1 = time.perf_counter()
        out = BATCHER.submit(model, frame, dest, with_metrics)
        admission.CONTROLLER.note_latency(
            mk, (time.perf_counter() - t1) * 1000.0)
    obs_metrics.observe("h2o3_score_request_seconds",
                        time.perf_counter() - t0, model=mk)
    return out
