"""Trace spans and trace ids (counterpart of h2o3_tpu/obs/tracing.py).

A trace id is minted at REST ingress (api/server.py wraps every traced
handler in a root span) and handed back in the ``X-H2O3-Trace-Id``
header; ``GET /3/Trace/{id}`` returns the span tree. Child spans come
from the scoring path (queue wait, admission, dispatch), the Rapids
statement (parse, plan, execute, fused dispatch), the chunked ingest and
the trainers. None adds a device synchronization: a span's timing is
host wall clock around calls the path already makes.

Cost model: ``span()`` is a no-op unless the calling thread has an
active trace, so library-mode calls pay one thread-local read. The
store is bounded (``H2O_TPU_OBS_TRACE_CAP`` traces x ``_SPAN_CAP``
spans, oldest trace evicted). On a cloud of several processes a
follower records its replay and ack spans of an op under the trace the
op carries and publishes them to the cloud KV (``obs/span/{trace}/``,
the newest ``_KV_KEEP`` kept), so the coordinator's ``/3/Trace/{id}``
shows publish -> replay -> ack as one tree.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

_SPAN_CAP = 512                 # spans kept per trace
_KV_PREFIX = "obs/span/"
_KV_KEEP = 512                  # published span keys kept in the KV

_TLS = threading.local()        # .stack: list of active span dicts
_LOCK = threading.Lock()
# trace_id -> list of finished span dicts (insertion-ordered eviction)
_STORE: "collections.OrderedDict[str, List[dict]]" = collections.OrderedDict()
# this process's published span keys, oldest first
_PUBLISHED: "collections.deque[str]" = collections.deque()


def trace_cap() -> int:
    try:
        return max(int(os.environ.get("H2O_TPU_OBS_TRACE_CAP", "256")), 1)
    except ValueError:
        return 256


def _now_ms() -> float:
    return time.time() * 1000.0


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def current() -> Optional[dict]:
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


def current_trace_id() -> Optional[str]:
    cur = current()
    return cur["trace_id"] if cur else None


def context() -> Optional[Dict[str, str]]:
    """The active span as a propagation context ({trace_id, span_id}) —
    what rides the oplog op record and the micro-batcher's entries."""
    cur = current()
    if cur is None:
        return None
    return {"trace_id": cur["trace_id"], "span_id": cur["span_id"]}


def _proc_index() -> int:
    from h2o3_tpu_torch.parallel import distributed as D

    return D.process_index()


def _store(span: dict) -> None:
    """Bounded-store insert (oldest trace evicted) + the span counter —
    the single copy both the context-manager finish path and the
    explicitly-timed record_span path go through."""
    tid = span["trace_id"]
    with _LOCK:
        spans = _STORE.get(tid)
        if spans is None:
            spans = _STORE[tid] = []
            while len(_STORE) > trace_cap():
                _STORE.popitem(last=False)
        if len(spans) < _SPAN_CAP:
            spans.append(span)
    from h2o3_tpu_torch.obs import metrics

    metrics.inc("h2o3_trace_spans_total")


def _kv_publish(span: dict) -> None:
    """Ship a finished span to the cloud KV for the coordinator's
    ``/3/Trace/{id}``; the oldest published keys past `_KV_KEEP` are
    deleted. Best effort: tracing never fails the op it observes."""
    from h2o3_tpu_torch.parallel import distributed as D

    key = f"{_KV_PREFIX}{span['trace_id']}/{span['proc']}_{span['span_id']}"
    if not D.kv_put(key, json.dumps(span)):
        return
    expired = []
    with _LOCK:
        _PUBLISHED.append(key)
        while len(_PUBLISHED) > _KV_KEEP:
            expired.append(_PUBLISHED.popleft())
    for old in expired:         # store round trips outside the lock
        D.kv_delete(old)


def _finish(span: dict) -> None:
    span["end_ms"] = round(_now_ms(), 3)
    span["ms"] = round(span["end_ms"] - span["start_ms"], 3)
    _store(span)


def _new_span(name: str, trace_id: str, parent_id: Optional[str],
              attrs: Dict[str, Any]) -> dict:
    return {"trace_id": trace_id, "span_id": uuid.uuid4().hex[:12],
            "parent_id": parent_id, "name": name,
            "proc": _proc_index(), "start_ms": round(_now_ms(), 3),
            "status": "ok",
            "attrs": {k: v for k, v in attrs.items() if v is not None}}


class _SpanCtx:
    """Context manager over one span; ``None``-like when tracing is
    inactive (``bool(span_cm)`` is False and ``ctx()`` returns None)."""

    __slots__ = ("span",)

    def __init__(self, span: Optional[dict]):
        self.span = span

    def __bool__(self):
        return self.span is not None

    def ctx(self) -> Optional[Dict[str, str]]:
        if self.span is None:
            return None
        return {"trace_id": self.span["trace_id"],
                "span_id": self.span["span_id"]}

    def set(self, **attrs) -> None:
        if self.span is not None:
            self.span["attrs"].update(attrs)

    def __enter__(self):
        if self.span is not None:
            _stack().append(self.span)
        return self

    def __exit__(self, et, ev, tb):
        if self.span is None:
            return False
        st = _stack()
        if st and st[-1] is self.span:
            st.pop()
        if et is not None:
            self.span["status"] = "error"
            self.span["attrs"]["error"] = f"{et.__name__}: {ev}"[:500]
        _finish(self.span)
        return False


def root_span(name: str, **attrs) -> _SpanCtx:
    """Mint a new trace (REST ingress). Always records."""
    return _SpanCtx(_new_span(name, uuid.uuid4().hex[:16], None, attrs))


def span(name: str, **attrs) -> _SpanCtx:
    """Child of the calling thread's active span; inert no-op when no
    trace is active (the library-mode fast path pays one TLS read)."""
    cur = current()
    if cur is None:
        return _SpanCtx(None)
    return _SpanCtx(_new_span(name, cur["trace_id"], cur["span_id"], attrs))


class activate:
    """Adopt a propagation context on THIS thread (the micro-batcher's
    flush leader runs on a different thread than the submitting request):
    nested ``span()`` calls attach under `ctx`. No-op for a None ctx."""

    def __init__(self, ctx: Optional[Dict[str, str]]):
        self._ok = isinstance(ctx, dict) and bool(ctx.get("trace_id"))
        self._frame = ({"trace_id": str(ctx["trace_id"]),
                        "span_id": ctx.get("span_id")} if self._ok else None)

    def __enter__(self):
        if self._ok:
            _stack().append(self._frame)
        return self

    def __exit__(self, et, ev, tb):
        if self._ok:
            st = _stack()
            if st and st[-1] is self._frame:
                st.pop()
        return False


def record_span(name: str, ctx: Optional[Dict[str, str]], start_ms: float,
                end_ms: Optional[float] = None, publish: bool = False,
                status: str = "ok", **attrs) -> Optional[dict]:
    """Append an already-timed span (explicit wall-clock ms timestamps)
    under `ctx`, returning it: the flush leader records the queue-wait
    and batch spans this way on behalf of each waiting request's trace,
    and a follower its replay and ack spans, after the ack, with
    `publish` so they reach the trace's home process."""
    if not isinstance(ctx, dict) or not ctx.get("trace_id"):
        return None
    sp = _new_span(name, str(ctx["trace_id"]), ctx.get("span_id"), attrs)
    sp["status"] = status
    sp["start_ms"] = round(float(start_ms), 3)
    sp["end_ms"] = round(float(end_ms if end_ms is not None
                               else _now_ms()), 3)
    sp["ms"] = round(sp["end_ms"] - sp["start_ms"], 3)
    _store(sp)
    if publish:
        _kv_publish(sp)
    return sp


def get_trace(trace_id: str, include_remote: bool = True) -> List[dict]:
    """Every finished span recorded for `trace_id`: this process's, and
    on a cloud the spans followers published, start-ordered."""
    with _LOCK:
        spans = list(_STORE.get(trace_id, ()))
    if include_remote:
        from h2o3_tpu_torch.parallel import distributed as D

        seen = {s["span_id"] for s in spans}
        for _k, v in D.kv_dir(f"{_KV_PREFIX}{trace_id}/"):
            try:
                sp = json.loads(v)
            except (ValueError, TypeError):
                continue
            if isinstance(sp, dict) and sp.get("span_id") not in seen:
                spans.append(sp)
    return sorted(spans, key=lambda s: s.get("start_ms", 0.0))


def span_tree(spans: List[dict]) -> List[dict]:
    """Nest spans by parent_id: [{**span, children: [...]}] roots. Spans
    whose parent never finished (open at dump time) surface as roots."""
    nodes = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots = []
    for s in spans:
        node = nodes[s["span_id"]]
        parent = nodes.get(s.get("parent_id"))
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots


def recent_traces(n: int = 50) -> List[dict]:
    """Newest trace ids with their root span names (for GET /3/Trace)."""
    with _LOCK:
        items = list(_STORE.items())[-n:]
    out = []
    for tid, spans in reversed(items):
        root = next((s for s in spans if not s.get("parent_id")), None)
        out.append({"trace_id": tid, "spans": len(spans),
                    "root": (root or {}).get("name"),
                    "start_ms": min((s.get("start_ms", 0.0) for s in spans),
                                    default=0.0)})
    return out


def open_spans() -> List[dict]:
    """The calling thread's active (unfinished) spans — flight-recorder
    fodder. Cross-thread open spans are not visible by design (no global
    registry of live stacks; the store holds everything finished)."""
    return [dict(s) for s in getattr(_TLS, "stack", [])]


def clear() -> None:
    """Drop the span store (tests)."""
    with _LOCK:
        _STORE.clear()
