"""Admission control for the serving tier: queue, don't collapse
(counterpart of h2o3_tpu/admission.py, whole).

Two gating modes, combinable:

- **Static** (``H2O_TPU_SCORE_MAX_INFLIGHT``): per model key, at most N
  requests run the scoring path at once.
- **SLO-adaptive** (``H2O_TPU_SCORE_SLO_MS``): the per-model inflight
  limit is derived from the observed service-latency ring against the
  target p99, AIMD: p99 over target shrinks the limit (x0.7, floor 1),
  p99 comfortably under target with demand pressure grows it (+1, capped
  at ``H2O_TPU_SCORE_SLO_MAX_INFLIGHT``, or at the static knob when both
  are set). A queue-time gate sheds requests whose estimated drain time
  (backlog x observed mean latency / parallelism) would already blow
  the SLO, with a drain-rate-derived Retry-After.

The next ``H2O_TPU_SCORE_QUEUE_CAP`` requests wait in a bounded FIFO;
anything beyond is rejected at once with :class:`AdmissionRejected`
(HTTP 429 + Retry-After). A queued request that cannot start within
``H2O_TPU_SCORE_QUEUE_TIMEOUT_S`` fails with 503 + Retry-After. While
the memory ladder's pressure flag is up (``memory/budget``) every
request is shed with 503. Both knobs at 0 (the default) disable the
gate. A request's wait in the queue is the ``admission_wait`` span of
its trace.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np

from h2o3_tpu_torch.utils import retry

# adapt the derived limit every this many recorded latencies (count-based,
# so tests are deterministic)
_ADAPT_EVERY = 16
# AIMD shape: breach → ×_MD (floor 1); comfortably under target under
# demand pressure → +1
_MD = 0.7
_HEADROOM = 0.6


def max_inflight() -> int:
    """Per-model concurrent fused-path requests (env
    ``H2O_TPU_SCORE_MAX_INFLIGHT``; 0 = no static cap)."""
    return max(retry.env_int("H2O_TPU_SCORE_MAX_INFLIGHT", 0), 0)


def slo_ms() -> float:
    """Target p99 service latency in milliseconds (env
    ``H2O_TPU_SCORE_SLO_MS``; 0 = SLO-adaptive admission off)."""
    try:
        return max(float(os.environ.get("H2O_TPU_SCORE_SLO_MS", "0")), 0.0)
    except ValueError:
        return 0.0


def slo_max_inflight() -> int:
    """Ceiling for the SLO-derived per-model inflight limit (env
    ``H2O_TPU_SCORE_SLO_MAX_INFLIGHT``, default 64)."""
    return max(retry.env_int("H2O_TPU_SCORE_SLO_MAX_INFLIGHT", 64), 1)


def queue_cap() -> int:
    """Bounded queue depth per model once the inflight limit is reached
    (env ``H2O_TPU_SCORE_QUEUE_CAP``, default 64)."""
    return max(retry.env_int("H2O_TPU_SCORE_QUEUE_CAP", 64), 0)


def queue_timeout_s() -> float:
    """Max seconds a queued request waits for a slot before failing with
    503 (env ``H2O_TPU_SCORE_QUEUE_TIMEOUT_S``, default 30)."""
    try:
        return max(float(os.environ.get("H2O_TPU_SCORE_QUEUE_TIMEOUT_S",
                                        "30")), 0.1)
    except ValueError:
        return 30.0


class AdmissionRejected(Exception):
    """Request refused/expired by admission control; carries the HTTP
    status (429 overflow/SLO shed / 503 queue timeout) and a Retry-After
    hint."""

    def __init__(self, msg: str, status: int = 429,
                 retry_after_s: float = 1.0):
        super().__init__(msg)
        self.status = int(status)
        self.retry_after_s = max(float(retry_after_s), 0.1)


class _ModelGate:
    __slots__ = ("cond", "inflight", "queue", "lat_ms", "limit", "notes")

    def __init__(self):
        self.cond = threading.Condition()
        self.inflight = 0
        self.queue: collections.deque = collections.deque()   # ticket FIFO
        # observed per-request service latencies (ms), the SLO signal
        self.lat_ms: collections.deque = collections.deque(maxlen=256)
        self.limit: Optional[int] = None     # SLO-derived; lazily seeded
        self.notes = 0


class AdmissionController:
    """Per-model-key gates plus aggregate counters for /3/ScoringMetrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._gates: Dict[str, _ModelGate] = {}
        self.admitted = 0
        self.queued = 0
        self.rejected = 0
        self.timed_out = 0
        self.shed_slo = 0            # 429s from the SLO queue-time gate
        self.shed_mem = 0            # 503s from device memory pressure

    def _shed_if_mem_pressure(self, model_key: str) -> None:
        """Memory-pressure gate: an exhausted OOM degradation ladder
        (h2o3_tpu_torch/memory) flags pressure for a cooldown window; a request
        admitted during it would dispatch straight into the same
        exhausted device, so it is shed like an SLO breach — 503 +
        Retry-After sized to the cooldown remainder. Runs BEFORE the
        admission-disabled early return: pressure shedding guards the
        device even when inflight gating is off."""
        from h2o3_tpu_torch.memory import budget as membudget

        if not membudget.pressure_active():
            return
        with self._lock:
            self.rejected += 1
            self.shed_mem += 1
        raise AdmissionRejected(
            f"model {model_key!r}: device memory pressure — the OOM "
            f"degradation ladder exhausted its retry budget; shedding "
            f"until resident frames unload", status=503,
            retry_after_s=membudget.pressure_retry_after_s())

    def _gate(self, key: str) -> _ModelGate:
        with self._lock:
            g = self._gates.get(key)
            if g is None:
                g = self._gates[key] = _ModelGate()
            return g

    # -- SLO-adaptive limit ------------------------------------------------
    def _limit(self, g: _ModelGate) -> int:
        """Effective inflight limit for one gate RIGHT NOW: the static
        knob when SLO mode is off; otherwise the AIMD-derived limit,
        seeded from the static knob (or a conservative 8) and capped at
        the SLO ceiling (and at the static knob when both are set).
        Callers hold g.cond."""
        static = max_inflight()
        if slo_ms() <= 0:
            return static
        if g.limit is None:
            g.limit = static if static > 0 else min(8, slo_max_inflight())
        cap = min(static, slo_max_inflight()) if static > 0 \
            else slo_max_inflight()
        return max(1, min(g.limit, cap))

    def note_latency(self, model_key: str, ms: float) -> None:
        """Record one served request's service latency (queue wait
        excluded) and — every ``_ADAPT_EVERY`` samples in SLO mode —
        re-derive the gate's inflight limit from the ring's p99 against
        the target."""
        g = self._gate(str(model_key))
        with g.cond:
            g.lat_ms.append(float(ms))
            g.notes += 1
            target = slo_ms()
            if target <= 0 or g.notes % _ADAPT_EVERY:
                return
            cur = self._limit(g)
            lat = np.asarray(g.lat_ms, np.float64)
            p99 = float(np.percentile(lat, 99))
            if p99 > target:
                g.limit = max(1, int(cur * _MD))
            elif p99 < target * _HEADROOM and \
                    (g.queue or g.inflight >= cur):
                # additive increase only under demand pressure — an idle
                # model must not drift to the ceiling on easy traffic
                g.limit = min(cur + 1, slo_max_inflight())
            if g.limit != cur:
                g.cond.notify_all()

    def _mean_ms(self, g: _ModelGate) -> float:
        """Observed mean service latency (callers hold g.cond); 0.0 when
        the ring is empty."""
        return float(sum(g.lat_ms) / len(g.lat_ms)) if g.lat_ms else 0.0

    def _retry_after(self, g: _ModelGate, limit: int) -> float:
        """Retry-After derived from the observed per-model drain rate:
        the backlog ahead of a retrying client drains at roughly
        limit / mean_latency requests per second, so the hint is
        backlog × mean / limit — proportional to real saturation, not a
        constant. Falls back to the batch-window heuristic before any
        latency has been observed. Floored at 1s, capped at 120s; never a
        promise."""
        backlog = len(g.queue) + max(g.inflight, 1)
        mean = self._mean_ms(g)
        if mean > 0:
            return min(max(1.0, backlog * (mean / 1000.0)
                           / max(limit, 1)), 120.0)
        from h2o3_tpu_torch.scoring import _window_s

        return max(1.0, backlog * max(_window_s(), 0.002))

    def _est_wait_s(self, g: _ModelGate, limit: int) -> float:
        """Estimated queue drain time for a request joining now (callers
        hold g.cond): backlog ahead × observed mean service latency /
        parallelism. 0.0 before any latency sample exists (never shed
        blind)."""
        mean = self._mean_ms(g)
        if mean <= 0:
            return 0.0
        return (len(g.queue) + 1) * (mean / 1000.0) / max(limit, 1)

    def _maybe_shed(self, model_key: str, g: _ModelGate,
                    limit: int) -> None:
        """Shared 429 logic for slot() and check(): callers hold g.cond
        and have established inflight >= limit. Raises AdmissionRejected
        when a request arriving now must be shed (SLO queue-time gate or
        queue overflow); returns when it may queue."""
        target = slo_ms()
        est = self._est_wait_s(g, limit)
        if target > 0 and est * 1000.0 > target:
            # SLO queue-time gate: this request would already be out of
            # SLO before it reached a device — shed it NOW with a
            # drain-derived backoff instead of queueing it into certain
            # failure (queue collapse)
            with self._lock:
                self.rejected += 1
                self.shed_slo += 1
            raise AdmissionRejected(
                f"model {model_key!r}: estimated queue drain "
                f"{est * 1000.0:.0f}ms exceeds the "
                f"{target:.0f}ms latency SLO "
                f"({g.inflight} in flight, {len(g.queue)} queued, "
                f"limit {limit}) — retry later",
                status=429,
                retry_after_s=self._retry_after(g, limit))
        if len(g.queue) >= queue_cap():
            with self._lock:
                self.rejected += 1
            raise AdmissionRejected(
                f"model {model_key!r}: {g.inflight} requests in "
                f"flight and {len(g.queue)} queued (caps "
                f"{limit}/{queue_cap()}) — retry later",
                status=429,
                retry_after_s=self._retry_after(g, limit))

    def check(self, model_key: str) -> None:
        """Non-consuming admission probe: raise AdmissionRejected when a
        request arriving NOW would be shed. Async handlers (the /4 route)
        call this BEFORE detaching work into a background job so
        saturation surfaces as a synchronous 429 + Retry-After instead of
        a failed job with no backoff hint. No slot is reserved — the
        job's own slot() may still queue (or, on a race, shed) later."""
        self._shed_if_mem_pressure(str(model_key))
        if max_inflight() <= 0 and slo_ms() <= 0:
            return
        g = self._gate(str(model_key))
        with g.cond:
            limit = self._limit(g)
            if g.inflight >= limit:
                self._maybe_shed(str(model_key), g, limit)

    @contextmanager
    def slot(self, model_key: str):
        self._shed_if_mem_pressure(str(model_key))
        if max_inflight() <= 0 and slo_ms() <= 0:
            yield                      # admission disabled: zero overhead
            return
        g = self._gate(str(model_key))
        ticket = object()
        with g.cond:
            limit = self._limit(g)
            if g.inflight >= limit:
                self._maybe_shed(str(model_key), g, limit)
                g.queue.append(ticket)
                with self._lock:
                    self.queued += 1
                deadline = queue_timeout_s()
                t0 = time.monotonic()
                from h2o3_tpu_torch.obs import tracing

                # FIFO: only the queue head may take a freed slot. The
                # limit is re-read every wakeup: the SLO controller moves
                # it while requests wait.
                with tracing.span("admission_wait", model=str(model_key)):
                    while True:
                        limit = self._limit(g)
                        if g.inflight < limit and g.queue \
                                and g.queue[0] is ticket:
                            break
                        left = deadline - (time.monotonic() - t0)
                        if left <= 0:
                            g.queue.remove(ticket)
                            g.cond.notify_all()
                            with self._lock:
                                self.timed_out += 1
                            raise AdmissionRejected(
                                f"model {model_key!r}: queued request "
                                f"expired after {deadline:.0f}s without "
                                f"a free slot", status=503,
                                retry_after_s=self._retry_after(g, limit))
                        g.cond.wait(timeout=left)
                g.queue.popleft()
            g.inflight += 1
            with self._lock:
                self.admitted += 1
        try:
            yield
        finally:
            with g.cond:
                g.inflight -= 1
                g.cond.notify_all()

    def snapshot(self) -> dict:
        with self._lock:
            out = {"admitted": self.admitted, "queued": self.queued,
                   "rejected": self.rejected, "timed_out": self.timed_out,
                   "shed_slo": self.shed_slo,
                   "shed_mem": self.shed_mem,
                   "max_inflight": max_inflight(),
                   "slo_ms": slo_ms(),
                   "slo_max_inflight": slo_max_inflight(),
                   "queue_cap": queue_cap()}
            gates = list(self._gates.items())
        models = {}
        for k, g in gates:
            if not (g.inflight or g.queue or g.lat_ms):
                continue
            with g.cond:
                ent = {"inflight": g.inflight,
                       "queue_depth": len(g.queue),
                       "limit": self._limit(g)}
                if g.lat_ms:
                    lat = np.asarray(g.lat_ms, np.float64)
                    ent["mean_ms"] = round(float(lat.mean()), 3)
                    ent["p99_ms"] = round(float(np.percentile(lat, 99)), 3)
            models[k] = ent
        out["models"] = models
        return out

    def derived_limits(self) -> Dict[str, int]:
        """Per-model effective inflight limits (the h2o3_admission_limit
        gauge's collector)."""
        with self._lock:
            gates = list(self._gates.items())
        out = {}
        for k, g in gates:
            with g.cond:
                out[k] = self._limit(g)
        return out

    def reset(self) -> None:
        """Drop counters + idle gates (tests)."""
        with self._lock:
            self.admitted = self.queued = self.rejected = self.timed_out = 0
            self.shed_slo = 0
            self.shed_mem = 0
            self._gates = {k: g for k, g in self._gates.items()
                           if g.inflight or g.queue}


CONTROLLER = AdmissionController()
