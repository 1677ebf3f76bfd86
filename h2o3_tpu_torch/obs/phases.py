"""Runtime lifecycle phases with deadlines (counterpart of
h2o3_tpu/obs/phases.py), for ``GET /3/Runtime``.

- **Closed enumeration** (:data:`PHASES`), the reference's names:
  ``backend_init`` (the CUDA context, `core/runtime.init`),
  ``device_discovery`` (the card's properties), ``first_compile`` (the
  first kernel or host-library build), ``server_start`` (the REST bind).
  ``mesh_init``, ``compile_cache_load`` and ``cloud_form`` stay in the
  enumeration for the wire format; one device forms no mesh and no
  cloud, and the port's compile cache loads nothing at boot.
- **Context manager** (:func:`enter`): a ``phase`` timeline event at
  entry (a wedged phase leaves its begin event as the ring's last
  word), a completion event with wall ms, a trace span when a trace is
  active, and the ``h2o3_phase_*`` metrics.
- **Hard deadlines** (``H2O_TPU_PHASE_DEADLINE_S``, a map like
  ``"backend_init=45,first_compile=90"`` or one number for every
  phase): on expiry a daemon timer dumps a flight record naming the
  wedged phase and, for
  ``backend_init`` / ``first_compile`` with
  ``H2O_TPU_PHASE_DEADLINE_EXIT=1``, exits with :data:`DEADLINE_EXIT_RC`.

Import cost: stdlib only.
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

# the closed lifecycle enumeration
PHASES = frozenset({
    "backend_init",         # the CUDA context (core/runtime.init)
    "device_discovery",     # the card's name and memory
    "mesh_init",            # (a device mesh; none on one card)
    "first_compile",        # the first nvcc/g++ build of the process
    "compile_cache_load",   # (persistent-cache load; none at boot)
    "server_start",         # REST server bring-up
    "cloud_form",           # (multi-process cloud formation)
})

# display / report order (lifecycle order, not set order)
ORDER = ("cloud_form", "backend_init", "device_discovery", "mesh_init",
         "first_compile", "compile_cache_load", "server_start")

# a process exits with this code when a backend_init/first_compile
# deadline expires under H2O_TPU_PHASE_DEADLINE_EXIT=1
DEADLINE_EXIT_RC = 97

_EXIT_PHASES = ("backend_init", "first_compile")

_LOCK = threading.Lock()
_HISTORY: "collections.deque[dict]" = collections.deque(maxlen=256)
# most recent COMPLETED record per phase, outside the bounded ring: the
# boot durations (backend_init .. first_compile) must survive however
# many later server_start / compile_cache_load entries the ring churns
_LATEST: Dict[str, dict] = {}
_FIRSTS: set = set()


def deadlines() -> Dict[str, float]:
    """Per-phase hard deadlines from ``H2O_TPU_PHASE_DEADLINE_S`` — either
    one number (every phase) or a ``name=secs`` comma map. Unset/0 =
    unsupervised (the default)."""
    raw = os.environ.get("H2O_TPU_PHASE_DEADLINE_S", "").strip()
    if not raw:
        return {}
    out: Dict[str, float] = {}
    if "=" not in raw:
        try:
            d = float(raw)
        except ValueError:
            return {}
        return {p: d for p in PHASES} if d > 0 else {}
    for part in raw.replace(";", ",").split(","):
        if "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            d = float(val)
        except ValueError:
            continue
        if name.strip() in PHASES and d > 0:
            out[name.strip()] = d
    return out


def deadline_exit_enabled() -> bool:
    """``H2O_TPU_PHASE_DEADLINE_EXIT=1``: a backend_init/first_compile
    expiry hard-exits the process with :data:`DEADLINE_EXIT_RC` (never
    on by default)."""
    return os.environ.get("H2O_TPU_PHASE_DEADLINE_EXIT", "").lower() in (
        "1", "true", "on")


# ---------------------------------------------------------------------------
# recording helpers (lazy imports; everything best-effort — phase
# bookkeeping must never be what kills a healthy boot)
# ---------------------------------------------------------------------------

def _timeline(what: str, ms: Optional[float] = None, **meta) -> None:
    try:
        from h2o3_tpu_torch.utils import timeline

        timeline.record("phase", what, ms=ms, **meta)
    except Exception:   # noqa: BLE001
        pass


def _metric(kind: str, name: str, *args, **labels) -> None:
    try:
        from h2o3_tpu_torch.obs import metrics

        getattr(metrics, kind)(name, *args, **labels)
    except Exception:   # noqa: BLE001
        pass


def _on_deadline(rec: dict) -> None:
    """Deadline expiry (timer thread): a flight record naming the phase,
    the metrics, and (with ``H2O_TPU_PHASE_DEADLINE_EXIT=1``) the fast
    process exit."""
    with _LOCK:
        if rec.get("status") != "running":
            return                      # phase won the race: completed
        rec["status"] = "deadline"
    name = rec["phase"]
    _timeline(name, status="deadline", deadline_s=rec.get("deadline_s"))
    _metric("inc", "h2o3_phase_deadline_exceeded_total", phase=name)
    try:
        from h2o3_tpu_torch.obs import flight

        rec["flight_record"] = flight.record_flight(
            f"phase_deadline_{name}",
            extra={"phase": name, "deadline_s": rec.get("deadline_s"),
                   "phase_history": history()})
    except Exception:   # noqa: BLE001
        pass
    if deadline_exit_enabled() and name in _EXIT_PHASES:
        try:
            sys.stderr.flush()
            sys.stdout.flush()
        except Exception:   # noqa: BLE001
            pass
        os._exit(DEADLINE_EXIT_RC)


@contextlib.contextmanager
def enter(name: str, **meta):
    """Enter a lifecycle phase. `name` must be one of :data:`PHASES`.
    The ``phases.deadline``
    faultpoint fakes a wedged phase body (sleeping past the configured
    deadline), so the expiry machinery is drivable in tests."""
    if name not in PHASES:
        raise ValueError(f"unknown phase {name!r}; the enumeration is "
                         f"closed: {sorted(PHASES)}")
    dl = deadlines().get(name)
    rec: Dict[str, Any] = {"phase": name, "start_ts": time.time(),
                           "status": "running", "ms": None,
                           "deadline_s": dl, "pid": os.getpid()}
    if meta:
        rec["meta"] = {str(k): v for k, v in meta.items()}
    with _LOCK:
        _HISTORY.append(rec)
    _timeline(name, status="begin", deadline_s=dl)
    _metric("set_gauge", "h2o3_phase_active", 1.0, phase=name)
    timer = None
    if dl:
        timer = threading.Timer(dl, _on_deadline, args=(rec,))
        timer.daemon = True
        timer.start()
    wedged = False
    try:
        from h2o3_tpu_torch.core import failure

        failure.faultpoint("phases.deadline")
    except Exception as e:   # noqa: BLE001 — InjectedFault == fake wedge
        wedged = type(e).__name__ == "InjectedFault"
    if wedged and dl:
        # simulate the wedge: hold the phase open until the deadline
        # machinery has demonstrably fired (flight record)
        time.sleep(dl + 0.25)
    t0 = time.perf_counter()
    try:
        from h2o3_tpu_torch.obs import tracing

        span_cm = tracing.span("phase", phase=name)
    except Exception:   # noqa: BLE001
        span_cm = contextlib.nullcontext()
    try:
        with span_cm:
            yield rec
    except BaseException:
        with _LOCK:
            if rec["status"] == "running":
                rec["status"] = "error"
            rec["ms"] = round((time.perf_counter() - t0) * 1000, 3)
            _LATEST[name] = dict(rec)
        _timeline(name, ms=rec["ms"], status=rec["status"])
        _metric("set_gauge", "h2o3_phase_active", 0.0, phase=name)
        raise
    finally:
        if timer is not None:
            timer.cancel()
    with _LOCK:
        expired = rec["status"] == "deadline"
        if not expired:
            rec["status"] = "ok"
        rec["ms"] = round((time.perf_counter() - t0) * 1000, 3)
        _LATEST[name] = dict(rec)
    _timeline(name, ms=rec["ms"], status=rec["status"])
    _metric("set_gauge", "h2o3_phase_active", 0.0, phase=name)
    _metric("observe", "h2o3_phase_duration_seconds", rec["ms"] / 1000.0,
            phase=name)
    if not expired:
        _metric("inc", "h2o3_phase_completed_total", phase=name)


def first(name: str, **meta):
    """`enter(name)` the first time the process asks, an empty context
    after that (``first_compile``: only the process's first build is
    the lifecycle phase)."""
    with _LOCK:
        seen = name in _FIRSTS
        _FIRSTS.add(name)
    return contextlib.nullcontext() if seen else enter(name, **meta)


def history() -> List[dict]:
    """The phase record ring, oldest first (each: phase, start_ts, ms,
    status running|ok|deadline|error, deadline_s)."""
    with _LOCK:
        return [dict(r) for r in _HISTORY]


def phase_report() -> Dict[str, float]:
    """{phase: wall ms} of the most recent COMPLETED entry per phase, in
    lifecycle order. Read from the per-phase latest store (not the bounded ring), so the
    boot durations survive long-lived processes."""
    with _LOCK:
        latest = {p: r["ms"] for p, r in _LATEST.items()
                  if r.get("ms") is not None}
    return {p: latest[p] for p in ORDER if p in latest}


def wedged_phase(grace_s: float = 120.0) -> Optional[str]:
    """Name of the oldest phase that never completed — deadline-expired
    with no completion time, or running PAST its deadline (or past
    `grace_s` when unsupervised). A phase merely in progress is not
    wedged, and one that blew its deadline but did finish keeps its
    'deadline' verdict in history without reading as wedged."""
    now = time.time()
    for r in history():
        st = r.get("status")
        if st == "deadline" and r.get("ms") is None:
            return r["phase"]
        if st == "running":
            age = now - float(r.get("start_ts") or now)
            if age > float(r.get("deadline_s") or grace_s):
                return r["phase"]
    return None


def reset_for_tests() -> None:
    with _LOCK:
        _HISTORY.clear()
        _LATEST.clear()
        _FIRSTS.clear()
