"""Flight recorder: postmortems that survive the process (counterpart
of h2o3_tpu/obs/flight.py).

On a fatal signal (or an explicit `record_flight`) the timeline ring,
this thread's open spans and a metrics snapshot persist atomically
(tmp + rename) to ``$H2O_TPU_OBS_FLIGHT_DIR`` (default
``$H2O_TPU_ICE_ROOT/flight``, the ice root defaulting to a folder of
the system's temporary directory), size-capped and self-GCing
(``H2O_TPU_OBS_FLIGHT_KEEP`` newest kept). ``GET /3/FlightRecords``
lists and fetches them.

The process index is the one-process answer, 0, with no backend
probe: nothing here touches the card, so a process stuck in a CUDA call
can still dump."""

from __future__ import annotations

import json
import os
import re
import signal
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

_NAME_RE = re.compile(r"^flight_[\w.\-]+\.json$")
_TIMELINE_CAP = 1000            # newest timeline events kept in a record
_MAX_BYTES = 2_000_000          # hard cap per record (events trimmed to fit)
_LOCK = threading.Lock()
_SIGNAL_HOOKS_INSTALLED = False


def flight_dir() -> str:
    d = os.environ.get("H2O_TPU_OBS_FLIGHT_DIR", "").strip()
    if not d:
        ice = os.environ.get("H2O_TPU_ICE_ROOT") or os.path.join(
            tempfile.gettempdir(), "h2o3_tpu_torch")
        d = os.path.join(ice, "flight")
    return d


def keep_records() -> int:
    try:
        return max(int(os.environ.get("H2O_TPU_OBS_FLIGHT_KEEP", "20")), 1)
    except ValueError:
        return 20


def _safe_process_index() -> int:
    """This process's index: one process is the whole cloud, index 0."""
    return 0


def _payload(reason: str, extra: Optional[Dict[str, Any]]) -> dict:
    """Assemble the record; every section is individually best-effort so a
    half-broken process still dumps what it can."""
    out: Dict[str, Any] = {"reason": str(reason), "ts": time.time(),
                           "pid": os.getpid(),
                           "process_index": _safe_process_index()}
    try:
        from h2o3_tpu_torch.utils import timeline

        out["timeline"] = timeline.events(_TIMELINE_CAP)
    except Exception:   # noqa: BLE001
        out["timeline"] = []
    try:
        from h2o3_tpu_torch.obs import tracing

        out["open_spans"] = tracing.open_spans()
        out["recent_traces"] = tracing.recent_traces(10)
    except Exception:   # noqa: BLE001
        out["open_spans"] = []
    try:
        from h2o3_tpu_torch.obs import metrics

        out["metrics"] = metrics.REGISTRY.snapshot()
    except Exception:   # noqa: BLE001
        out["metrics"] = []
    if extra:
        out["extra"] = extra
    return out


def record_flight(reason: str,
                  extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Persist one flight record; returns its path (None when even the
    dump failed — the recorder never raises)."""
    try:
        payload = _payload(reason, extra)
        body = json.dumps(payload, default=str)
        while len(body) > _MAX_BYTES and payload["timeline"]:
            # trim oldest events until the record fits the size cap
            payload["timeline"] = payload["timeline"][
                len(payload["timeline"]) // 2:]
            payload["truncated"] = True
            body = json.dumps(payload, default=str)
        d = flight_dir()
        os.makedirs(d, exist_ok=True)
        safe = re.sub(r"[^\w.\-]", "_", str(reason))[:64]
        name = (f"flight_{time.strftime('%Y%m%d_%H%M%S')}"
                f"_{safe}_{os.getpid()}.json")
        path = os.path.join(d, name)
        tmp = f"{path}.{os.getpid()}.part"
        with open(tmp, "w") as f:
            f.write(body)
        os.replace(tmp, path)
        _gc(d)
    except Exception:   # noqa: BLE001 — postmortem must not crash the
        return None     # process it is autopsying
    try:
        from h2o3_tpu_torch.obs import metrics
        from h2o3_tpu_torch.utils import timeline

        metrics.inc("h2o3_flight_records_total")
        timeline.record("flight", str(reason), path=path)
    except Exception:   # noqa: BLE001
        pass
    return path


def _gc(d: str) -> None:
    with _LOCK:
        try:
            names = sorted(n for n in os.listdir(d) if _NAME_RE.match(n))
        except OSError:
            return
        for n in names[: max(len(names) - keep_records(), 0)]:
            try:
                os.remove(os.path.join(d, n))
            except OSError:
                pass


def list_records() -> List[dict]:
    d = flight_dir()
    out = []
    try:
        names = [n for n in os.listdir(d) if _NAME_RE.match(n)]
    except OSError:
        return []
    for n in sorted(names, reverse=True):
        p = os.path.join(d, n)
        try:
            st = os.stat(p)
        except OSError:
            continue
        # flight_{YYYYmmdd_HHMMSS}_{reason}_{pid}.json
        m = re.match(r"^flight_\d{8}_\d{6}_(.+)_(\d+)\.json$", n)
        out.append({"name": n, "bytes": st.st_size,
                    "mtime": st.st_mtime,
                    "reason": m.group(1) if m else None,
                    "pid": int(m.group(2)) if m else None})
    return out


def read_record(name: str) -> Optional[bytes]:
    """Raw JSON bytes of one record; None for unknown/unsafe names (the
    pattern check is the path-traversal gate)."""
    if not _NAME_RE.match(name or ""):
        return None
    try:
        with open(os.path.join(flight_dir(), name), "rb") as f:
            return f.read()
    except OSError:
        return None


# ---------------------------------------------------------------------------
# fatal-signal hooks (main thread only; H2O_TPU_OBS_SIGNALS=0 disables)
# ---------------------------------------------------------------------------

def signals_enabled() -> bool:
    return os.environ.get("H2O_TPU_OBS_SIGNALS", "1").lower() not in (
        "0", "false", "off")


def install_signal_hooks() -> bool:
    """Chain a flight dump in front of SIGTERM/SIGQUIT, then re-deliver
    the default action — so an external kill (k8s eviction, a scheduler
    timeout that TERMs before KILLing) leaves a record. Idempotent;
    False when disabled or not callable from this (non-main) thread.

    Deadlock discipline: the interrupted main-thread frame may hold any
    of the locks the dump needs (timeline/metric/span stores), so the
    handler must not run record_flight inline. It restores SIG_DFL
    FIRST (a second signal always kills), runs the dump on a side thread
    with a bounded join, then re-raises — worst case a wedged dump
    delays death by the join timeout, never forever."""
    global _SIGNAL_HOOKS_INSTALLED
    if not signals_enabled() or _SIGNAL_HOOKS_INSTALLED:
        return _SIGNAL_HOOKS_INSTALLED

    def handler(signum, frame):
        signal.signal(signum, signal.SIG_DFL)
        t = threading.Thread(
            target=record_flight,
            args=(f"signal_{signal.Signals(signum).name}",), daemon=True)
        t.start()
        t.join(timeout=5.0)
        signal.raise_signal(signum)

    try:
        for sig in (signal.SIGTERM, signal.SIGQUIT):
            signal.signal(sig, handler)
    except (ValueError, OSError):       # not the main thread / no signals
        return False
    _SIGNAL_HOOKS_INSTALLED = True
    return True
