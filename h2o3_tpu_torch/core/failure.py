"""Failure detection and fault injection (counterpart of
h2o3_tpu/core/failure.py).

Reference: water/HeartBeatThread.java:16, where every node gossips a
heartbeat and peers that miss beats are declared dead. Here:

- a heartbeat table in the cloud KV (``h2o3/heartbeat/{proc}``, each
  beat ``{ts, proc, inc}``), so ``/3/Cloud`` shows per-process liveness
  (`heartbeat`, `cluster_health`, `HeartbeatThread`);
- this process's incarnation, bumped by a rejoin, so a restarted
  follower's beats and acks differ from its dead predecessor's;
- deterministic fault points (`inject`, `faultpoint`) for the error
  paths: the memory ladder (``mem.exhausted``), the oplog's publish,
  put, ack and replay, the checkpoint write, heartbeats and supervision.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, List, Optional

from h2o3_tpu_torch.utils.retry import env_float

_HB_PREFIX = "h2o3/heartbeat/"
HEARTBEAT_STALE_S = 30.0

# fault injection registry: name -> remaining trigger count
_FAULTS: Dict[str, int] = {}

# this process's incarnation: bumped by rejoin() (water/H2ONode.java's
# heartbeat freshness)
_INCARNATION = 0


class CloudUnhealthyError(RuntimeError):
    """The cloud cannot complete multi-process work now: a follower
    crashed mid-replay (its traceback rides along), stopped
    acknowledging ops, or went heartbeat-stale. The REST layer maps it
    to HTTP 503; the supervisor fails in-flight jobs with its text."""

    def __init__(self, msg: str, remote_trace: str = ""):
        if remote_trace:
            msg = f"{msg}\n--- remote traceback ---\n{remote_trace}"
        super().__init__(msg)
        self.remote_trace = remote_trace


class ShardUnavailableError(CloudUnhealthyError):
    """Degraded-mode local work needs data homed on a dead or unreachable
    peer. Carries the owning process indices, so the operator knows
    which process to restart; the REST layer maps it to HTTP 503."""

    def __init__(self, what: str, owners: Optional[List[int]] = None):
        self.owners = sorted(owners or [])
        owner_s = (f"process(es) {self.owners}" if self.owners
                   else "a non-coordinator process")
        super().__init__(
            f"{what}: shards are homed on {owner_s}, which this degraded "
            "cloud cannot reach. Remediation: restart the dead process and "
            "let it rejoin() (FAILED -> RECOVERING -> HEALTHY), or restart "
            "the cloud and re-import the frame")


def heartbeat_stale_s() -> float:
    """Beats older than this mark a process dead (env
    ``H2O_TPU_HEARTBEAT_STALE_S``, default 30 s)."""
    return env_float("H2O_TPU_HEARTBEAT_STALE_S", HEARTBEAT_STALE_S)


def election_grace_s() -> float:
    """How long the coordinator must stay silent before a standby may
    assume coordination (env ``H2O_TPU_ELECTION_GRACE_S``, default twice
    the staleness window: an election disrupts more than a degrade)."""
    return env_float("H2O_TPU_ELECTION_GRACE_S", 2.0 * heartbeat_stale_s())


def incarnation() -> int:
    return _INCARNATION


def set_incarnation(inc: int) -> None:
    global _INCARNATION
    _INCARNATION = int(inc)


def bump_incarnation() -> int:
    """A new life for this process (a rejoin after a crash or restart):
    its beats and acks from here on carry the fresh incarnation."""
    global _INCARNATION
    _INCARNATION += 1
    return _INCARNATION


def heartbeat() -> bool:
    """Publish this process's liveness beat; False in one process."""
    from h2o3_tpu_torch.parallel import distributed as D

    faultpoint("failure.heartbeat")
    proc = D.process_index()
    return D.kv_put(_HB_PREFIX + str(proc),
                    json.dumps({"ts": time.time(), "proc": proc,
                                "inc": _INCARNATION}))


def cluster_health(stale_after_s: Optional[float] = None) -> List[dict]:
    """Per-process liveness from the heartbeat table: one row per process
    that has ever beat, with its age, incarnation and a healthy flag."""
    from h2o3_tpu_torch.parallel import distributed as D

    if stale_after_s is None:
        stale_after_s = heartbeat_stale_s()
    now = time.time()
    out = []
    for _key, val in D.kv_dir(_HB_PREFIX):
        try:
            rec = json.loads(val)
            age = now - float(rec.get("ts", 0))
        except (ValueError, TypeError, AttributeError):
            continue
        out.append({"process": rec.get("proc"), "age_s": round(age, 3),
                    "incarnation": int(rec.get("inc", 0)),
                    "healthy": age < stale_after_s})
    return sorted(out, key=lambda r: (r["process"] is None, r["process"]))


class HeartbeatThread:
    """The background beater (the reference runs one per node). Its
    default interval is a quarter of the staleness window, at most 5 s,
    so a short ``H2O_TPU_HEARTBEAT_STALE_S`` never reads a live process
    as stale."""

    def __init__(self, interval_s: Optional[float] = None):
        self.interval = float(interval_s if interval_s is not None
                              else min(5.0, heartbeat_stale_s() / 4.0))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatThread":
        def beat_once():
            try:
                heartbeat()
            except Exception:   # noqa: BLE001 — a transient store fault
                pass            # must not end the beater for good

        def run():
            while not self._stop.wait(self.interval):
                beat_once()

        beat_once()
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="h2o3-heartbeat")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def inject(name: str, times: int = 1):
    """Arm the named fault point for `times` triggers within the block."""
    _FAULTS[name] = int(times)
    try:
        yield
    finally:
        _FAULTS.pop(name, None)


class InjectedFault(RuntimeError):
    pass


def faultpoint(name: str) -> None:
    """Raise InjectedFault if the named fault is armed (a dict lookup
    otherwise)."""
    left = _FAULTS.get(name)
    if left:
        _FAULTS[name] = left - 1
        if _FAULTS[name] <= 0:
            _FAULTS.pop(name, None)
        raise InjectedFault(f"injected fault: {name}")
