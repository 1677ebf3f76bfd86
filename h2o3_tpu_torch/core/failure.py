"""Fault injection (counterpart of h2o3_tpu/core/failure.py `inject`
:177, `InjectedFault` :187, `faultpoint` :191).

Deterministic fault points let tests drive the error paths of the
memory ladder (``mem.exhausted`` in `memory/stream.run_windows`) without
a device that is really out of memory.

Cloud health, one process (the reference's :37-:136): the error class
the REST layer maps to 503, the staleness knob, this process's
incarnation (0) and an empty liveness table, because one process has
no peers to beat for. The heartbeat thread and `ShardUnavailableError`
come with the multi-process control plane (ROADMAP A14).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

from h2o3_tpu_torch.utils.retry import env_float

HEARTBEAT_STALE_S = 30.0


class CloudUnhealthyError(RuntimeError):
    """The cloud cannot complete multi-process work right now. The REST
    layer maps it to HTTP 503."""

    def __init__(self, msg: str, remote_trace: str = ""):
        if remote_trace:
            msg = f"{msg}\n--- remote traceback ---\n{remote_trace}"
        super().__init__(msg)
        self.remote_trace = remote_trace


def heartbeat_stale_s() -> float:
    """Beats older than this mark a process dead (env
    ``H2O_TPU_HEARTBEAT_STALE_S``, default 30 s)."""
    return env_float("H2O_TPU_HEARTBEAT_STALE_S", HEARTBEAT_STALE_S)


def incarnation() -> int:
    return 0


def cluster_health(stale_after_s: Optional[float] = None) -> List[dict]:
    """Per-process liveness rows; none in one process."""
    return []

# fault injection registry: name -> remaining trigger count
_FAULTS: Dict[str, int] = {}


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
