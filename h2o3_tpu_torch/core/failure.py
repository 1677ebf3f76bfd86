"""Fault injection (counterpart of h2o3_tpu/core/failure.py `inject`
:177, `InjectedFault` :187, `faultpoint` :191).

Deterministic fault points let tests drive the error paths of the
memory ladder (``mem.exhausted`` in `memory/stream.run_windows`) without
a device that is really out of memory. The heartbeat and cloud-health
half of the reference waits for the multi-process control plane
(ROADMAP A14).
"""

from __future__ import annotations

import contextlib
from typing import Dict

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
