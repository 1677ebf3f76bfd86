"""Cloud health, one process (counterpart of
h2o3_tpu/parallel/supervisor.py).

One process cannot lose a peer: its cloud is HEALTHY, and `status`
reports that with an empty transition history. The state machine over
heartbeats and follower errors, and the supervisor thread that fails
in-flight jobs, come with the multi-process control plane
(ROADMAP A14).
"""

from __future__ import annotations

import time
from typing import Dict

HEALTHY, DEGRADED, FAILED = "HEALTHY", "DEGRADED", "FAILED"
RECOVERING = "RECOVERING"

_SINCE = time.time()


def state() -> str:
    return HEALTHY


def status() -> Dict:
    return {"state": HEALTHY, "since": _SINCE, "reason": "",
            "remote_trace": "", "hold_until": 0.0, "incs_at_failure": {},
            "transitions": []}


def reset() -> None:
    return None
