"""The operation log, one process (counterpart of
h2o3_tpu/parallel/oplog.py).

On a multi-process cloud the coordinator broadcasts every device program
a REST handler runs, and followers replay it in order. One process has
no followers: `active` is False, `broadcast` returns no sequence, and
`turn(None)` is an empty context, so every handler runs its work
directly. The error classes are the reference's, for the REST layer's
503 mapping; `assume_coordination` raises `ElectionLost`, as the
reference's does when there is no coordinator to take over from. The
publish/replay loop, acknowledgements, rejoin and the standby election
come with the multi-process control plane (ROADMAP A14).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

# set while a REST server is up (api/server.start_server and stop)
REST_SERVING = False


class OplogPublishError(RuntimeError):
    """An op could not be published to the followers."""


class OplogTurnTimeout(RuntimeError):
    """An op's turnstile slot did not come up in time."""


class ElectionLost(RuntimeError):
    """This process is not the election winner, or there is no
    coordinator to take over from."""


def active() -> bool:
    return False


def broadcast(kind: str, payload: Dict[str, Any]) -> Optional[int]:
    return None


@contextlib.contextmanager
def turn(seq: Optional[int], timeout_s: Optional[float] = None):
    if seq is not None:
        raise ValueError("an op sequence outside a multi-process cloud")
    yield


def current_seq() -> int:
    return 0


def expected_acks() -> int:
    return 0


def follower_lag() -> List[dict]:
    return []


def rejoin_records() -> List[dict]:
    return []


def error_records() -> List[Tuple[int, dict]]:
    return []


def assume_coordination(caught_up_seq: Optional[int] = None,
                        force: bool = False) -> dict:
    raise ElectionLost("a one-process cloud has no coordinator to take "
                       "over from: this process already serves it")
