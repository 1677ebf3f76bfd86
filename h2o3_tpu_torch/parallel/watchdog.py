"""The recovery watchdog's knobs, one process (counterpart of
h2o3_tpu/parallel/watchdog.py).

`MAX_ATTEMPTS` and `enabled` are the reference's. The watchdog itself
(elections, rejoins, resuming failed jobs and orphaned searches) acts on
a multi-process cloud and comes with that control plane (ROADMAP A14);
in one process it never ticks, and `status` says so.
"""

from __future__ import annotations

from typing import Dict

from h2o3_tpu_torch.utils import retry

MAX_ATTEMPTS = 5


def enabled() -> bool:
    return retry.env_int("H2O_TPU_AUTO_RECOVER", 1) != 0


def status() -> Dict:
    return {"ticks": 0, "elections": 0, "rejoins": 0, "jobs_resumed": 0,
            "searches_resumed": 0, "last_action": "", "last_error": "",
            "last_tick": 0.0, "running": False, "enabled": enabled(),
            "replay_idle_timeout_s": 900.0}
