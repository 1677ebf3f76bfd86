"""Checkpoint knobs and records, one process (counterpart of
h2o3_tpu/parallel/ckpt.py).

`job_ckpt_iters` reads ``H2O_TPU_JOB_CKPT_ITERS`` as the reference does
(default 0). The port's builders have no iteration resume yet
(``ModelBuilder.supports_iteration_resume`` is False), so the REST
train handler never arms durable progress, even with the knob set.
Control-plane checkpoints, durable job progress and durable search
state come with the multi-process control plane (ROADMAP A14); until
then there are no records.
"""

from __future__ import annotations

from typing import List, Optional

from h2o3_tpu_torch.utils import retry


def interval_ops() -> int:
    return retry.env_int("H2O_TPU_OPLOG_CHECKPOINT_OPS", 64)


def job_ckpt_iters() -> int:
    return retry.env_int("H2O_TPU_JOB_CKPT_ITERS", 0)


def latest_seq() -> Optional[int]:
    return None


def has_job_progress(job_key: str) -> bool:
    return False


def job_progress_records() -> List[dict]:
    return []


def search_state_records() -> List[dict]:
    return []
