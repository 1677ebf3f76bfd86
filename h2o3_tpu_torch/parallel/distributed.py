"""Process topology, one process (counterpart of
h2o3_tpu/parallel/distributed.py).

One process is the whole cloud: its index is 0 and it leads epoch 0.
The reference's ``jax.distributed`` boot, its leader election records
and the cloud key/value store (over a ``torch.distributed`` store here)
come with the multi-process control plane (ROADMAP A14).
"""

from __future__ import annotations


def process_count() -> int:
    return 1


def process_index() -> int:
    return 0


def leader() -> int:
    return 0


def epoch() -> int:
    return 0
