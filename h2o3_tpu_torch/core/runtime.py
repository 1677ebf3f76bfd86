"""Runtime boot: one device (counterpart of h2o3_tpu/core/runtime.py
`init` :270 / `cluster`).

The reference boots a device mesh with a ``rows`` axis; the port runs on
one device, so that axis collapses and a "cluster" is the device every
new column is placed on.
"""

from __future__ import annotations

from typing import Optional

import torch

from h2o3_tpu_torch.compat import resolve_device


class Cluster:
    """The booted runtime: the device new columns land on."""

    def __init__(self, device: torch.device):
        self.device = device


_CLUSTER: Optional[Cluster] = None


def init(device=None) -> Cluster:
    """Boot (or re-point) the runtime. `device` None means CUDA and raises
    when there is none; ``device="cpu"`` runs everything on the CPU."""
    global _CLUSTER
    dev = resolve_device(device)
    if _CLUSTER is None or _CLUSTER.device != dev:
        _CLUSTER = Cluster(dev)
    return _CLUSTER


def cluster() -> Cluster:
    """The booted runtime, booting it on CUDA if nothing was booted."""
    return _CLUSTER if _CLUSTER is not None else init()
