"""Runtime boot: one device (counterpart of h2o3_tpu/core/runtime.py
`init` :270 / `cluster`).

The reference boots a device mesh with a ``rows`` axis; the port runs on
one device, so that axis collapses and a "cluster" is the device every
new column is placed on.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import torch

from h2o3_tpu_torch.compat import resolve_device


class Cluster:
    """The booted runtime: the device new columns land on."""

    def __init__(self, device: torch.device):
        self.device = device


# reentrant: extension hooks run under the boot lock and may call init()
_LOCK = threading.RLock()
_CLUSTER: Optional[Cluster] = None


def init(device=None) -> Cluster:
    """Boot (or re-point) the runtime. `device` None means CUDA and raises
    when there is none; ``device="cpu"`` runs everything on the CPU. The
    first boot runs the registered extensions' hooks
    (``extensions.register_extension``)."""
    global _CLUSTER
    dev = resolve_device(device)
    with _LOCK:
        if _CLUSTER is None or _CLUSTER.device != dev:
            _CLUSTER = Cluster(dev)
            from h2o3_tpu_torch import extensions

            extensions.run_extension_hooks(_CLUSTER)
        return _CLUSTER


def cluster() -> Cluster:
    """The booted runtime, booting it on CUDA if nothing was booted."""
    return _CLUSTER if _CLUSTER is not None else init()


# One CUDA-graph capture at a time in the process: the scoring sessions'
# bucket programs and DeepLearning's step loop capture under it, so two
# captures never interleave (ROADMAP C27).
CAPTURE_LOCK = threading.Lock()


# -- full float32 matmuls (ROADMAP C26) ------------------------------------
# The port's float32 matmuls (KMeans' distances, PCA, DeepLearning,
# Word2Vec, Aggregator) are held to the CPU and to the reference at
# float32's precision, so they must not follow torch's process-wide TF32
# switch. Every ModelBuilder.train and Model.predict runs inside
# `full_float32`: the first entry saves the caller's
# `torch.get_float32_matmul_precision()` (which also drives
# `torch.backends.cuda.matmul.allow_tf32`) and
# `torch.backends.cudnn.allow_tf32`, and pins "highest" and False; the
# last exit restores them. A depth count under one lock, because trains
# overlap on threads (grid and AutoML members): a save and restore per
# call would let one call restore the flag under another still running.
_F32_LOCK = threading.Lock()
_F32_DEPTH = 0
_F32_SAVED = ("highest", False)


@contextlib.contextmanager
def full_float32():
    """Run the body with full float32 matmul precision (see above)."""
    global _F32_DEPTH, _F32_SAVED
    with _F32_LOCK:
        if _F32_DEPTH == 0:
            _F32_SAVED = (torch.get_float32_matmul_precision(),
                          torch.backends.cudnn.allow_tf32)
            torch.set_float32_matmul_precision("highest")
            torch.backends.cudnn.allow_tf32 = False
        _F32_DEPTH += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _F32_DEPTH -= 1
            if _F32_DEPTH == 0:
                torch.set_float32_matmul_precision(_F32_SAVED[0])
                torch.backends.cudnn.allow_tf32 = _F32_SAVED[1]


def in_full_float32(fn):
    """`fn` run inside `full_float32`."""
    @functools.wraps(fn)
    def pinned(*args, **kwargs):
        with full_float32():
            return fn(*args, **kwargs)
    pinned._full_float32 = True
    return pinned
