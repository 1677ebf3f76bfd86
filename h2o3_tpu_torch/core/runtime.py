"""Runtime boot (counterpart of h2o3_tpu/core/runtime.py `init` :270,
`cluster`, `Cluster.row_shards`/`pad_rows`/`put_rows`/`reshard_rows`
:150-181, `Cluster.info` :184, `self_benchmark` :209, `cluster_info`
:294 and `shutdown` :298).

The reference boots a device mesh with a ``rows`` axis. In the port a
"cluster" is the device every new column is placed on, and in a cloud
of several processes (parallel/distributed.py) it is also one rank of
the row mesh (parallel/mesh.py): the rows axis is the ranks, each
holding its contiguous block of every frame's rows. The port pads
nothing (its kernel masks its own ragged block), so `pad_rows` is the
identity; `put_rows` is ``Column.from_numpy`` keeping the rank's block
of a host array, and a column's tensor needs no resharding. The boot
runs as the ``backend_init`` and ``device_discovery`` lifecycle phases
(obs/phases.py).
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

import torch

from h2o3_tpu_torch.compat import resolve_device


# numeric_dtype names -> the torch storage dtype of T_NUM columns
NUMERIC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "bf16": torch.bfloat16}


def numeric_torch_dtype(name: str) -> torch.dtype:
    """The storage dtype a `numeric_dtype` name selects; an unknown name
    raises (it never falls back to float32)."""
    try:
        return NUMERIC_DTYPES[name]
    except KeyError:
        raise ValueError(f"numeric_dtype {name!r} is not one of "
                         f"{sorted(NUMERIC_DTYPES)}") from None


@dataclass
class OptArgs:
    """The runtime's options (the reference's OptArgs,
    h2o3_tpu/core/runtime.py:25). `numeric_dtype` is the device storage
    dtype of T_NUM columns: "float32" (default) or "bfloat16"/"bf16",
    which halves their bytes; ops widen at their boundaries as the
    reference's do."""

    numeric_dtype: str = "float32"

    def __setattr__(self, name, value):
        # the dataclass __init__ sets fields through here too
        if name == "numeric_dtype":
            numeric_torch_dtype(value)
        object.__setattr__(self, name, value)

    @staticmethod
    def from_env() -> "OptArgs":
        """Defaults overridden by ``H2O_TPU_<NAME>`` environment
        variables (``H2O_TPU_NUMERIC_DTYPE``)."""
        args = OptArgs()
        v = os.environ.get("H2O_TPU_NUMERIC_DTYPE")
        if v is not None:
            args.numeric_dtype = v
        return args


class Cluster:
    """The booted runtime: the device new columns land on and its
    options (`args`). `info` is the ``GET /3/Cloud`` surface and
    `self_benchmark` the ``/3/NetworkTest`` probes."""

    name = "h2o3-tpu-torch"

    def __init__(self, device: torch.device, args: Optional[OptArgs] = None):
        self.device = device
        self.args = args if args is not None else OptArgs.from_env()
        self.devices = [device]
        self.start_time = time.time()
        self.locked = False
        # a process of a multi-process cloud beats (HeartBeatThread), so
        # /3/Cloud's liveness rows stay fresh
        from h2o3_tpu_torch.parallel import distributed as D

        self._heartbeat = None
        if D.process_count() > 1:
            from h2o3_tpu_torch.core.failure import HeartbeatThread

            self._heartbeat = HeartbeatThread().start()
            D.ensure_mesh(device)

    # -- the row geometry (the reference's sharding helpers) ----------------
    @property
    def mesh(self):
        """The row mesh this process is a rank of (None in one process)."""
        from h2o3_tpu_torch.parallel import mesh

        return mesh.current()

    @property
    def row_shards(self) -> int:
        m = self.mesh
        return m.size if m is not None else 1

    def pad_rows(self, n: int) -> int:
        """No padding: the kernel masks its own ragged block."""
        return int(n)

    def device_name(self) -> str:
        if self.device.type == "cuda":
            return (f"{torch.cuda.get_device_name(self.device)} "
                    f"({self.device})")
        return "cpu"

    def info(self) -> dict:
        """The cluster's status; `mem_value_size` is the bytes frame
        columns hold on the device, as stored (bfloat16 columns at 2
        bytes a value)."""
        from h2o3_tpu_torch.core import cleaner, failure
        from h2o3_tpu_torch.parallel import distributed as D

        return {
            "cloud_name": self.name,
            "version": "h2o3_tpu_torch",
            "cloud_size": D.process_count(),
            "cloud_uptime_millis": int((time.time() - self.start_time)
                                       * 1000),
            "cloud_healthy": True,
            "locked": self.locked,
            "platform": self.device.type,
            "epoch": D.epoch(),
            "leader": D.leader(),
            "incarnation": failure.incarnation(),
            "nodes": [{"name": self.device_name(),
                       "platform": self.device.type,
                       "id": self.device.index or 0}],
            "numeric_dtype": self.args.numeric_dtype,
            "mem_value_size": cleaner.device_bytes_in_use(),
            "row_mesh": (self.mesh.describe() if self.mesh is not None
                         else None),
        }

    def self_benchmark(self, size: int = 1024) -> dict:
        """The reference's three boot probes on this device: a float32
        matmul (GFLOP/s), a stream ``out = a + b`` over 4·size² floats
        (GB/s, 3 arrays moved) and a latency probe, the reference's psum
        over the rows axis: an all-reduce over the row mesh's ranks (a
        collective: every rank runs it), or in one process a
        device-local reduction; ``psum_probe`` says which."""
        dev = self.device
        cuda = dev.type == "cuda"

        def sync():
            if cuda:
                torch.cuda.synchronize(dev)

        reps = 10
        with full_float32():
            x = torch.ones((size, size), dtype=torch.float32, device=dev)
            y = x @ x
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                y = x @ x
            sync()
            gflops = 2 * size ** 3 * reps / (time.perf_counter() - t0) / 1e9
        n = 4 * size * size
        a = torch.ones(n, dtype=torch.float32, device=dev)
        b = torch.ones(n, dtype=torch.float32, device=dev)
        c = a + b
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            c = a + b
        sync()
        membw = 3 * n * 4 * reps / (time.perf_counter() - t0) / 1e9
        vec = torch.ones(1, dtype=torch.float32, device=dev)
        m = self.mesh
        if m is not None:
            # the reference's probe: an all-reduce of one float32 over the
            # rows axis, here the row mesh's ranks (every rank runs it)
            m.all_reduce(vec.clone())
            t0 = time.perf_counter()
            for _ in range(50):
                m.all_reduce(vec.clone())
            sync()
            probe = (f"all-reduce of one float32 over {m.size} rank(s), "
                     f"{m.backend}")
        else:
            r = vec.sum()
            sync()
            t0 = time.perf_counter()
            for _ in range(50):
                r = vec.sum()
            sync()
            probe = "device-local sum of one float32 (one device, no " \
                    "collective)"
        psum_us = (time.perf_counter() - t0) / 50 * 1e6
        del y, c
        out = {"matmul_gflops": gflops, "membw_gbps": membw,
               "psum_latency_us": psum_us, "size": size,
               "device": self.device_name(), "psum_probe": probe}
        from h2o3_tpu_torch.utils import timeline

        timeline.record("self_benchmark", "boot_probe", **{
            k: round(v, 2) for k, v in out.items()
            if isinstance(v, float)})
        return out


# reentrant: extension hooks run under the boot lock and may call init()
_LOCK = threading.RLock()
_CLUSTER: Optional[Cluster] = None


def init(device=None, args: Optional[OptArgs] = None, **kw) -> Cluster:
    """Boot (or re-point) the runtime. `device` None means CUDA and raises
    when there is none; ``device="cpu"`` runs everything on the CPU.
    `args` (default: `OptArgs.from_env()`) and keyword options such as
    ``numeric_dtype="bfloat16"`` set the runtime's options; given to a
    booted runtime they replace its options. The first boot runs the
    registered extensions' hooks (``extensions.register_extension``)."""
    global _CLUSTER
    from h2o3_tpu_torch.obs import phases

    if args is not None or kw:
        a = OptArgs(**vars(args)) if args is not None \
            else OptArgs.from_env()
        for k, v in kw.items():
            if not hasattr(a, k):
                raise TypeError(f"init() got an unknown option {k!r}")
            setattr(a, k, v)
    else:
        a = None
    with _LOCK:
        if _CLUSTER is not None and device is not None and \
                _CLUSTER.device == torch.device(device):
            if a is not None:
                _CLUSTER.args = a
            return _CLUSTER
        with phases.enter("backend_init", device=str(device or "cuda")):
            dev = resolve_device(device)
            if dev.type == "cuda":
                torch.cuda.init()
        if _CLUSTER is None or _CLUSTER.device != dev:
            with phases.enter("device_discovery", device=str(dev)):
                _CLUSTER = Cluster(dev, a if a is not None else (
                    _CLUSTER.args if _CLUSTER is not None else None))
                if dev.type == "cuda":
                    torch.cuda.get_device_properties(dev)
            from h2o3_tpu_torch import extensions

            extensions.run_extension_hooks(_CLUSTER)
        elif a is not None:
            _CLUSTER.args = a
        return _CLUSTER


def cluster() -> Cluster:
    """The booted runtime, booting it on CUDA if nothing was booted."""
    return _CLUSTER if _CLUSTER is not None else init()


def cluster_info() -> dict:
    return cluster().info()


def shutdown() -> None:
    """Drop the runtime and every stored key (h2o.cluster().shutdown());
    registered extensions re-run their hooks against the next boot."""
    global _CLUSTER
    from h2o3_tpu_torch import extensions
    from h2o3_tpu_torch.core.dkv import DKV

    with _LOCK:
        if _CLUSTER is not None and _CLUSTER._heartbeat is not None:
            _CLUSTER._heartbeat.stop()
        DKV.clear()
        _CLUSTER = None
    extensions._INITIALIZED.clear()


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
