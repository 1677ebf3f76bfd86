"""TimeLine event ring and the torch.profiler wiring
(counterpart of h2o3_tpu/utils/timeline.py).

Reference: water/TimeLine.java:22, a per-node ring of wire events
snapshotted over REST. Here the events are the port's dispatches,
phases, profiler captures and REST requests; the ring is process-wide
and always on.

`device_memory` reads the card's own gauges (``torch.cuda.memory_stats``,
``mem_get_info``, ``max_memory_allocated``) where the reference reads
``jax.local_devices()[i].memory_stats()``. `profiler_start` /
`profiler_stop` drive ``torch.profiler`` with CPU and CUDA activities,
one capture at a time, and write a Chrome trace where the reference
drives ``jax.profiler``.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

_RING: collections.deque = collections.deque(maxlen=4096)
_LOCK = threading.Lock()

# the closed enumeration of event kinds the port may record: free-form
# kind drift makes the ring un-queryable. "rest" is emitted by
# the API layer's request ring merge, not by record().
KINDS = frozenset({
    "cloud",            # cloud joins, supervision transitions, elections,
                        # rejoins, demotions, job resumes
    "flight",           # flight-recorder dumps (obs/flight.py)
    "job",              # durable job-progress saves (parallel/ckpt.py)
    "mesh",             # row-mesh process groups built (parallel/mesh.py)
    "mrtask",           # map_reduce profiles (core/mrtask.py)
    "oplog",            # control-plane checkpoints (parallel/ckpt.py)
    "phase",            # lifecycle phase begin/end (obs/phases.py)
    "profiler",         # /3/Profiler start/stop captures
    "rest",             # REST request ring (api/server.py merge)
    "scoring",          # fused serving dispatches
    "search",           # durable AutoML/grid search-state saves, resumes
    "self_benchmark",   # device probes (/3/NetworkTest)
})

_RESERVED = ("time_ms", "kind", "what", "ms")


def record(kind: str, what: str, ms: Optional[float] = None, **meta) -> None:
    ev = {"time_ms": int(time.time() * 1000), "kind": kind, "what": what}
    if ms is not None:
        ev["ms"] = round(float(ms), 3)
    # reserved keys win: caller meta must not clobber the event's identity
    # fields (a meta dict splatted with e.g. time_ms used to silently
    # overwrite the timestamp) — colliding meta lands under a meta_ prefix
    for k, v in meta.items():
        ev[f"meta_{k}" if k in _RESERVED else k] = v
    with _LOCK:
        _RING.append(ev)


def events(n: Optional[int] = None) -> List[dict]:
    with _LOCK:
        evs = list(_RING)
    return evs[-n:] if n else evs


def clear() -> None:
    with _LOCK:
        _RING.clear()


# -- torch.profiler wiring: one capture at a time in the process. The
#    capture lives on a thread of its own, which enters, exits and
#    exports the profile: a REST server starts and stops it from two
#    different request threads, and the profiler must not be torn down on
#    another thread than the one that started it. ------------------------

_PROF_LOCK = threading.Lock()
_PROF: Dict = {"thread": None, "stop": None, "path": None, "error": None}


def _capture(path: str, started: threading.Event,
             stop: threading.Event) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            started.set()
            stop.wait()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
    except Exception as e:   # noqa: BLE001 — reported by profiler_stop
        _PROF["error"] = e
        started.set()


def profiler_start(log_dir: str) -> str:
    """Start a ``torch.profiler`` capture (CPU activities, and CUDA ones
    where there is a card); `profiler_stop` writes it as a Chrome trace,
    ``<log_dir>/trace.json``. Raises RuntimeError while a capture
    runs."""
    with _PROF_LOCK:
        if _PROF["thread"] is not None:
            raise RuntimeError("a profiler capture is already running")
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, "trace.json")
        started, stop = threading.Event(), threading.Event()
        t = threading.Thread(target=_capture, args=(path, started, stop),
                             name="h2o3-profiler", daemon=True)
        _PROF.update(thread=t, stop=stop, path=path, error=None)
        t.start()
        started.wait(timeout=60)
        if _PROF["error"] is not None:
            err = _PROF["error"]
            t.join(timeout=60)
            _PROF.update(thread=None, stop=None, path=None, error=None)
            raise RuntimeError(f"profiler did not start: {err}")
    return path


def profiler_stop() -> Optional[str]:
    """End the capture and write its Chrome trace; returns the trace's
    path (None when nothing was capturing)."""
    with _PROF_LOCK:
        t, stop, path = _PROF["thread"], _PROF["stop"], _PROF["path"]
        if t is None:
            return None
        stop.set()
        t.join(timeout=300)
        err = _PROF["error"]
        _PROF.update(thread=None, stop=None, path=None, error=None)
    if t.is_alive():
        raise RuntimeError("the profiler capture did not stop in 300 s")
    if err is not None:
        raise RuntimeError(f"profiler capture failed: {err}")
    return path


def device_memory() -> List[Dict]:
    """Per-device memory gauges from the caching allocator: bytes in
    use, the device's total memory, the peak since the last reset, and
    free bytes ``cudaMemGetInfo`` reports. Empty where there is no card."""
    import torch

    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({"device": f"cuda:{i}",
                    "name": torch.cuda.get_device_name(i),
                    "bytes_in_use": int(stats.get(
                        "allocated_bytes.all.current", 0)),
                    "bytes_limit": int(total),
                    "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                    "bytes_reserved": int(torch.cuda.memory_reserved(i)),
                    "bytes_free": int(free)})
    return out
