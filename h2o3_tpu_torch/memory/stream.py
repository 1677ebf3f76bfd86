"""Chunk-streamed dispatch: the one chokepoint of the memory ladder
(counterpart of h2o3_tpu/memory/stream.py: `is_oom` :68,
`run_windows` :92, `_fail_pressure` :185, `bounded_remote_read` :213).

:func:`run_windows` drives a row-local program over row windows. The
caller supplies ``dispatch(pos, m) -> device output`` and optionally
``fetch(out, m)``; run_windows owns

- **planning**: the first window comes from ``budget.plan``; an
  unbudgeted process runs full-size windows;
- **double buffering**: window i+1 is dispatched before window i's
  output is fetched. Host-resident input goes through
  :class:`HostStager`, which copies window i+1 from pinned memory on a
  side stream, ordered by an event, while window i computes;
- **the degradation ladder**: a window whose dispatch or fetch raises
  ``torch.cuda.OutOfMemoryError``, or trips the ``mem.exhausted`` fault
  point, has the cleaner sweep cold columns off the device, then
  ``torch.cuda.empty_cache()`` hands the freed blocks back, the window
  halves (snapped onto the caller's sizes) and runs again from its own
  start row, under the bounded backoff of ``utils/retry``. Only an
  exhausted ladder raises :class:`MemoryPressureError`, after a flight
  record and the pressure flag that admission sheds on. Any other error
  propagates.

Bitwise contract: run_windows changes how many rows ride each dispatch,
never what a row computes, so the windows' outputs concatenate to the
single-dispatch output exactly.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.memory import MemoryPressureError, budget
from h2o3_tpu_torch.utils import retry

_LOCK = threading.Lock()
_COUNTS = {"chunked_runs": 0,        # run_windows calls that windowed
           "windows": 0,             # windows dispatched (all runs)
           "ladder_halvings": 0,     # OOM-triggered window halvings
           "ladder_recoveries": 0,   # runs that hit OOM and completed
           "pressure_failures": 0,   # exhausted ladders
           "spill_retries": 0}       # bounded remote-read retries
# the last exhausted ladders: family, rows, the window sizes tried
_FLIGHT: "collections.deque[dict]" = collections.deque(maxlen=32)


def _bump(key: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[key] += n


def counters() -> dict:
    with _LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    with _LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0


def flight_records() -> List[dict]:
    """The flight records of the last exhausted ladders, oldest first."""
    with _LOCK:
        return list(_FLIGHT)


def is_oom(exc: BaseException) -> bool:
    """Does this exception mean the device ran out of memory?"""
    from h2o3_tpu_torch.core.failure import InjectedFault

    if isinstance(exc, InjectedFault):
        return "mem.exhausted" in str(exc)
    return isinstance(exc, torch.cuda.OutOfMemoryError)


def _sweep_cold(need_bytes: int) -> int:
    """The ladder's first rung: evict cold columns, then return the
    allocator's cached blocks to the device (otherwise the caching
    allocator keeps the freed blocks to itself)."""
    from h2o3_tpu_torch.core import cleaner

    freed = int(cleaner.sweep(max(int(need_bytes), 1 << 20)))
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return freed


class HostStager:
    """Windows of a host (n, F) float32 matrix as device tensors. On
    CUDA each window is copied from one of two pinned buffers on a side
    stream; the current stream waits on the copy's event, and a pinned
    buffer is refilled only after its previous copy's event completed."""

    def __init__(self, X: np.ndarray, device, max_rows: int):
        self.X = np.ascontiguousarray(X, np.float32)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            rows, F = max(int(max_rows), 1), self.X.shape[1]
            self.side = torch.cuda.Stream(self.device)
            self.pinned = [torch.empty((rows, F), dtype=torch.float32,
                                       pin_memory=True) for _ in range(2)]
            self.events: List[Optional[torch.cuda.Event]] = [None, None]
            self.turn = 0

    def stage(self, pos: int, m: int) -> torch.Tensor:
        """Rows [pos, pos + m) on the device, ready on the current
        stream."""
        rows = self.X[pos: pos + m]
        if not self.cuda:
            return torch.from_numpy(rows).to(self.device)
        j, self.turn = self.turn, self.turn ^ 1
        if self.events[j] is not None:
            self.events[j].synchronize()
        buf = self.pinned[j][:m]
        buf.numpy()[:] = rows
        cur = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.side):
            dst = torch.empty(rows.shape, dtype=torch.float32,
                              device=self.device)
            dst.copy_(buf, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.side)
        self.events[j] = ev
        cur.wait_event(ev)
        dst.record_stream(cur)
        return dst


def run_windows(family: str, n: int, dispatch: Callable[[int, int], Any],
                max_window: int,
                fetch: Optional[Callable[[Any, int], Any]] = None,
                row_bytes: Optional[float] = None,
                window_sizer: Optional[Callable[[int], int]] = None
                ) -> List[Any]:
    """Run `dispatch` over `n` rows in planned windows; returns the
    (fetched) window outputs in row order. `max_window` is the caller's
    dispatch ceiling (its largest row bucket); `window_sizer` snaps a
    window down onto sizes the caller has programs for."""
    from h2o3_tpu_torch.core import failure

    if n <= 0:
        return []
    decision = budget.plan(family, n, row_bytes)
    if decision.mode == "refuse":
        _fail_pressure(family, n, [], decision)
    win = max_window
    if decision.mode == "chunked":
        win = max(min(max_window, decision.chunk_rows), 1)
        _bump("chunked_runs")
    if window_sizer is not None:
        win = max(window_sizer(win), 1)

    pieces: List[Any] = []
    attempts: List[int] = []            # window sizes that ran out
    delays = None                       # the bounded backoff, armed lazily
    pending: Optional[tuple] = None     # (out, pos, m) awaiting fetch
    saw_oom = False
    pos = 0
    while pos < n or pending is not None:
        try:
            if pos < n:
                m = min(win, n - pos)
                failure.faultpoint("mem.exhausted")
                out = dispatch(pos, m)
                _bump("windows")
            else:
                m = 0
                out = None
            # double buffer: window i+1 is in flight; now block on i
            if pending is not None:
                p_out, _p_pos, p_m = pending
                pieces.append(p_out if fetch is None else fetch(p_out, p_m))
                pending = None
            if out is not None:
                if fetch is None:
                    pieces.append(out)
                else:
                    pending = (out, pos, m)
                pos += m
        except Exception as e:   # noqa: BLE001 — only OOM walks the ladder
            if not is_oom(e):
                raise
            saw_oom = True
            # the window to retry: the failed dispatch's own, or the
            # pending one whose fetch surfaced the exhaustion
            if pending is not None:
                pos = pending[1]
                pending = None
            attempts.append(min(win, max(n - pos, 1)))
            if delays is None:
                delays = retry.backoff_delays()
            delay = next(delays, None)
            if delay is None:
                _fail_pressure(family, n, attempts, decision, cause=e)
            _sweep_cold(int(win * decision.row_bytes))
            if win > 1:
                win = max(win // 2, 1)
                if window_sizer is not None:
                    win = max(window_sizer(win), 1)
                _bump("ladder_halvings")
            time.sleep(delay)
    if saw_oom:
        _bump("ladder_recoveries")
    return pieces


def _fail_pressure(family: str, rows: int, attempts: List[int],
                   decision, cause: Optional[BaseException] = None):
    """Exhausted ladder: flight record, pressure flag, typed error."""
    from h2o3_tpu_torch.utils.log import get_logger

    _bump("pressure_failures")
    budget.note_pressure()
    rec = {"event": "mem_pressure", "ts": time.time(), "family": family,
           "rows": int(rows), "chunk_attempts": [int(a) for a in attempts],
           "budget_bytes": decision.free_bytes,
           "row_bytes": decision.row_bytes,
           "cause": repr(cause) if cause is not None else None}
    with _LOCK:
        _FLIGHT.append(rec)
    get_logger().warning("memory ladder exhausted: %s", rec)
    tried = ", ".join(str(a) for a in attempts) or "none"
    raise MemoryPressureError(
        f"device memory exhausted dispatching {family!r} over {rows} "
        f"rows; degradation ladder tried windows of [{tried}] rows "
        f"without fitting — retry when resident frames unload",
        retry_after_s=budget.pressure_retry_after_s(),
        family=family, attempts=attempts) from cause


def bounded_remote_read(fn: Callable[[], Any], what: str):
    """One retry discipline for reads that stand between a dispatch and
    its data (spill reloads): `fn` returns None on a miss; misses retry
    under the bounded backoff, counted in ``spill_retries``. The last
    attempt's result is the caller's to handle."""
    from h2o3_tpu_torch.utils.log import get_logger

    result = fn()
    if result is not None:
        return result
    for delay in retry.backoff_delays():
        _bump("spill_retries")
        get_logger().warning("retrying remote read of %s in %.0f ms",
                             what, delay * 1000.0)
        time.sleep(delay)
        result = fn()
        if result is not None:
            return result
    return result
