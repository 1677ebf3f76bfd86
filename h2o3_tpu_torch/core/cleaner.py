"""Cleaner: device-memory relief by evicting cold columns to host memory
(counterpart of h2o3_tpu/core/cleaner.py; water/Cleaner.java:12).

Every `Column.data` access stamps a monotonic LRU clock; `sweep` walks
the DKV's frames coldest first and calls `Column.evict` (device tensor
to a host copy, or back to a file source) until the requested bytes are
freed. Access after eviction faults the column back in. `Cleaner` is the
background mode: a thread that keeps column residency under a limit.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

_CLOCK = 0
# serializes evict against fault-in (not the hot read path)
SWAP_LOCK = threading.Lock()


def tick() -> int:
    """LRU stamp. Unlocked on purpose: it sits on every Column.data
    access, and an approximate order is all an LRU needs."""
    global _CLOCK
    _CLOCK += 1
    return _CLOCK


def _all_columns() -> List[Tuple[int, object]]:
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.core.frame import Frame

    out: List[Tuple[int, object]] = []
    for k in DKV.keys():
        fr = DKV.get(k)
        if isinstance(fr, Frame):
            for c in fr._cols.values():     # not .col(): no LRU touch
                out.append((c._touch, c))
    return out


def device_bytes_in_use() -> int:
    return sum(c.device_nbytes for _, c in _all_columns())


def sweep(target_free_bytes: int) -> int:
    """Evict the coldest columns until `target_free_bytes` are freed (or
    nothing evictable remains); returns the bytes freed."""
    freed = 0
    for _, c in sorted(_all_columns(), key=lambda tc: tc[0]):
        if freed >= target_free_bytes:
            break
        freed += c.evict()
    return freed


def evicted_count() -> int:
    return sum(1 for _, c in _all_columns() if c.is_evicted)


class Cleaner:
    """Background sweeper keeping column residency under `limit_bytes`
    (water/Cleaner.java's run loop)."""

    def __init__(self, limit_bytes: int, interval_s: float = 5.0):
        self.limit = int(limit_bytes)
        self.interval = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Cleaner":
        def run():
            while not self._stop.wait(self.interval):
                used = device_bytes_in_use()
                if used > self.limit:
                    sweep(used - self.limit)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="h2o3-cleaner")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.interval + 1)
