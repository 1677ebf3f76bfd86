"""Per-device byte budget: plan a dispatch before it runs out of memory
(counterpart of h2o3_tpu/memory/budget.py).

- **budget**: ``H2O_TPU_MEM_BUDGET_MB`` when set (the operator's word,
  and how tests pin a tiny budget to force the chunked paths); else the
  card's total memory (``torch.cuda.mem_get_info``). A runtime booted on
  the CPU, or not booted, is unbudgeted: every plan is ``full``.
- **headroom**: ``H2O_TPU_MEM_HEADROOM`` (default 0.15), the fraction
  of the budget never handed out (allocator slop, other tensors).
- **residency**: device bytes of frame columns
  (``core/cleaner.device_bytes_in_use``). Forest arrays, CUDA-graph
  pools and model tensors are outside it, as the reference's ledger
  leaves program buffers out; the ladder in :mod:`stream` absorbs what
  the plan misses.
- **bytes/row**: per program family, the larger of the caller's static
  hint and what was measured: a scoring session reports the rise of
  ``torch.cuda.max_memory_allocated`` over a bucket's first (eager) run
  divided by the bucket's rows (`note_compiled`). Programs over
  bfloat16 rows are a family of their own (`family_key`), measured on
  their own runs.

An exhausted ladder calls :func:`note_pressure`; admission sheds with
503 + Retry-After for ``H2O_TPU_MEM_PRESSURE_COOLDOWN_S`` seconds.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from h2o3_tpu_torch.utils.retry import env_float

# never plan below this many free bytes: a degenerate budget must not
# refuse 1-row windows forever
_MIN_PLAN_BYTES = 64 * 1024

_LOCK = threading.Lock()
_ROW_BYTES: Dict[str, float] = {}     # family -> max measured bytes/row
_PRESSURE_TS = 0.0
_PRESSURE_COUNT = 0


def budget_mb() -> float:
    """``H2O_TPU_MEM_BUDGET_MB`` (0 or unset: the device's own)."""
    return max(env_float("H2O_TPU_MEM_BUDGET_MB", 0.0), 0.0)


def headroom() -> float:
    """``H2O_TPU_MEM_HEADROOM``, default 0.15, clamped to [0, 0.9]."""
    return min(max(env_float("H2O_TPU_MEM_HEADROOM", 0.15), 0.0), 0.9)


def pressure_cooldown_s() -> float:
    """``H2O_TPU_MEM_PRESSURE_COOLDOWN_S``, default 10."""
    return max(env_float("H2O_TPU_MEM_PRESSURE_COOLDOWN_S", 10.0), 0.0)


_TOTAL_BYTES: Dict[object, int] = {}


def _device_budget_bytes() -> Optional[int]:
    """The booted card's total memory; None on the CPU or before boot
    (planning never boots the runtime). Read once per device: the query
    (cudaMemGetInfo) costs ~1 ms of host, and every dispatch plans."""
    from h2o3_tpu_torch.core import runtime

    cl = runtime._CLUSTER
    if cl is None or cl.device.type != "cuda":
        return None
    total = _TOTAL_BYTES.get(cl.device)
    if total is None:
        import torch

        total = _TOTAL_BYTES[cl.device] = int(
            torch.cuda.mem_get_info(cl.device)[1])
    return total


def budget_bytes() -> Optional[int]:
    """Effective budget in bytes; None = unbudgeted."""
    mb = budget_mb()
    if mb > 0:
        return int(mb * (1 << 20))
    return _device_budget_bytes()


def live_bytes() -> int:
    """Device bytes held by frame columns (the cleaner's scan)."""
    from h2o3_tpu_torch.core import cleaner

    return int(cleaner.device_bytes_in_use())


def family_key(family: str, dtype) -> str:
    """The planner's family for programs over rows of `dtype`: the
    family itself for float32, ``family/<dtype>`` otherwise."""
    name = str(dtype).replace("torch.", "")
    return family if name == "float32" else f"{family}/{name}"


def note_compiled(family: str, rows: int,
                  measured_bytes: Optional[int]) -> None:
    """Raise the family's bytes/row estimate to `measured_bytes / rows`
    (the peak-allocation rise over a program's first run); None, as on
    the CPU, keeps the static hints."""
    if rows <= 0 or not measured_bytes or measured_bytes <= 0:
        return
    per_row = float(measured_bytes) / float(rows)
    with _LOCK:
        if per_row > _ROW_BYTES.get(family, 0.0):
            _ROW_BYTES[family] = per_row


def row_bytes_estimate(family: str, hint: Optional[float] = None) -> float:
    """The larger of the measured and the hinted bytes/row, floored at
    one float32 lane."""
    with _LOCK:
        seen = _ROW_BYTES.get(family, 0.0)
    return max(seen, float(hint or 0.0), 4.0)


class Plan:
    """``mode`` is ``full``, ``chunked`` (windows of ``chunk_rows``) or
    ``refuse`` (not one row fits)."""

    __slots__ = ("mode", "chunk_rows", "rows", "row_bytes", "free_bytes")

    def __init__(self, mode: str, chunk_rows: int, rows: int,
                 row_bytes: float, free_bytes: Optional[int]):
        self.mode = mode
        self.chunk_rows = int(chunk_rows)
        self.rows = int(rows)
        self.row_bytes = float(row_bytes)
        self.free_bytes = free_bytes

    def __repr__(self) -> str:
        return (f"<memory.Plan {self.mode} rows={self.rows} "
                f"chunk={self.chunk_rows} row_bytes={self.row_bytes:.1f}>")


def free_bytes() -> Optional[int]:
    """Budget minus headroom minus residency; None when unbudgeted."""
    total = budget_bytes()
    if total is None:
        return None
    return max(int(total * (1.0 - headroom())) - live_bytes(), 0)


def plan(family: str, rows: int, row_bytes: Optional[float] = None) -> Plan:
    """Budget `rows` rows of `family` against the free bytes now."""
    per_row = row_bytes_estimate(family, row_bytes)
    free = free_bytes()
    if free is None or rows <= 0:
        return Plan("full", max(rows, 0), rows, per_row, free)
    fit = int(max(free, _MIN_PLAN_BYTES) // per_row)
    if fit >= rows:
        return Plan("full", rows, rows, per_row, free)
    if fit < 1:
        return Plan("refuse", 0, rows, per_row, free)
    return Plan("chunked", fit, rows, per_row, free)


def note_pressure() -> None:
    """Record one exhausted ladder; admission sheds for the cooldown."""
    global _PRESSURE_TS, _PRESSURE_COUNT
    with _LOCK:
        _PRESSURE_TS = time.monotonic()
        _PRESSURE_COUNT += 1


def pressure_active() -> bool:
    with _LOCK:
        ts = _PRESSURE_TS
    return bool(ts) and (time.monotonic() - ts) < pressure_cooldown_s()


def pressure_retry_after_s() -> float:
    """The rest of the cooldown, floored at 1 s."""
    with _LOCK:
        ts = _PRESSURE_TS
    if not ts:
        return 1.0
    return max(pressure_cooldown_s() - (time.monotonic() - ts), 1.0)


def pressure_count() -> int:
    with _LOCK:
        return _PRESSURE_COUNT


def reset_pressure() -> None:
    global _PRESSURE_TS, _PRESSURE_COUNT
    with _LOCK:
        _PRESSURE_TS = 0.0
        _PRESSURE_COUNT = 0


def reset_estimates() -> None:
    """Drop the measured bytes/row (tests)."""
    with _LOCK:
        _ROW_BYTES.clear()


def snapshot() -> dict:
    """Budget, residency, estimates, ladder counters and pressure."""
    from h2o3_tpu_torch.core import cleaner
    from h2o3_tpu_torch.memory import stream

    with _LOCK:
        est = dict(_ROW_BYTES)
    return {"budget_bytes": budget_bytes(), "headroom": headroom(),
            "free_bytes": free_bytes(), "live_bytes": live_bytes(),
            "evicted_columns": int(cleaner.evicted_count()),
            "row_bytes_estimates": {k: round(v, 2)
                                    for k, v in sorted(est.items())},
            "pressure_active": pressure_active(),
            "pressure_count": pressure_count(),
            "stream": stream.counters()}
