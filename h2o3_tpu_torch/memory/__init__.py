"""Memory-safe execution: a device byte budget and chunk-streamed
dispatch (counterpart of h2o3_tpu/memory/__init__.py).

- :mod:`budget` plans a dispatch against the bytes left on the device:
  ``H2O_TPU_MEM_BUDGET_MB`` when set, else the card's total memory,
  minus a headroom (``H2O_TPU_MEM_HEADROOM``) and the frames' column
  residency. ``plan(family, rows)`` is ``full``, ``chunked(C)`` or
  ``refuse``. The CPU is unbudgeted.
- :mod:`stream` runs a row-local program over planned windows and owns
  the degradation ladder: a window that raises
  ``torch.cuda.OutOfMemoryError`` (or trips the ``mem.exhausted`` fault
  point) has the cleaner sweep cold columns off the device, empties the
  allocator's cache, halves the window and retries under the bounded
  backoff; an exhausted ladder raises :class:`MemoryPressureError`.
"""

from __future__ import annotations


class MemoryPressureError(Exception):
    """Every retry at every window size still exhausted device memory.
    Carries the HTTP status (503: residency shrinks as frames unload) and
    a Retry-After hint, like ``admission.AdmissionRejected``."""

    def __init__(self, msg: str, retry_after_s: float = 5.0,
                 family: str = "", attempts=()):
        super().__init__(msg)
        self.status = 503
        self.retry_after_s = max(float(retry_after_s), 0.1)
        self.family = family
        self.attempts = tuple(attempts)


from h2o3_tpu_torch.memory import budget, stream  # noqa: E402,F401
