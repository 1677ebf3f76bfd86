"""Environment knobs, bounded retry with exponential backoff and jitter,
and adaptive polling (counterpart of h2o3_tpu/parallel/retry.py
`env_float` :25, `env_int` :34, `backoff_delays` :58, `retry_call` :78,
`AdaptivePoll` :111).

The control plane's store calls (KV puts and gets, oplog publishes,
follower polls) absorb transient faults with a small bounded budget, as
water/RPC.java resends on a doubling schedule; a real failure surfaces
after it instead of hanging or failing on the first blip.

``H2O_TPU_RETRY_MAX`` attempts per call (default 3),
``H2O_TPU_RETRY_BASE_MS`` the first delay (default 10 ms) and
``H2O_TPU_RETRY_MAX_MS`` the cap (default 2000 ms).
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type


def env_float(name: str, default: float) -> float:
    """Float env knob with fallback."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    """Integer env knob with fallback."""
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def max_attempts() -> int:
    return max(1, env_int("H2O_TPU_RETRY_MAX", 3))


def backoff_delays(attempts: Optional[int] = None,
                   base_s: Optional[float] = None,
                   max_s: Optional[float] = None,
                   jitter: float = 0.5, rng=None) -> Iterator[float]:
    """The ``attempts - 1`` sleeps between attempts: ``base * 2^i``
    capped at ``max_s``, each times a uniform ``1 ± jitter``."""
    attempts = max_attempts() if attempts is None else attempts
    base = (max(env_float("H2O_TPU_RETRY_BASE_MS", 10.0), 0.0) / 1000.0
            if base_s is None else base_s)
    cap = (max(env_float("H2O_TPU_RETRY_MAX_MS", 2000.0), 1.0) / 1000.0
           if max_s is None else max_s)
    rnd = rng or random
    for i in range(max(attempts - 1, 0)):
        d = min(base * (2.0 ** i), cap)
        if jitter > 0:
            d *= 1.0 + jitter * (2.0 * rnd.random() - 1.0)
        yield max(d, 0.0)


def retry_call(fn: Callable, *args,
               retries: Optional[int] = None,
               base_s: Optional[float] = None,
               max_s: Optional[float] = None,
               retry_on: Tuple[Type[BaseException], ...] = (Exception,),
               describe: str = "",
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               sleep: Callable[[float], None] = time.sleep,
               **kwargs):
    """``fn(*args, **kwargs)`` with bounded backoff-plus-jitter retries on
    ``retry_on``; the last attempt's exception propagates unwrapped."""
    attempts = max_attempts() if retries is None else max(1, retries)
    delays = backoff_delays(attempts, base_s, max_s)
    for attempt in range(1, attempts + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt >= attempts:
                raise
            if on_retry is not None:
                try:
                    on_retry(attempt, e)
                except Exception:   # noqa: BLE001 — an observer must not
                    pass            # end the loop it observes
            from h2o3_tpu_torch.utils.log import get_logger

            get_logger().warning("retrying %s (attempt %d/%d): %s",
                                 describe or getattr(fn, "__name__", "call"),
                                 attempt, attempts, e)
            sleep(next(delays))


class AdaptivePoll:
    """A busy-wait that starts hot (1 ms: a follower mid-stream sees the
    next op at once) and doubles to a cold cap (250 ms: an idle follower
    costs ~4 store reads a second). ``reset()`` on activity."""

    def __init__(self, min_s: float = 0.001, max_s: float = 0.25,
                 factor: float = 2.0,
                 sleep: Callable[[float], None] = time.sleep):
        self.min_s = float(min_s)
        self.max_s = float(max_s)
        self.factor = float(factor)
        self._sleep = sleep
        self._cur = self.min_s

    @property
    def current_s(self) -> float:
        return self._cur

    def wait(self) -> None:
        self._sleep(self._cur)
        self._cur = min(self._cur * self.factor, self.max_s)

    def reset(self) -> None:
        self._cur = self.min_s
