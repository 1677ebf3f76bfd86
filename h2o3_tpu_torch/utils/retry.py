"""Environment knobs and bounded exponential backoff (counterpart of
h2o3_tpu/parallel/retry.py `env_float` :25, `env_int` :34,
`backoff_delays` :58).

``H2O_TPU_RETRY_MAX`` attempts per call (default 3),
``H2O_TPU_RETRY_BASE_MS`` the first delay (default 10 ms) and
``H2O_TPU_RETRY_MAX_MS`` the cap (default 2000 ms).
"""

from __future__ import annotations

import os
import random
from typing import Iterator, Optional


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
