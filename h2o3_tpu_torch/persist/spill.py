"""Checksum-gated column spill: device -> host -> the persist cache
(counterpart of h2o3_tpu/persist/spill.py).

The cleaner (core/cleaner.py) moves cold columns from the device to
host memory; this is the next rung for frames several times the device
budget: a spilled column's host copy becomes an ``.npy`` file in the
persist cache directory, and the column reverts to a file-backed loader,
freeing host memory too.

- **sha256 gate**: the digest of the buffer's bytes is taken at spill
  time and checked at every reload; a torn write, a stale object or bit
  rot raises :class:`SpillCorrupt` instead of giving wrong predictions.
- **bounded reads**: reloads go through
  ``memory/stream.bounded_remote_read`` and its backoff budget.
"""

from __future__ import annotations

import hashlib
import io
import os
from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch import persist


class SpillCorrupt(Exception):
    """A spilled column failed its checksum gate (or vanished) on
    reload."""


def spill_dir() -> str:
    d = os.path.join(persist.cache_dir(), "spill")
    os.makedirs(d, exist_ok=True)
    return d


def spill_array(arr: np.ndarray, name: str) -> tuple:
    """Write one host buffer to the spill tier; returns (path, sha256).
    Content-addressed and written atomically (tmp + rename), so a
    crashed spill never leaves a half file a reload could trust."""
    buf = np.ascontiguousarray(arr)
    digest = hashlib.sha256(buf.tobytes()).hexdigest()
    path = os.path.join(spill_dir(), f"{name}_{digest[:16]}.npy")
    if not os.path.exists(path):
        tmp = f"{path}.part.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.save(f, buf, allow_pickle=False)
        os.replace(tmp, path)
    return path, digest


def loader_for(path: str, digest: str, what: str,
               dtype: Optional[torch.dtype] = None):
    """A Column loader (the file_backed contract: returns the column's
    tensor, here on the host) that reads through the bounded retry and
    the checksum gate; `dtype` bfloat16 views the spilled int16 bits
    back (numpy has no bfloat16)."""
    from h2o3_tpu_torch.memory import stream

    def _read() -> Optional[bytes]:
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            return None

    def load() -> torch.Tensor:
        raw = stream.bounded_remote_read(_read, what=what)
        if raw is None:
            raise SpillCorrupt(
                f"spilled column {what} missing at {path} after the "
                f"bounded retry budget")
        buf = np.load(io.BytesIO(raw), allow_pickle=False)
        got = hashlib.sha256(np.ascontiguousarray(buf).tobytes()).hexdigest()
        if got != digest:
            raise SpillCorrupt(
                f"spilled column {what} failed its checksum gate at "
                f"{path}: wrote sha256 {digest[:16]}…, read {got[:16]}…")
        t = torch.from_numpy(buf)
        return t.view(dtype) if dtype is not None else t

    return load


def spill_column(col, name: Optional[str] = None) -> int:
    """Evict `col` and push its host copy down to the spill tier; returns
    the bytes evicted. A file-backed column (whose eviction reverts to
    its own source) is left at that source."""
    from h2o3_tpu_torch.core import cleaner

    freed = int(col.evict())
    src = col._evicted
    if src is None or callable(src):
        return freed
    what = name or f"col{col._token}"
    # a bfloat16 column spills its bits as int16 (numpy has no bfloat16)
    half = src.dtype == torch.bfloat16
    path, digest = spill_array(
        (src.view(torch.int16) if half else src).numpy(), what)
    loader = loader_for(path, digest, what,
                        torch.bfloat16 if half else None)
    with cleaner.SWAP_LOCK:
        # only if the column still holds the host copy we spilled: a
        # racing fault-in keeps its device tensor
        if col._data is None and col._evicted is src:
            col._evicted = loader
            col._loader = loader
    return freed
