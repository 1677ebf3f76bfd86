"""Program counters and the persistent export cache (counterpart of
h2o3_tpu/artifact/compile_cache.py).

Counters: `note_compile` counts one program build, a scoring session's
CUDA-graph capture or an artifact's export, with its milliseconds;
`fused_compile_count`, `stats` and `reset_stats` read and zero them.

Disk tier: under ``$H2O_TPU_COMPILE_CACHE_DIR`` the exported ``.pt2``
programs are kept by ``cache_key(model checksum, bucket, variant,
backend fingerprint)``, so a second export of the same model on the same
backend is a load. Writes are atomic (tmp + rename). A cached blob that
does not load as an ExportedProgram counts as a miss and is exported
again. Unset, the disk tier is off.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Optional

_LOCK = threading.Lock()
_STATS = {"compiles": 0, "disk_hits": 0, "disk_misses": 0, "stores": 0,
          "load_failures": 0, "compile_ms_total": 0.0}


def cache_dir() -> Optional[str]:
    """Cache root (``H2O_TPU_COMPILE_CACHE_DIR``); None disables it."""
    d = os.environ.get("H2O_TPU_COMPILE_CACHE_DIR", "").strip()
    return d or None


def enabled() -> bool:
    return cache_dir() is not None


def cache_key(model_checksum: str, bucket: int, variant: str = "artifact",
              fingerprint: Optional[str] = None) -> str:
    """Filename-safe key; `variant` separates program families built
    from one model (forest scoring, GLM scoring)."""
    if fingerprint is None:
        from h2o3_tpu_torch.artifact import aot

        fingerprint = aot.backend_fingerprint()
    raw = f"{model_checksum}|b{int(bucket)}|{variant}|{fingerprint}"
    return hashlib.sha256(raw.encode()).hexdigest()


def _path(key: str) -> Optional[str]:
    d = cache_dir()
    if d is None:
        return None
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"xp_{key}.pt2")


def load(key: str) -> Optional[bytes]:
    """The cached program bytes for `key`, or None (disabled, missing, or
    not a loadable ExportedProgram)."""
    path = _path(key)
    if path is None:
        return None
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        with _LOCK:
            _STATS["disk_misses"] += 1
        return None
    from h2o3_tpu_torch.artifact import aot

    try:
        aot.load_program(blob)
    except Exception:   # noqa: BLE001 — any unloadable blob is a miss
        with _LOCK:
            _STATS["load_failures"] += 1
        return None
    with _LOCK:
        _STATS["disk_hits"] += 1
    return blob


def store(key: str, blob: bytes) -> bool:
    """Atomic write; False when the disk tier is off."""
    path = _path(key)
    if path is None:
        return False
    tmp = f"{path}.{os.getpid()}.part"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    with _LOCK:
        _STATS["stores"] += 1
    return True


def note_compile(ms: float = 0.0) -> None:
    """Record one program build (a capture or an export)."""
    with _LOCK:
        _STATS["compiles"] += 1
        _STATS["compile_ms_total"] += float(ms)


def fused_compile_count() -> int:
    with _LOCK:
        return _STATS["compiles"]


def stats() -> dict:
    with _LOCK:
        out = dict(_STATS)
    out["dir"] = cache_dir()
    out["enabled"] = enabled()
    return out


def reset_stats() -> None:
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0
