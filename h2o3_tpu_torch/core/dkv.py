"""DKV (counterpart of h2o3_tpu/core/dkv.py `Key` :25, `_DKV` :36-77,
`snapshot_control_plane`/`restore_control_plane` :179-233 and :235-255,
`Scope` :265, `Keyed` :295).

One process holds frames and models by key: `DKV.put/get/remove`,
`atomic` updates under the store lock, per-key write locks, `Scope` for
keys that die with a block, and `Keyed`, the base of every object that
lives under a key. Big data stays in the objects' tensors; the store
holds references. A control-plane checkpoint (parallel/ckpt.py) takes
`snapshot_control_plane`, and a rejoining process installs it with
`restore_control_plane`, its tensors on its own device. The reference's
publish/fetch_remote of announced keys is ROADMAP A14.5.
"""

from __future__ import annotations

import io
import random
import threading
from typing import Any, Callable, Dict, List, Optional


# 48 random bits a key, as the reference's uuid4 prefix has, from one
# generator seeded once: every temporary frame takes a key, and uuid4
# per key took a quarter of an eager Rapids pass's host time under
# cProfile on the card's machine (PERF.md §5)
_KEY_BITS = random.Random()


class Key(str):
    """A DKV key: a unique name."""

    __slots__ = ()

    @staticmethod
    def make(prefix: str = "key") -> "Key":
        return Key(f"{prefix}_{_KEY_BITS.getrandbits(48):012x}")


class _DKV:
    def __init__(self) -> None:
        self._store: Dict[str, Any] = {}
        self._lock = threading.RLock()
        self._rw: Dict[str, threading.RLock] = {}

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            self._store[str(key)] = value
            Scope._track(str(key))

    def get(self, key: str) -> Any:
        with self._lock:
            return self._store.get(str(key))

    def remove(self, key: str) -> None:
        with self._lock:
            self._store.pop(str(key), None)
            self._rw.pop(str(key), None)

    def contains(self, key: str) -> bool:
        with self._lock:
            return str(key) in self._store

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._store.keys())

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self._rw.clear()

    def atomic(self, key: str, fn: Callable[[Any], Any]) -> Any:
        """Replace the value under `key` by fn(old) under the store lock
        (water/TAtomic.java)."""
        with self._lock:
            new = fn(self._store.get(str(key)))
            self._store[str(key)] = new
            return new

    def write_lock(self, key: str) -> threading.RLock:
        """The per-key lock (water/Lockable.java write_lock)."""
        with self._lock:
            return self._rw.setdefault(str(key), threading.RLock())

    def unlock_all(self) -> int:
        """Drop every per-key lock object (water/api/UnlockTask: force-
        unlock all Lockables after a failed job). Returns count dropped."""
        with self._lock:
            n = len(self._rw)
            self._rw.clear()
            return n

    # -- control-plane checkpoints (parallel/ckpt.py) ---------------------
    def snapshot_control_plane(self) -> dict:
        """Every DKV object that pickles (models, frames, job metadata),
        each pickled on its own with its tensors as numpy arrays, so one
        object that does not pickle cannot sink the checkpoint: it is
        listed in ``skipped``."""
        from h2o3_tpu_torch.models.model import _ModelPickler

        objects: Dict[str, bytes] = {}
        skipped: List[str] = []
        with self._lock:
            items = list(self._store.items())
        for k, v in items:
            buf = io.BytesIO()
            try:
                _ModelPickler(buf, protocol=4).dump(v)
            except Exception:   # noqa: BLE001 — per-key isolation
                skipped.append(k)
                continue
            objects[k] = buf.getvalue()
        return {"objects": objects, "skipped": sorted(skipped), "kv": {}}

    def restore_control_plane(self, snap: dict, loads=None,
                              device=None) -> List[str]:
        """Install a snapshot in this process's store (a rejoin or a
        standby takeover), its tensors on `device` (default: this
        process's runtime device, never the writer's). `loads` defaults
        to the restricted loader: a snapshot came off shared storage.
        Returns the keys restored; a key that fails is skipped (the
        oplog suffix or a re-import rebuilds it). The snapshot's KV
        entries are put only where the KV lost them (first writer wins:
        the live cloud's copy is at least as new)."""
        from h2o3_tpu_torch.models.model import load_device
        from h2o3_tpu_torch.parallel import distributed as D
        from h2o3_tpu_torch.utils.unpickle import restricted_loads

        if device is None:
            from h2o3_tpu_torch.core.runtime import cluster

            device = cluster().device
        loads = loads or (lambda b: restricted_loads(b, what="checkpoint"))
        restored: List[str] = []
        with load_device(device):
            for k, blob in (snap.get("objects") or {}).items():
                try:
                    value = loads(blob)
                except Exception:   # noqa: BLE001 — per-key isolation
                    continue
                self.put(k, value)
                restored.append(k)
        for kk, vv in (snap.get("kv") or {}).items():
            D.kv_put_if_absent(kk, vv)
        return restored


DKV = _DKV()



def unlock_all() -> int:
    return DKV.unlock_all()


class Scope:
    """Keys put while a scope is open are removed when it exits, unless
    untracked (water/Scope.java)."""

    _stack: List[set] = []
    _slock = threading.RLock()

    def __init__(self) -> None:
        self._keys: set = set()

    def __enter__(self) -> "Scope":
        with Scope._slock:
            Scope._stack.append(self._keys)
        return self

    def __exit__(self, *exc) -> None:
        with Scope._slock:
            Scope._stack.remove(self._keys)
        for k in self._keys:
            DKV.remove(k)

    @classmethod
    def _track(cls, key: str) -> None:
        with cls._slock:
            if cls._stack:
                cls._stack[-1].add(key)

    def untrack(self, key: str) -> None:
        self._keys.discard(str(key))


class Keyed:
    """Base of the objects that live under a key (water/Keyed.java)."""

    def __init__(self, key: Optional[str] = None):
        self._key: Key = Key(key) if key else Key.make(type(self).__name__)

    @property
    def key(self) -> Key:
        return self._key

    def install(self) -> "Keyed":
        DKV.put(self._key, self)
        return self

    def delete(self) -> None:
        DKV.remove(self._key)
