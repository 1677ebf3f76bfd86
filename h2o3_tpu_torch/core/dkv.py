"""DKV, the local half (counterpart of h2o3_tpu/core/dkv.py `Key` :25,
`_DKV` :36-77 and :235-255, `Scope` :265, `Keyed` :295).

One process holds frames and models by key: `DKV.put/get/remove`,
`atomic` updates under the store lock, per-key write locks, `Scope` for
keys that die with a block, and `Keyed`, the base of every object that
lives under a key. Big data stays in the objects' tensors; the store
holds references. The cross-process half of the reference (publish,
fetch_remote, control-plane snapshots) waits for multi-GPU work
(ROADMAP A14).
"""

from __future__ import annotations

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

    def unlock_all(self) -> int:
        """Drop every per-key lock object (water/api/UnlockTask); returns
        the count dropped."""
        with self._lock:
            n = len(self._rw)
            self._rw.clear()
            return n

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
        """Drop every per-key lock; returns how many were dropped."""
        with self._lock:
            n = len(self._rw)
            self._rw.clear()
            return n


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
