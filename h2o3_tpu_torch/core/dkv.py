"""DKV (counterpart of h2o3_tpu/core/dkv.py `Key` :25, `_DKV` :36-77,
`snapshot_control_plane`/`restore_control_plane` :179-233 and :235-255,
`Scope` :265, `Keyed` :295).

One process holds frames and models by key: `DKV.put/get/remove`,
`atomic` updates under the store lock, per-key write locks, `Scope` for
keys that die with a block, and `Keyed`, the base of every object that
lives under a key. Big data stays in the objects' tensors; the store
holds references. A control-plane checkpoint (parallel/ckpt.py) takes
`snapshot_control_plane`, and a rejoining process installs it with
`restore_control_plane`, its tensors on its own device.

The cross-process half (the reference's :81-177, water/DKV.java's
distributed half): `publish` announces a key cloud-wide in the cloud KV
(parallel/distributed.py) under ``h2o3/dkv/meta/{key}``, and with
``replicate=True`` also ships the pickled value (small host objects
only, at most `_MAX_BLOB` bytes, checked before the meta key is
written) under ``h2o3/dkv/blob/{key}``; `global_keys` lists the
announced keys with the local ones; `fetch_remote` returns a key from
the local store or from its replicated blob, through the restricted
unpickler, retrying only when the meta says a blob exists. A snapshot
carries both prefixes in its ``kv``, restored put-if-absent. Device
data never travels here: a sharded frame's rows stay on their ranks.
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

    # -- the cross-process half (water/DKV.java) ---------------------------
    _META_PREFIX = "h2o3/dkv/meta/"
    _BLOB_PREFIX = "h2o3/dkv/blob/"
    _MAX_BLOB = 8 * 1024 * 1024

    def publish(self, key: str, value: Any = None,
                replicate: bool = False) -> bool:
        """Announce a key cloud-wide; with `replicate` also ship the
        pickled value (small host objects only). False outside a cloud
        (no KV to announce into)."""
        import base64
        import json

        from h2o3_tpu_torch.parallel import distributed as D

        blob_b64 = None
        if replicate and value is not None:
            # the payload is checked BEFORE the key is announced: a meta
            # entry without its blob would be an unfetchable ghost
            from h2o3_tpu_torch.models.model import _ModelPickler

            buf = io.BytesIO()
            _ModelPickler(buf, protocol=4).dump(value)
            blob = buf.getvalue()
            if len(blob) > self._MAX_BLOB:
                raise ValueError(
                    f"object {key!r} is {len(blob)}B, too large for "
                    f"control-plane replication (cap {self._MAX_BLOB}B); "
                    "device data stays on its ranks, not in the KV")
            blob_b64 = base64.b64encode(blob).decode()
        meta = {"type": type(value).__name__ if value is not None else "?",
                "proc": D.process_index(),
                "replicated": blob_b64 is not None}
        if not D.kv_put(self._META_PREFIX + str(key), json.dumps(meta)):
            return False
        if blob_b64 is not None:
            D.kv_put(self._BLOB_PREFIX + str(key), blob_b64)
        return True

    def global_keys(self) -> List[str]:
        """The cloud's announced keys merged with this process's."""
        from h2o3_tpu_torch.parallel import distributed as D

        n = len(self._META_PREFIX)
        remote = [k[n:] for k, _v in D.kv_dir(self._META_PREFIX)]
        return sorted(set(self.keys()) | set(remote))

    def fetch_remote(self, key: str, timeout_ms: int = 5000) -> Any:
        """A key from anywhere in the cloud: the local store first, then
        its replicated blob (``publish(..., replicate=True)``), cached
        locally. A key announced without a blob returns None at once; a
        blob read that misses while the meta says it was replicated
        retries under the bounded remote read (memory/stream.py)."""
        local = self.get(key)
        if local is not None:
            return local
        import base64
        import json

        from h2o3_tpu_torch.parallel import distributed as D

        raw = D.kv_get(self._BLOB_PREFIX + str(key), timeout_ms)
        if raw is None:
            meta_raw = D.kv_try_get(self._META_PREFIX + str(key))
            try:
                replicated = bool(meta_raw is not None
                                  and json.loads(meta_raw).get("replicated"))
            except (ValueError, TypeError, AttributeError):
                replicated = False
            if replicated:
                from h2o3_tpu_torch.memory import stream as mstream

                raw = mstream.bounded_remote_read(
                    lambda: D.kv_get(self._BLOB_PREFIX + str(key),
                                     timeout_ms), what=f"DKV blob {key!r}")
        if raw is None:
            return None
        # the blob came over the cloud KV: untrusted input, read by the
        # restricted unpickler (the port's classes and numpy only)
        from h2o3_tpu_torch.utils.unpickle import restricted_loads

        value = restricted_loads(base64.b64decode(raw), what="DKV blob")
        self.put(key, value)            # cached locally, as Value caching
        return value

    # -- control-plane checkpoints (parallel/ckpt.py) ---------------------
    def snapshot_control_plane(self) -> dict:
        """Every DKV object that pickles (models, frames, job metadata),
        each pickled on its own with its tensors as numpy arrays, so one
        object that does not pickle cannot sink the checkpoint: it is
        listed in ``skipped``. ``kv`` holds the cloud KV's announced keys
        and replicated blobs. A row-sharded frame pickles this rank's
        rows: a rank restores its own rows from its own section
        (parallel/ckpt.py)."""
        from h2o3_tpu_torch.models.model import _ModelPickler

        objects: Dict[str, bytes] = {}
        skipped: List[str] = []
        sharded: List[str] = []
        with self._lock:
            items = list(self._store.items())
        for k, v in items:
            if getattr(v, "shard", None) is not None:
                sharded.append(k)
            buf = io.BytesIO()
            try:
                _ModelPickler(buf, protocol=4).dump(v)
            except Exception:   # noqa: BLE001 — per-key isolation
                skipped.append(k)
                continue
            objects[k] = buf.getvalue()
        from h2o3_tpu_torch.parallel import distributed as D

        kv: Dict[str, str] = {}
        for prefix in (self._META_PREFIX, self._BLOB_PREFIX):
            for kk, vv in D.kv_dir(prefix):
                kv[kk] = vv
        return {"objects": objects, "skipped": sorted(skipped), "kv": kv,
                "sharded": sorted(sharded)}

    def sharded_objects(self) -> Dict[str, bytes]:
        """This rank's row-sharded frames, pickled (a rank's section of a
        control-plane checkpoint)."""
        from h2o3_tpu_torch.models.model import _ModelPickler

        out: Dict[str, bytes] = {}
        with self._lock:
            items = list(self._store.items())
        for k, v in items:
            if getattr(v, "shard", None) is None:
                continue
            buf = io.BytesIO()
            try:
                _ModelPickler(buf, protocol=4).dump(v)
            except Exception:   # noqa: BLE001 — per-key isolation
                continue
            out[k] = buf.getvalue()
        return out

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
