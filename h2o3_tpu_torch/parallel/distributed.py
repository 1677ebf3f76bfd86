"""Process topology, leadership and the cloud key/value store
(counterpart of h2o3_tpu/parallel/distributed.py).

`initialize(coordinator_address, num_processes, process_id)` joins a
cloud of processes over a ``torch.distributed.TCPStore`` that process 0
hosts, as the reference's process 0 hosts the JAX coordination service.
It reads ``H2O_TPU_COORDINATOR`` (``host:port``),
``H2O_TPU_NUM_PROCESSES`` and ``H2O_TPU_PROCESS_ID`` when not given, and
is a no-op without an address (one process is the whole cloud). A caller
that already holds a store passes it as ``store=``, as
``torch.distributed.init_process_group(store=)`` takes one. A cloud of
more than one process is also a row mesh (parallel/mesh.py): every
process is a rank holding its block of every frame's rows, and its
process group is built over this store, through a ``PrefixStore`` per
mesh generation, at the first collective. `rejoin` and a takeover move
the generation on, so every live rank builds the next group.

The KV keeps the reference's semantics: `kv_put` upserts with a bounded
backoff-with-jitter retry; `kv_get` waits up to its deadline and does
not retry a plain expiry; `kv_try_get` never blocks; `kv_dir` lists a
prefix. On the store:

- an absent key's ``get`` blocks for the store's whole timeout, so every
  read here is ``compare_set(key, ABSENT, ABSENT)``: an atomic,
  non-blocking read that returns the sentinel for an absent key and
  writes nothing (the sentinel is never stored);
- ``list_keys`` is missing from some releases, so `kv_dir` reads a key
  index kept with ``append`` (one name a line, appended when a put
  creates a key) and checks each name it lists; `kv_delete` compacts the
  index with ``compare_set`` every `_COMPACT_EVERY` deletes;
- `kv_put_if_absent` and `write_epoch_record(expect=...)` are
  ``compare_set``: the first writer wins.

`memory_kv()` installs a dict in place of the store, so the supervision
tier drives publish, replay, acks, errors and heartbeats in one
process.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from h2o3_tpu_torch.utils import retry

# what initialize recorded: this process's index, the cloud's size and
# the store (None: one process, local mode)
_PROC = 0
_NPROC = 1
_STORE = None

# process-local view of who leads: proc index, and the epoch it was
# learned under (epoch 0 / leader 0 is the boot default: process 0 hosts
# the store, so it is the natural first leader)
_LEADER = 0
_EPOCH = 0

_EPOCH_KEY = "oplog/epoch"

# the store's key index and the read sentinel (never stored)
_INDEX_KEY = "h2o3/kv_index"
_ABSENT = b"\x00h2o3-absent\x00"
_COMPACT_EVERY = 256
_DELETES = 0
_INDEX_LOCK = threading.Lock()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               store=None, timeout_s: float = 60.0) -> None:
    """Join the multi-process cloud. No-op without an address or store."""
    global _PROC, _NPROC, _STORE
    coordinator_address = coordinator_address or os.environ.get(
        "H2O_TPU_COORDINATOR")
    if store is None and not coordinator_address:
        return
    n = int(num_processes if num_processes is not None
            else os.environ.get("H2O_TPU_NUM_PROCESSES", 1))
    pid = int(process_id if process_id is not None
              else os.environ.get("H2O_TPU_PROCESS_ID", 0))
    if not 0 <= pid < n:
        raise ValueError(f"process_id {pid} outside a cloud of {n}")
    if store is None:
        import torch.distributed as dist

        from h2o3_tpu_torch.obs import phases

        host, _, port = str(coordinator_address).rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"coordinator address {coordinator_address!r} "
                             "is not host:port")
        with phases.enter("cloud_form", processes=n):
            store = dist.TCPStore(
                host, int(port), n, pid == 0,
                timeout=datetime.timedelta(seconds=timeout_s),
                wait_for_workers=False)
    _STORE = store
    _PROC, _NPROC = pid, n
    from h2o3_tpu_torch.core import runtime
    from h2o3_tpu_torch.utils import timeline

    timeline.record("cloud", "initialize", proc=pid, processes=n)
    if runtime._CLUSTER is not None:
        ensure_mesh(runtime._CLUSTER.device)


def ensure_mesh(device):
    """The process's row mesh on `device` for a cloud of more than one
    process (None in one process); built once, on the first call after
    `initialize` (the runtime's boot makes it)."""
    from h2o3_tpu_torch.parallel import mesh

    m = mesh._PROCESS_MESH
    if _STORE is None or _NPROC <= 1:
        return None
    if m is None or m.store is not _STORE:
        m = mesh.RowMesh(_PROC, _NPROC, device, _STORE)
        mesh.install(m)
    return m


def next_mesh_generation() -> None:
    """Move the recorded mesh generation on (a rejoin, a takeover): each
    live rank builds the next group at its next collective."""
    from h2o3_tpu_torch.parallel import mesh

    m = mesh._PROCESS_MESH
    if m is not None:
        m.advance_generation()


def shutdown() -> None:
    """Leave the cloud: back to one process (tests, orderly exit)."""
    global _PROC, _NPROC, _STORE
    from h2o3_tpu_torch.parallel import mesh

    mesh.install(None)
    _STORE = None
    _PROC, _NPROC = 0, 1
    reset_leadership()


def process_count() -> int:
    return _NPROC


def process_index() -> int:
    return _PROC


# ---------------------------------------------------------------------------
# leadership (water/Paxos.java: the leader is the lowest live node; here
# the epoch record in the cloud KV names it, and a standby election can
# move it, oplog.assume_coordination)
# ---------------------------------------------------------------------------

def leader() -> int:
    return _LEADER


def epoch() -> int:
    return _EPOCH


def set_leader(proc: int, epoch_no: int) -> None:
    """Adopt a leadership view (an election won, or a newer epoch record
    found)."""
    global _LEADER, _EPOCH
    _LEADER = int(proc)
    _EPOCH = int(epoch_no)


def reset_leadership() -> None:
    """Back to the boot default (tests, cloud restart)."""
    set_leader(0, 0)


def _parse_epoch(raw: Optional[str]) -> dict:
    if raw is None:
        return {"epoch": 0, "leader": 0, "ts": 0.0}
    try:
        rec = json.loads(raw)
        return {"epoch": int(rec.get("epoch", 0)),
                "leader": int(rec.get("leader", 0)),
                "ts": float(rec.get("ts", 0.0))}
    except (ValueError, TypeError, AttributeError):
        return {"epoch": 0, "leader": 0, "ts": 0.0}


def epoch_record() -> dict:
    """The cloud-wide epoch record ({epoch, leader, ts}); the boot
    default when none was written."""
    return _parse_epoch(kv_try_get(_EPOCH_KEY))


def epoch_record_raw() -> Optional[str]:
    """The epoch record as stored (the expected value of a first-writer-
    wins `write_epoch_record`)."""
    return kv_try_get(_EPOCH_KEY)


def write_epoch_record(epoch_no: int, leader_proc: int,
                       expect: Optional[str] = ...) -> bool:
    """Write the epoch record. With `expect` (the raw record read before,
    None when there was none) the write lands only if the record is
    still that one: of two standbys racing one election, the first
    writer wins."""
    val = json.dumps({"epoch": int(epoch_no), "leader": int(leader_proc),
                      "ts": time.time()})
    if expect is ...:
        return kv_put(_EPOCH_KEY, val)
    return kv_compare_set(_EPOCH_KEY, expect, val)


def is_coordinator() -> bool:
    return process_index() == _LEADER


def rejoin() -> int:
    """Readmit this (restarted) process: a fresh incarnation, the latest
    control-plane checkpoint restored, the acknowledged suffix replayed,
    the heartbeat re-registered. Returns the oplog sequence it caught up
    to (the `follower_loop` cursor). The protocol is `oplog.rejoin`."""
    from h2o3_tpu_torch.parallel import oplog

    return oplog.rejoin()


# ---------------------------------------------------------------------------
# the cloud key/value store (water/DKV.java's control plane): small
# control-plane values, visible to every process. Device data never
# travels here.
# ---------------------------------------------------------------------------

_MEM_KV: Optional[Dict[str, str]] = None


@contextlib.contextmanager
def memory_kv(initial: Optional[Dict[str, str]] = None):
    """Install (and on exit remove) a dict-backed cloud KV."""
    global _MEM_KV
    prev = _MEM_KV
    _MEM_KV = dict(initial or {})
    try:
        yield _MEM_KV
    finally:
        _MEM_KV = prev


class KVWriteError(RuntimeError):
    """A cloud-KV write that did not land (retryable: a transient store
    fault)."""


class KVTransientError(RuntimeError):
    """A cloud-KV read that failed in transport (retryable), as opposed
    to an absent key's deadline expiry (not retried: it already
    waited)."""


def _transient(e: BaseException) -> bool:
    """Transport failures worth a retry, as opposed to a deadline."""
    s = str(e).upper()
    if "TIMEOUT" in s or "TIMED OUT" in s:
        return False
    return any(t in s for t in ("UNAVAILABLE", "CONNECTION", "RESET",
                                "BROKEN PIPE", "SOCKET"))


def _read(store, key: str) -> Optional[str]:
    got = store.compare_set(key, _ABSENT, _ABSENT)
    if got == _ABSENT:
        return None
    return got.decode("utf-8")


def _index_names(store) -> List[str]:
    raw = _read(store, _INDEX_KEY)
    if not raw:
        return []
    return list(dict.fromkeys(n for n in raw.split("\n") if n))


def kv_put(key: str, value: str) -> bool:
    """Publish a small value cloud-wide; False outside a multi-process
    cloud (callers treat local mode as a no-op) or once the retry budget
    is spent. Upsert: a second put overwrites."""
    if _MEM_KV is not None:
        _MEM_KV[key] = value
        return True
    store = _STORE
    if store is None:
        return False
    data = value.encode("utf-8")
    if data == _ABSENT:
        raise ValueError("the KV's read sentinel cannot be stored")

    def _attempt():
        try:
            fresh = _read(store, key) is None
            store.set(key, data)
            if fresh:
                store.append(_INDEX_KEY, key + "\n")
        except Exception as e:   # noqa: BLE001 — typed for the retry
            raise KVWriteError(f"kv_put({key!r}): {e}") from e

    try:
        retry.retry_call(_attempt, retry_on=(KVWriteError,),
                         describe=f"kv_put {key}")
        return True
    except KVWriteError:
        return False


def kv_put_if_absent(key: str, value: str) -> bool:
    """Write `value` only where `key` is absent (first writer wins);
    True when this call wrote it."""
    return kv_compare_set(key, None, value)


def kv_compare_set(key: str, expect: Optional[str], value: str) -> bool:
    """Atomically replace `key`'s value when it is `expect` (None: the
    key is absent); True when this call wrote it."""
    if _MEM_KV is not None:
        if _MEM_KV.get(key) != expect:
            return False
        _MEM_KV[key] = value
        return True
    store = _STORE
    if store is None:
        return False
    data = value.encode("utf-8")
    if expect is None:
        got = store.compare_set(key, b"", data)
        if got != data or _read(store, key) != value:
            return False
        store.append(_INDEX_KEY, key + "\n")
        return True
    got = store.compare_set(key, expect.encode("utf-8"), data)
    return got == data


def kv_get(key: str, timeout_ms: int = 5000) -> Optional[str]:
    """Blocking get with a deadline: an absent key returns None once it
    expires (not retried); transport faults retry with backoff."""
    if _MEM_KV is not None:
        return _MEM_KV.get(key)
    store = _STORE
    if store is None:
        return None

    def _get():
        try:
            got = _read(store, key)
            if got is not None:
                return got
            store.wait([key], datetime.timedelta(milliseconds=timeout_ms))
            return _read(store, key)
        except Exception as e:   # noqa: BLE001 — an expiry is an absence
            if _transient(e):
                raise KVTransientError(str(e)) from e
            return None

    try:
        return retry.retry_call(_get, retry_on=(KVTransientError,),
                                describe=f"kv_get {key}")
    except KVTransientError:
        return None


def kv_try_get(key: str) -> Optional[str]:
    if _MEM_KV is not None:
        return _MEM_KV.get(key)
    store = _STORE
    if store is None:
        return None
    try:
        return _read(store, key)
    except Exception:   # noqa: BLE001 — unreachable store reads absent
        return None


def kv_dir(prefix: str) -> List[Tuple[str, str]]:
    """The (key, value) pairs under a prefix."""
    if _MEM_KV is not None:
        return [(k, v) for k, v in list(_MEM_KV.items())
                if k.startswith(prefix)]
    store = _STORE
    if store is None:
        return []
    out = []
    try:
        for name in _index_names(store):
            if name.startswith(prefix):
                v = _read(store, name)
                if v is not None:
                    out.append((name, v))
    except Exception:   # noqa: BLE001 — unreachable store lists nothing
        return out
    return out


def kv_delete(key: str) -> None:
    global _DELETES
    if _MEM_KV is not None:
        _MEM_KV.pop(key, None)
        return
    store = _STORE
    if store is None:
        return
    try:
        store.delete_key(key)
    except Exception:   # noqa: BLE001 — absent or unreachable: nothing
        return          # left to delete here
    with _INDEX_LOCK:
        _DELETES += 1
        due = _DELETES % _COMPACT_EVERY == 0
    if due:
        _compact_index(store)


def _compact_index(store) -> None:
    """Drop the index's names of deleted keys. A put that appends while
    this runs changes the index, so the compare_set misses and the next
    round rereads it."""
    for _ in range(4):
        raw = _read(store, _INDEX_KEY) or ""
        live = [n for n in dict.fromkeys(raw.split("\n"))
                if n and _read(store, n) is not None]
        new = "".join(n + "\n" for n in live)
        if store.compare_set(_INDEX_KEY, raw.encode("utf-8"),
                             new.encode("utf-8")) == new.encode("utf-8"):
            return
