"""Control-plane checkpoints, durable job progress, durable search state
and tree-progress chunks (counterpart of h2o3_tpu/parallel/ckpt.py).

- Control-plane checkpoints (reference :69-391). Every
  ``H2O_TPU_OPLOG_CHECKPOINT_OPS`` fully acknowledged ops the coordinator
  publishes a ``checkpoint`` op; inside its turn (no other op changes
  the DKV) it writes a snapshot of the DKV's objects, the next oplog
  sequence and the recent op tokens to a file. Once every follower
  acknowledged the op, the snapshot is booked at ``oplog/ckpt/{seq}``
  and the acknowledged prefix (``oplog/{s}`` and ``oplog/ack/{s}/*`` for
  s <= seq) is deleted, so the live oplog stays O(interval). A
  restarted follower readmits from the newest snapshot (`load_latest`,
  oplog.rejoin); ``H2O_TPU_OPLOG_CKPT_KEEP`` snapshots are kept, and one
  a rejoiner is restoring is pinned. On a row-sharded cloud the snapshot
  holds the writer's rows of each sharded frame; every follower writes
  its own rows as a rank section before it acknowledges the op
  (`write_rank_section`), and a restoring rank installs its section over
  the writer's rows. An op that completed a collective whose result it
  keeps is checkpointed the same way, at its own seq (oplog.turn).
- Job progress. An iterative builder whose job carries a re-dispatch
  recipe (`Job.resume_spec`) saves its loop state every
  ``H2O_TPU_JOB_CKPT_ITERS`` completed iterations (0, the default, saves
  nothing); a fresh builder given that state continues the same run.
- Search state. AutoML and grid search save their member plan and each
  member's status after every member; two generations stay on disk, so
  a torn current snapshot gives way to the previous one.
- Tree chunks. A tree loop's per-tree tables are append-only, so each
  save writes only the trees grown since the last as one npz chunk
  (`artifact/packer.pack_tree_chunk`, ``allow_pickle=False``), and the
  progress file lists the chunk paths.

Files live in ``H2O_TPU_OPLOG_CKPT_DIR``, else ``oplog_ckpt`` under
``H2O_TPU_ICE_ROOT``, else under the process's temp directory. Every
write is atomic (a ``.part`` file of its own, then ``os.replace``) and
job and search records have a small JSON sidecar. Each record is booked
twice: in the cloud KV (``oplog/jobckpt/{job}``,
``oplog/searchckpt/{search}``), which is what lets a new coordinator find
a failed job, and in the sidecar, which is what one process or a wiped
KV still has. Every file is read only through the restricted unpickler.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from h2o3_tpu_torch.utils import retry
from h2o3_tpu_torch.utils.unpickle import CheckpointUnpickler


_CKPT_PREFIX = "oplog/ckpt/"
_JOB_PREFIX = "oplog/jobckpt/"
_SEARCH_PREFIX = "oplog/searchckpt/"

# acked ops since the last checkpoint and its single-flight guard: two
# handler threads crossing the threshold together must not both publish
# a checkpoint op
_LOCK = threading.Lock()
_ACKED_SINCE = 0
_IN_CKPT = False
_CKPT_THREAD: Optional[threading.Thread] = None
# highest seq whose records were truncated: every op at or below it was
# acknowledged cloud-wide first, so oplog.wait_acks reads it as acked
_TRUNCATED_THROUGH = -1


def interval_ops() -> int:
    """Checkpoint every N fully acknowledged ops (env
    ``H2O_TPU_OPLOG_CHECKPOINT_OPS``, default 64; <= 0 disables)."""
    return retry.env_int("H2O_TPU_OPLOG_CHECKPOINT_OPS", 64)


def keep_ckpts() -> int:
    """Snapshots kept once a newer one is acknowledged (env
    ``H2O_TPU_OPLOG_CKPT_KEEP``, default 3; <= 0 keeps all)."""
    return retry.env_int("H2O_TPU_OPLOG_CKPT_KEEP", 3)


def async_enabled() -> bool:
    """Interval checkpoints on a thread of their own (env
    ``H2O_TPU_OPLOG_CKPT_ASYNC``, default on): the request that crossed
    the threshold does not wait for the snapshot and its ack."""
    return retry.env_int("H2O_TPU_OPLOG_CKPT_ASYNC", 1) != 0


def job_ckpt_iters() -> int:
    """Iterative builders save durable progress every N completed
    iterations (``H2O_TPU_JOB_CKPT_ITERS``; 0, the default, disables)."""
    return retry.env_int("H2O_TPU_JOB_CKPT_ITERS", 0)


def ckpt_dir() -> str:
    d = os.environ.get("H2O_TPU_OPLOG_CKPT_DIR") or os.path.join(
        os.environ.get("H2O_TPU_ICE_ROOT")
        or os.path.join(tempfile.gettempdir(), "h2o3_tpu_torch"),
        "oplog_ckpt")
    os.makedirs(d, exist_ok=True)
    return d


_CkptUnpickler = CheckpointUnpickler


def _safe(key: str) -> str:
    return re.sub(r"[^\w.-]", "_", str(key))


def _write_part(path: str, data: bytes) -> str:
    """`data` in a new ``.part`` file beside `path`, named for this write
    only, so concurrent writers never share one; returns its path."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".",
                               suffix=".part")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
    except BaseException:
        _unlink((tmp,))
        raise
    return tmp


def _atomic_write(path: str, data: bytes) -> None:
    os.replace(_write_part(path, data), path)


def _write_sidecar(path: str, meta: dict) -> None:
    _atomic_write(path + ".json", json.dumps(meta).encode("utf-8"))


def _sidecars(prefix: str, key: str) -> List[dict]:
    """The JSON sidecars of the checkpoint dir whose file names start
    with `prefix`, each holding `key`, sorted by it."""
    d = ckpt_dir()
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return []
    out = []
    for name in names:
        if not (name.startswith(prefix) and name.endswith(".pkl.json")):
            continue
        try:
            with open(os.path.join(d, name), encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict) and rec.get(key):
            out.append(rec)
    return sorted(out, key=lambda r: r[key])


def _unlink(paths) -> None:
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


def reset() -> None:
    """Clear the coordinator-side counters (cloud restart, tests)."""
    global _ACKED_SINCE, _TRUNCATED_THROUGH
    with _LOCK:
        _ACKED_SINCE = 0
        _TRUNCATED_THROUGH = -1


def truncated_through() -> int:
    """Highest seq compacted away (-1: none)."""
    return _TRUNCATED_THROUGH


def wait_idle(timeout_s: float = 30.0) -> bool:
    """Join an in-flight background checkpoint; True when none runs."""
    t = _CKPT_THREAD
    if t is not None and t.is_alive():
        t.join(timeout_s)
        return not t.is_alive()
    return True


# ---------------------------------------------------------------------------
# control-plane checkpoints: the coordinator writes and truncates
# ---------------------------------------------------------------------------

def note_acked_op(seq: int) -> None:
    """Called by the coordinator once op `seq` is acknowledged cloud-wide
    (oplog.turn's tail); every `interval_ops()` such ops it checkpoints
    and truncates the acknowledged prefix. Never raises: a failed
    checkpoint must not fail the user op that crossed the threshold."""
    global _ACKED_SINCE, _IN_CKPT, _CKPT_THREAD
    n = interval_ops()
    if n <= 0:
        return
    with _LOCK:
        _ACKED_SINCE += 1
        if _ACKED_SINCE < n or _IN_CKPT:
            return
        _IN_CKPT = True
        _ACKED_SINCE = 0
    if async_enabled():
        t = threading.Thread(target=_run_checkpoint, daemon=True,
                             name="h2o3-oplog-ckpt")
        with _LOCK:
            _CKPT_THREAD = t
        t.start()
    else:
        _run_checkpoint()


def _run_checkpoint() -> None:
    global _IN_CKPT
    try:
        checkpoint_now()
    except Exception as e:   # noqa: BLE001 — best effort by contract
        from h2o3_tpu_torch.utils.log import get_logger

        get_logger().warning("oplog checkpoint failed (the next interval "
                             "tries again): %s", e)
    finally:
        with _LOCK:
            _IN_CKPT = False


def checkpoint_now() -> Optional[int]:
    """Publish and run one ``checkpoint`` op: the snapshot under the
    turnstile, then, once every follower acknowledged it, its booking
    and the truncation of the acknowledged prefix (`commit`). Returns
    the checkpoint's seq; None when this process is not broadcasting or
    no longer leads (a checkpoint thread resuming on a stalled
    ex-coordinator must not publish or truncate under an epoch it
    lost)."""
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import oplog

    oplog.maybe_demote()
    if oplog.demoted() or not oplog.active():
        return None
    epoch0 = D.epoch()
    seq = oplog.publish("checkpoint", {})
    with oplog.turn(seq):
        write_checkpoint(seq)
    if oplog.demoted() or not D.is_coordinator() or D.epoch() != epoch0:
        return None
    return seq


def write_checkpoint(seq: int) -> str:
    """Write the control-plane snapshot of op `seq` (a checkpoint op, or
    an op that kept a collective's result) and book it at
    ``oplog/ckpt/{seq}``: inside that op's turn the booking waits for
    every follower's ack (oplog.defer_booking, `commit`). Its
    ``next_seq`` is seq + 1: the state holds every op through seq."""
    from h2o3_tpu_torch.core import failure
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import oplog
    from h2o3_tpu_torch.utils import timeline

    failure.faultpoint("ckpt.write")
    snap = {"seq": int(seq), "next_seq": int(seq) + 1, "epoch": D.epoch(),
            "ts": time.time(), "op_ids": oplog.snapshot_op_ids(),
            "rank": D.process_index(), "dkv": DKV.snapshot_control_plane()}
    path = os.path.join(ckpt_dir(), f"ckpt_{int(seq):012d}.pkl")
    _atomic_write(path, pickle.dumps(snap, protocol=4))
    rec = {"seq": int(seq), "next_seq": int(seq) + 1, "path": path,
           "epoch": snap["epoch"], "ts": snap["ts"],
           "skipped": snap["dkv"].get("skipped", [])}
    timeline.record("oplog", "checkpoint", seq=int(seq),
                    objects=len(snap["dkv"].get("objects", {})),
                    skipped=len(snap["dkv"].get("skipped", [])))
    if not oplog.defer_booking(rec):
        _book(rec)
    return path


def _book(rec: dict) -> None:
    from h2o3_tpu_torch.parallel import distributed as D

    if not D.kv_put(_CKPT_PREFIX + str(rec["seq"]), json.dumps(rec)):
        raise RuntimeError(f"checkpoint {rec['seq']}: its KV record did "
                           "not land")
    _prune_old()


def commit(rec: dict) -> None:
    """Book snapshot `rec` once every follower acknowledged its op (each
    wrote its rank section first), then truncate the acknowledged prefix
    through it, unless this process lost the epoch it was written
    under."""
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import oplog

    _book(rec)
    oplog.maybe_demote()
    if oplog.demoted() or not D.is_coordinator() \
            or D.epoch() != rec["epoch"]:
        return
    truncate_through(rec["seq"])


def discard(rec: dict) -> None:
    """Drop snapshot `rec`, whose op a follower did not acknowledge: its
    rank section may be missing, so it is never booked."""
    _unlink((rec["path"],))


def _section_path(seq: int, rank: int) -> str:
    return os.path.join(ckpt_dir(), f"ckpt_{int(seq):012d}.rank{rank}.pkl")


def write_rank_section(seq: int) -> Optional[str]:
    """A follower's part of the checkpoint of op `seq`: its rows of every
    row-sharded frame, next to the coordinator's snapshot (None when it
    holds none)."""
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.parallel import distributed as D

    objects = DKV.sharded_objects()
    if not objects:
        return None
    path = _section_path(seq, D.process_index())
    _atomic_write(path, pickle.dumps({"seq": int(seq),
                                      "rank": D.process_index(),
                                      "objects": objects}, protocol=4))
    return path


def _restore_rank_section(seq: int, snap: dict) -> None:
    """Replace the writer's rows of each sharded frame of snapshot `seq`
    by this rank's own (its section). A booked snapshot with sharded
    frames has every follower's section (each wrote it before its ack):
    a missing one raises, since the writer's rows are not this rank's."""
    from h2o3_tpu_torch import persist
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.parallel import distributed as D

    rank = D.process_index()
    if int(snap.get("rank", 0)) == rank:
        return
    sharded = (snap.get("dkv") or {}).get("sharded", [])
    for k in sharded:
        DKV.remove(k)
    path = persist.resolve(_section_path(seq, rank))
    if not os.path.exists(path):
        if sharded:
            raise RuntimeError(
                f"checkpoint {seq} holds row-sharded frames {sharded} but "
                f"no section of rank {rank}: its rows cannot be restored")
        return
    with open(path, "rb") as f:
        sec = _CkptUnpickler(f).load()
    DKV.restore_control_plane({"objects": sec.get("objects") or {}})


def records() -> List[Tuple[int, dict]]:
    """Every checkpoint record, sorted by seq."""
    from h2o3_tpu_torch.parallel import distributed as D

    out = []
    for k, v in D.kv_dir(_CKPT_PREFIX):
        try:
            out.append((int(k.rsplit("/", 1)[-1]), json.loads(v)))
        except (ValueError, TypeError):
            continue
    return sorted(out, key=lambda t: t[0])


def latest() -> Optional[Tuple[int, dict]]:
    recs = records()
    return recs[-1] if recs else None


def latest_seq() -> Optional[int]:
    rec = latest()
    return rec[0] if rec else None


def _prune_old(keep: Optional[int] = None) -> None:
    """Drop all but the newest `keep` snapshots (records and files). A
    snapshot a live rejoiner is restoring (its ``replaying`` record
    names the snapshot's ``next_seq``) is pinned; a stale heartbeat
    proves such a restore died, and ends the pin."""
    from h2o3_tpu_torch.core import failure
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import oplog

    if keep is None:
        keep = keep_ckpts()
    if keep <= 0:
        return
    health = {r["process"]: r for r in failure.cluster_health()}

    def _maybe_alive(proc: int) -> bool:
        row = health.get(proc)
        return row is None or bool(row.get("healthy", True))

    pinned = {int(r.get("seq", -1)) for r in oplog.rejoin_records()
              if r.get("phase") == "replaying"
              and _maybe_alive(int(r.get("proc", -1)))}
    for seq, rec in records()[:-keep]:
        if int(rec.get("next_seq", seq + 1)) in pinned:
            continue
        D.kv_delete(_CKPT_PREFIX + str(seq))
        if rec.get("path"):
            _unlink((rec["path"],))
        _unlink([_section_path(seq, r) for r in range(D.process_count())])


def truncate_through(seq: int) -> int:
    """Delete the acknowledged oplog slots and acks for seqs <= `seq`;
    returns the keys deleted. Error records stay: they
    are failure evidence, which only a successful rejoin supersedes."""
    global _TRUNCATED_THROUGH
    from h2o3_tpu_torch.parallel import distributed as D

    # the floor rises before the deletes: a wait_acks poller racing them
    # sees either its ack records or the floor
    with _LOCK:
        _TRUNCATED_THROUGH = max(_TRUNCATED_THROUGH, int(seq))
    n = 0
    for k, _v in D.kv_dir("oplog/"):
        parts = k[len("oplog/"):].split("/")
        s = None
        if len(parts) == 1 and parts[0].isdigit():           # oplog/{s}
            s = int(parts[0])
        elif len(parts) >= 2 and parts[0] == "ack" \
                and parts[1].isdigit():                        # .../{s}/..
            s = int(parts[1])
        if s is not None and s <= seq:
            D.kv_delete(k)
            n += 1
    return n


def load_latest(restore_dkv: bool = True) -> Tuple[int, Optional[dict]]:
    """The newest checkpoint as ``(next_seq, snapshot)``: the oplog
    cursor to replay from, and the snapshot (``(0, None)`` when there is
    none). With `restore_dkv` its objects are installed in this
    process's DKV first, their tensors on this process's device."""
    from h2o3_tpu_torch import persist
    from h2o3_tpu_torch.core.dkv import DKV

    rec = latest()
    if rec is None:
        return 0, None
    seq, meta = rec
    with open(persist.resolve(meta["path"]), "rb") as f:
        snap = _CkptUnpickler(f).load()
    if restore_dkv:
        DKV.restore_control_plane(snap.get("dkv") or {})
        _restore_rank_section(seq, snap)
    return int(snap.get("next_seq", seq + 1)), snap


# ---------------------------------------------------------------------------
# job progress
# ---------------------------------------------------------------------------

def _job_path(job_key: str) -> str:
    return os.path.join(ckpt_dir(), f"jobckpt_{_safe(job_key)}.pkl")


def save_job_progress(job_key: str, iteration: int, spec: Dict[str, Any],
                      state: Dict[str, Any]) -> str:
    """Persist one job's progress: `spec` is the re-dispatch recipe
    (algo, parameters, frame keys, response, destination), `state` the
    fit loop's state after `iteration` completed iterations. The pickle
    is replaced atomically, then its sidecar."""
    from h2o3_tpu_torch.utils import timeline

    payload = {"job": str(job_key), "iteration": int(iteration),
               "spec": dict(spec or {}), "state": state, "ts": time.time()}
    from h2o3_tpu_torch.parallel import distributed as D

    path = _job_path(job_key)
    _atomic_write(path, pickle.dumps(payload, protocol=4))
    meta = {"job": str(job_key), "iteration": int(iteration),
            "path": path, "algo": (spec or {}).get("algo"),
            "dest": (spec or {}).get("model_id"), "ts": payload["ts"]}
    _write_sidecar(path, meta)
    D.kv_put(_JOB_PREFIX + str(job_key), json.dumps(meta))
    timeline.record("job", "progress_saved", job=str(job_key),
                    iteration=int(iteration))
    return path


def _kv_records(prefix: str, key: str) -> List[dict]:
    from h2o3_tpu_torch.parallel import distributed as D

    out = []
    for _k, v in D.kv_dir(prefix):
        try:
            rec = json.loads(v)
        except (ValueError, TypeError):
            continue
        if isinstance(rec, dict) and rec.get(key):
            out.append(rec)
    return out


def _merged(prefix: str, file_prefix: str, key: str) -> List[dict]:
    """The KV's records, then the sidecars the KV does not know (one
    process, or a wiped KV), sorted by `key`."""
    out = _kv_records(prefix, key)
    seen = {r[key] for r in out}
    out += [r for r in _sidecars(file_prefix, key) if r[key] not in seen]
    return sorted(out, key=lambda r: r[key])


def _kv_path(prefix: str, key: str) -> Optional[str]:
    from h2o3_tpu_torch.parallel import distributed as D

    raw = D.kv_try_get(prefix + str(key))
    if raw is None:
        return None
    try:
        return json.loads(raw).get("path")
    except (ValueError, TypeError, AttributeError):
        return None


def job_progress_records() -> List[dict]:
    """Every progress record ({job, iteration, path, algo, dest, ts}),
    sorted by job key: the cloud KV's, then the sidecars it lacks."""
    return _merged(_JOB_PREFIX, "jobckpt_", "job")


def has_job_progress(job_key: str) -> bool:
    """A KV record or a sidecar exists (no unpickling: ``/3/Jobs`` asks
    per job)."""
    from h2o3_tpu_torch.parallel import distributed as D

    if D.kv_try_get(_JOB_PREFIX + str(job_key)) is not None:
        return True
    return os.path.exists(_job_path(job_key) + ".json")


def load_job_progress(job_key: str) -> Optional[dict]:
    """A job's progress ({job, iteration, spec, state, ts}); None when
    there is none or the file is unreadable or refused."""
    from h2o3_tpu_torch import persist

    path = _kv_path(_JOB_PREFIX, job_key) or _job_path(job_key)
    try:
        with open(persist.resolve(path), "rb") as f:
            return _CkptUnpickler(f).load()
    except (OSError, pickle.UnpicklingError, EOFError, ValueError):
        return None


def delete_job_progress(job_key: str) -> None:
    """Drop a job's progress and its tree chunks (the finished model
    supersedes them)."""
    from h2o3_tpu_torch.parallel import distributed as D

    D.kv_delete(_JOB_PREFIX + str(job_key))
    path = _job_path(job_key)
    paths = [path, path + ".json"]
    prefix = f"jobckpt_{_safe(job_key)}_trees_"
    try:
        paths += [os.path.join(ckpt_dir(), n) for n in os.listdir(ckpt_dir())
                  if n.startswith(prefix) and n.endswith(".npz")]
    except OSError:
        pass
    _unlink(paths)


# ---------------------------------------------------------------------------
# search state (AutoML, grid)
# ---------------------------------------------------------------------------

# the rotation to ``.prev`` and the replace of the current snapshot are
# one step: two saves of one search never interleave them
_SEARCH_LOCK = threading.Lock()


def _search_path(search_key: str, sdir: Optional[str] = None) -> str:
    return os.path.join(sdir or ckpt_dir(),
                        f"searchckpt_{_safe(search_key)}.pkl")


def save_search_state(search_key: str, state: Dict[str, Any],
                      sdir: Optional[str] = None) -> str:
    """Persist one search's state (member plan, statuses, attempts, the
    re-dispatch spec). The current snapshot moves to ``.prev`` before the
    new one replaces it, so two generations are always on disk."""
    from h2o3_tpu_torch.utils import timeline

    payload = {"search": str(search_key), "kind": state.get("kind"),
               "state": state, "ts": time.time()}
    path = _search_path(search_key, sdir)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = _write_part(path, pickle.dumps(payload, protocol=4))
    counts: Dict[str, int] = {}
    for m in (state.get("members") or {}).values():
        st = str(m.get("status", "pending"))
        counts[st] = counts.get(st, 0) + 1
    with _SEARCH_LOCK:
        if os.path.exists(path):
            try:
                os.replace(path, path + ".prev")
            except OSError:
                pass
        os.replace(tmp, path)
        meta = {"search": str(search_key), "kind": state.get("kind"),
                "dest": state.get("dest"), "path": path,
                "members": counts, "ts": payload["ts"]}
        _write_sidecar(path, meta)
    from h2o3_tpu_torch.parallel import distributed as D

    D.kv_put(_SEARCH_PREFIX + str(search_key), json.dumps(meta))
    timeline.record("search", "state_saved", search=str(search_key),
                    done=counts.get("done", 0))
    return path


def search_state_records() -> List[dict]:
    """Every search record ({search, kind, dest, path, members, ts}),
    sorted by search key: the cloud KV's, then the sidecars it lacks."""
    return _merged(_SEARCH_PREFIX, "searchckpt_", "search")


def load_search_state(search_key: str,
                      sdir: Optional[str] = None) -> Optional[dict]:
    """A search's state ({search, kind, state, ts}); None when no
    snapshot is readable. A torn or refused current snapshot is logged
    and the previous generation is tried."""
    from h2o3_tpu_torch import persist
    from h2o3_tpu_torch.utils.log import get_logger

    path = (_kv_path(_SEARCH_PREFIX, search_key) if sdir is None
            else None) or _search_path(search_key, sdir)
    for i, p in enumerate((path, path + ".prev")):
        try:
            with open(persist.resolve(p), "rb") as f:
                rec = _CkptUnpickler(f).load()
        except OSError:
            continue
        except (pickle.UnpicklingError, EOFError, ValueError,
                AttributeError, ImportError, IndexError) as e:
            get_logger().error(
                "search state %s is torn or refused (%s: %s)%s", p,
                type(e).__name__, e,
                "; trying the previous snapshot" if i == 0 else "")
            continue
        if isinstance(rec, dict) and rec.get("state"):
            if i == 1:
                get_logger().warning(
                    "search %s resumes from the previous snapshot %s",
                    search_key, p)
            return rec
    return None


def delete_search_state(search_key: str, sdir: Optional[str] = None,
                        keep_files: bool = False) -> None:
    """Drop a search's state; `keep_files` drops only its KV record (a
    grid's recovery_dir is also the user's export directory)."""
    from h2o3_tpu_torch.parallel import distributed as D

    D.kv_delete(_SEARCH_PREFIX + str(search_key))
    if keep_files:
        return
    path = _search_path(search_key, sdir)
    _unlink((path, path + ".prev", path + ".json"))


# ---------------------------------------------------------------------------
# append-only tree chunks
# ---------------------------------------------------------------------------

def job_tree_chunk_path(job_key: str, idx: int) -> str:
    return os.path.join(ckpt_dir(),
                        f"jobckpt_{_safe(job_key)}_trees_{int(idx):06d}.npz")


def append_job_tree_chunk(job_key: str, idx: int, packs, leaf_vals,
                          leaf_wys) -> str:
    """Write chunk `idx` of `job_key`'s trees atomically; returns its
    path."""
    from h2o3_tpu_torch.artifact import packer

    path = job_tree_chunk_path(job_key, idx)
    _atomic_write(path, packer.pack_tree_chunk(packs, leaf_vals, leaf_wys))
    return path


def load_job_tree_chunks(paths) -> Tuple[list, list, list]:
    """The per-tree lists from the chunks, in order. A missing or torn
    chunk raises: a resume never trains on from a partial forest."""
    from h2o3_tpu_torch import persist
    from h2o3_tpu_torch.artifact import packer

    packs: list = []
    leaf_vals: list = []
    leaf_wys: list = []
    for p in paths:
        with open(persist.resolve(str(p)), "rb") as f:
            pk, lv, lw = packer.unpack_tree_chunk(f.read())
        packs.extend(pk)
        leaf_vals.extend(lv)
        leaf_wys.extend(lw)
    return packs, leaf_vals, leaf_wys
