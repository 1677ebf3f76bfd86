"""Durable job progress, durable search state and tree-progress chunks,
one process (counterpart of h2o3_tpu/parallel/ckpt.py: `job_ckpt_iters`
:81, `ckpt_dir` :88, the job store :393-528, the search store :530-675,
the tree chunks :677-714).

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
write is atomic (a ``.part`` file of its own, then ``os.replace``; a
search's rotation and replace run under one lock) and has a small
JSON sidecar, and discovery reads the sidecars, so no reader unpickles
a full state to list records. Progress and search files are the port's
own, read only through the restricted unpickler. The reference also
books each record in the cloud's KV; that half, and the control-plane
checkpoints (`note_acked_op`, `checkpoint_now`, `write_checkpoint`,
`truncate_through`, `load_latest`), come with the multi-process control
plane (ROADMAP A14.4), so `latest_seq` is None.
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


def interval_ops() -> int:
    return retry.env_int("H2O_TPU_OPLOG_CHECKPOINT_OPS", 64)


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


def latest_seq() -> Optional[int]:
    return None


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
    path = _job_path(job_key)
    _atomic_write(path, pickle.dumps(payload, protocol=4))
    _write_sidecar(path, {"job": str(job_key), "iteration": int(iteration),
                          "path": path, "algo": (spec or {}).get("algo"),
                          "dest": (spec or {}).get("model_id"),
                          "ts": payload["ts"]})
    timeline.record("job", "progress_saved", job=str(job_key),
                    iteration=int(iteration))
    return path


def job_progress_records() -> List[dict]:
    """Every progress record ({job, iteration, path, algo, dest, ts}),
    sorted by job key, from the sidecars."""
    return _sidecars("jobckpt_", "job")


def has_job_progress(job_key: str) -> bool:
    """A sidecar exists (no unpickling: ``/3/Jobs`` asks per job)."""
    return os.path.exists(_job_path(job_key) + ".json")


def load_job_progress(job_key: str) -> Optional[dict]:
    """A job's progress ({job, iteration, spec, state, ts}); None when
    there is none or the file is unreadable or refused."""
    from h2o3_tpu_torch import persist

    try:
        with open(persist.resolve(_job_path(job_key)), "rb") as f:
            return _CkptUnpickler(f).load()
    except (OSError, pickle.UnpicklingError, EOFError, ValueError):
        return None


def delete_job_progress(job_key: str) -> None:
    """Drop a job's progress and its tree chunks (the finished model
    supersedes them)."""
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
        _write_sidecar(path, {"search": str(search_key),
                              "kind": state.get("kind"),
                              "dest": state.get("dest"), "path": path,
                              "members": counts, "ts": payload["ts"]})
    timeline.record("search", "state_saved", search=str(search_key),
                    done=counts.get("done", 0))
    return path


def search_state_records() -> List[dict]:
    """Every search record in the checkpoint dir ({search, kind, dest,
    path, members, ts}), sorted by search key."""
    return _sidecars("searchckpt_", "search")


def load_search_state(search_key: str,
                      sdir: Optional[str] = None) -> Optional[dict]:
    """A search's state ({search, kind, state, ts}); None when no
    snapshot is readable. A torn or refused current snapshot is logged
    and the previous generation is tried."""
    from h2o3_tpu_torch import persist
    from h2o3_tpu_torch.utils.log import get_logger

    path = _search_path(search_key, sdir)
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
    """Drop a search's state; `keep_files` keeps it (a grid's
    recovery_dir is also the user's export directory)."""
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
