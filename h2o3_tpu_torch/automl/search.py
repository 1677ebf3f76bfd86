"""The in-process search engine of AutoML and grid search (counterpart
of h2o3_tpu/automl/search.py: `MAX_ATTEMPTS` :40, `_DEVICE_LANE` :53,
`stats` :76, `search_ckpt_enabled` :102, `member_deadline_s` :108,
`search_concurrency` :123, `_scrub_params` :156, `SearchEngine` :176
with its restored state :184-230, `member` :246, `counts` :266, `state`
:262, `save` :273, `finish` :295, `run` :324, `_run` :342, `_build_one`
:376, `_progress` :466).

Both `H2OAutoML.train` and `H2OGridSearch.train` drive their members
through one :class:`SearchEngine`:

- each attempt of a member is a real ``Job`` on its own thread, failed
  from outside and parked once it has held the device lane for
  ``H2O_TPU_SEARCH_MEMBER_DEADLINE_S`` (0, the default, means no
  deadline);
- a ValueError or TypeError (a configuration error) parks the member on
  its first attempt; any other error retries it, and it parks at
  ``MAX_ATTEMPTS``. A parked member never fails the search;
- members schedule concurrently up to ``search_concurrency()``
  (``H2O_TPU_SEARCH_CONCURRENCY``: an int, or ``auto``, which sizes the
  width from the free capacity of the serving tier's admission
  controller, ``admission.CONTROLLER``, and is 1 while admission runs
  uncapped, as the reference's is).

The device lane (ROADMAP C27): on the one GPU every member's build
holds `_DEVICE_LANE`, GLM's included. The reference lets builders marked
``parallel_safe`` (GLM) skip its lane; the port does not, because a
member's kernels launched while a DeepLearning member captures its CUDA
graph can break the capture. Members still schedule, score and report
concurrently, and the set of models is the sequential walk's. Since
every member queues for the lane, a member's deadline runs from when it
takes the lane (the reference's runs from its start, queueing
included); a member failed at its deadline keeps the lane until its
thread ends.

Durable search state: an engine with a directory of its own (a grid's
`recovery_dir`), or with a Job while ``H2O_TPU_SEARCH_CKPT`` is on (the
default), saves its snapshot (parallel/ckpt.save_search_state) after
every member's attempt and at the end of `run`. An engine built from a
snapshot keeps each member's status and attempts; a member that was
running when its process died counts as failed, its attempt spent.
`run` skips parked members and re-attaches done ones (`reattach`); one
process rebuilds a done member whose model is gone, a multi-process
cloud never does (the extra build would fork the replayed programs).
`finish` drops the snapshot, except in a directory the caller chose.

Mirrored decisions: on an oplog-active cloud (or any multi-process one)
members run one at a time with no deadline, and a member's recorded
parameters never keep a wall-clock budget, so every process walks the
same members from the same durable state.

Watchdog resume (reference :502-691): after a coordinator's loss the
watchdog calls `resume_orphaned`, which re-dispatches every externally
failed search that left durable state, under its original key
(`run_from_state`), broadcasting a ``search_resume`` op that followers
replay through `apply_resume_op`.
"""

from __future__ import annotations

import os
import contextlib
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, List, Optional

from h2o3_tpu_torch.parallel.watchdog import MAX_ATTEMPTS

_WIRE_TYPES = (str, int, float, bool, list, tuple, type(None))

_LOCK = threading.Lock()

# every member's build holds this lane (ROADMAP C27, above)
_DEVICE_LANE = threading.Lock()

_STATS: Dict[str, int] = {}


def _zero() -> Dict[str, int]:
    return dict(members_done=0, members_failed=0, members_parked=0,
                attempts=0, running=0, overlap=0, searches_resumed=0,
                state_saves=0, state_save_errors=0)


_STATS.update(_zero())


def stats() -> Dict[str, int]:
    """Process-wide search counters: members done, failed and parked,
    attempts dispatched, members running now, the high-water mark of
    members running at once (`overlap`) and searches the watchdog
    resumed."""
    with _LOCK:
        return dict(_STATS)


def reset_stats() -> None:
    with _LOCK:
        _STATS.update(_zero())


def _bump(**kw) -> None:
    with _LOCK:
        for k, v in kw.items():
            _STATS[k] = _STATS.get(k, 0) + v
        if _STATS["running"] > _STATS["overlap"]:
            _STATS["overlap"] = _STATS["running"]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def search_ckpt_enabled() -> bool:
    """``H2O_TPU_SEARCH_CKPT=0`` turns durable search state off."""
    return _env_float("H2O_TPU_SEARCH_CKPT", 1) > 0


def _mirrored() -> bool:
    """True where every rank must walk the members in one order with no
    per-process timer: a mirrored cloud, or a row mesh of ranks."""
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import mesh as M
    from h2o3_tpu_torch.parallel import oplog

    m = M.current()
    return (oplog.active() or D.process_count() > 1
            or (m is not None and m.size > 1))


def member_deadline_s() -> float:
    """Per-member wall-clock deadline in seconds
    (``H2O_TPU_SEARCH_MEMBER_DEADLINE_S``, 0 = none). A member past it is
    failed from outside and parked, and the search moves on. Only in one
    process: a per-process timer would fire at different moments in the
    replays."""
    if _mirrored():
        return 0.0
    return _env_float("H2O_TPU_SEARCH_MEMBER_DEADLINE_S", 0.0)


def search_concurrency() -> int:
    """Member-scheduling width: ``H2O_TPU_SEARCH_CONCURRENCY`` as an int,
    or ``auto`` (the default), which sizes off the admission controller's
    free capacity (its static cap less the requests in flight, at most
    4) and stays 1 while admission runs uncapped: width is worth paying
    for only when the operator has said how much device pressure is
    safe."""
    if _mirrored():
        # every process must finish members in the same order
        return 1
    raw = (os.environ.get("H2O_TPU_SEARCH_CONCURRENCY") or "auto").strip()
    if raw.lower() != "auto":
        try:
            return max(1, int(raw))
        except ValueError:
            return 1
    from h2o3_tpu_torch import admission

    snap = admission.CONTROLLER.snapshot()
    cap = int(snap.get("max_inflight") or 0)
    if cap <= 0:
        return 1
    inflight = sum(int(m.get("inflight") or 0)
                   for m in (snap.get("models") or {}).values())
    return min(4, max(1, cap - inflight))


def _scrub_params(params: Optional[dict]) -> dict:
    """A member's parameters as plain values only (what its record
    keeps), and never a live wall-clock budget on an oplog-active cloud:
    per-process time would fork the replayed fit loops of a resume."""
    from h2o3_tpu_torch.parallel import oplog

    out = {k: v for k, v in (params or {}).items()
           if isinstance(v, _WIRE_TYPES)}
    if oplog.active() and float(out.get("max_runtime_secs") or 0.0) > 0:
        out["max_runtime_secs"] = 0.0
    return out


class SearchEngine:
    """One search's controller: the member plan and each member's
    status, attempts and score.

    Statuses: ``pending`` -> ``running`` -> ``done`` | ``failed`` (an
    attempt burned, retried) | ``parked`` (at MAX_ATTEMPTS, past its
    deadline, or a configuration error; never fails the search)."""

    def __init__(self, key: str, kind: str, spec: Optional[dict] = None,
                 job=None, state: Optional[dict] = None,
                 sdir: Optional[str] = None):
        self.key = str(key)
        self.kind = str(kind)
        self.spec = dict(spec or {})
        self.job = job
        self.sdir = sdir
        self.persist = sdir is not None or (job is not None
                                            and search_ckpt_enabled())
        # a mirrored cloud never rebuilds a done member whose model left
        # a DKV: the extra build would fork the replayed programs
        from h2o3_tpu_torch.parallel import oplog

        self.retrain_lost = not oplog.active()
        # optional owner hook, called with (member, attempt) after a
        # failed or parked attempt (AutoML's event log)
        self.on_member_failure = None
        self._lock = threading.RLock()
        # one save at a time, so snapshots reach the disk in order
        self._save_lock = threading.Lock()
        self.members: Dict[str, dict] = {}
        self.order: List[str] = []
        restored = state or {}
        self.resumed = bool(restored.get("members"))
        for name in restored.get("order") or sorted(
                restored.get("members") or {}):
            m = dict((restored.get("members") or {}).get(name) or {})
            if not m:
                continue
            if m.get("status") == "running":
                # in flight when its process died: that attempt is spent
                m["status"] = "failed"
                m["attempts"] = int(m.get("attempts") or 0) + 1
                m["error"] = "member was in flight when its process died"
            self.members[name] = m
            self.order.append(name)
        self.saves = int(restored.get("saves") or 0)

    # -- plan -------------------------------------------------------------
    def member(self, name: str, algo: Optional[str] = None,
               params: Optional[dict] = None) -> dict:
        """Get or create the record of one member."""
        with self._lock:
            m = self.members.get(name)
            if m is None:
                m = {"name": str(name), "status": "pending", "attempts": 0,
                     "model_id": None, "score": None, "error": None}
                self.members[name] = m
                self.order.append(name)
            if algo is not None:
                m["algo"] = str(algo)
            m["params"] = _scrub_params(params)
            return m

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for m in self.members.values():
                st = str(m.get("status", "pending"))
                out[st] = out.get(st, 0) + 1
            return out

    def state(self) -> dict:
        """A snapshot: the member records without their ``_``-prefixed
        runtime entries, and the spec."""
        with self._lock:
            members = {n: {k: v for k, v in m.items()
                           if not str(k).startswith("_")}
                       for n, m in self.members.items()}
            return {"search": self.key, "kind": self.kind,
                    "spec": dict(self.spec), "members": members,
                    "order": list(self.order), "saves": self.saves,
                    "dest": self.spec.get("dest")}

    # -- persistence ------------------------------------------------------
    def save(self) -> None:
        """Save the snapshot. Never raises: after a failed save the
        previous snapshot stands and the next save tries again."""
        if not self.persist:
            return
        from h2o3_tpu_torch.core import failure
        from h2o3_tpu_torch.parallel import ckpt

        try:
            failure.faultpoint("search.state_save")
            with self._save_lock:
                with self._lock:
                    self.saves += 1
                    snap = self.state()
                ckpt.save_search_state(self.key, snap, sdir=self.sdir)
            _bump(state_saves=1)
        except Exception as e:   # noqa: BLE001 — best effort per save
            _bump(state_save_errors=1)
            from h2o3_tpu_torch.utils.log import get_logger

            get_logger().error(
                "search %s: state save failed (%s: %s); the previous "
                "snapshot stands", self.key, type(e).__name__, e)

    def finish(self) -> None:
        """The finished search supersedes its snapshot; a directory the
        caller chose (a grid's recovery_dir) keeps its files."""
        if not self.persist:
            return
        from h2o3_tpu_torch.parallel import ckpt

        ckpt.delete_search_state(self.key, sdir=self.sdir,
                                 keep_files=self.sdir is not None)

    # -- scheduling -------------------------------------------------------
    def run(self, members: List[dict], build_fn: Callable[[dict], Any],
            can_start: Optional[Callable[[int], bool]] = None,
            score_fn: Optional[Callable[[dict, Any], Any]] = None,
            concurrency: Optional[int] = None,
            reattach: Optional[Callable[[dict], Any]] = None) -> bool:
        """Drive `members` (plan order) to a terminal state. ``build_fn``
        trains one member and returns its model; ``can_start(inflight)``
        is the budget gate, asked before every dispatch. Parked members
        are skipped; a done member is handed to ``reattach`` (which
        returns its model, or None when it is gone). Returns False when
        the gate stopped the search with members still pending."""
        conc = int(concurrency) if concurrency else search_concurrency()
        ok = self._run(members, build_fn, can_start, score_fn, conc,
                       reattach)
        self.save()
        return ok

    def _run(self, members, build_fn, can_start, score_fn, conc,
             reattach=None) -> bool:
        todo: List[dict] = []
        for m in members:
            st = m.get("status")
            if st == "done":
                if reattach is not None and reattach(m) is None \
                        and self.retrain_lost and m.get("model_id"):
                    # the finished model did not survive: one process
                    # rebuilds it
                    m["status"] = "pending"
                    todo.append(m)
                continue
            if st != "parked":
                todo.append(m)
        if conc <= 1:
            for m in todo:
                if can_start is not None and not can_start(0):
                    return False
                self._build_one(m, build_fn, score_fn)
            return True
        stopped = False
        with ThreadPoolExecutor(max_workers=conc,
                                thread_name_prefix="h2o3-search") as ex:
            pending = list(todo)
            futures: Dict[Any, dict] = {}
            while pending or futures:
                while pending and len(futures) < conc and \
                        (can_start is None or can_start(len(futures))):
                    m = pending.pop(0)
                    futures[ex.submit(self._build_one, m, build_fn,
                                      score_fn)] = m
                if not futures:
                    # the gate refused with nothing in flight: the budget
                    # is spent for good
                    stopped = bool(pending)
                    break
                done, _ = wait(list(futures), return_when=FIRST_COMPLETED)
                for f in done:
                    futures.pop(f, None)
                    f.result()   # an engine-level crash must propagate
        return not stopped

    def _build_one(self, m: dict, build_fn, score_fn=None) -> None:
        """One member driven to a terminal state: each attempt is a Job on
        its own thread, joined with the member deadline."""
        from h2o3_tpu_torch.core.job import Job
        from h2o3_tpu_torch.utils.log import get_logger

        dl = member_deadline_s()
        while True:
            with self._lock:
                m["attempts"] = int(m.get("attempts") or 0) + 1
                m["status"] = "running"
                attempt = m["attempts"]
            _bump(attempts=1, running=1)
            job = Job(description=f"{self.kind} member {m['name']}",
                      dest=m.get("model_id"))
            box: Dict[str, Any] = {}
            started = threading.Event()
            from h2o3_tpu_torch.parallel import mesh as M

            # the member's thread joins this rank's mesh; ranks run their
            # members one after another, each in step with its peers, so
            # the process-wide lane (which ranks run as threads would
            # share) is not taken there
            from h2o3_tpu_torch.parallel import oplog

            mesh = M.current()
            lane = (_DEVICE_LANE if mesh is None or mesh.size == 1
                    else contextlib.nullcontext())
            # and the op it runs under: its collectives are the op's
            opctx = oplog.op_context()

            def work(j, _m=m, _box=box, _started=started, _lane=lane):
                try:
                    with _lane, M.use(mesh), oplog.adopt_op_context(opctx):
                        _started.set()
                        _box["model"] = build_fn(_m)
                except BaseException as e:
                    _box["exc"] = e
                    raise

            job.start(work, background=True)
            # the deadline runs from when the member holds the lane: time
            # queued behind other members' device work is not its own
            while not started.wait(0.05) and job._thread.is_alive():
                pass
            job._thread.join(timeout=dl if dl > 0 else None)
            wedged = job._thread.is_alive()
            if wedged:
                # fail the job from outside; its thread is left to end on
                # its own (it may hold the device lane until then)
                job.fail(f"search member {m['name']} exceeded its "
                         f"{dl:g}s deadline (attempt {attempt})")
            _bump(running=-1)
            exc = box.get("exc")
            if not wedged and exc is None:
                model = box.get("model")
                with self._lock:
                    m["status"] = "done"
                    m["error"] = None
                    if model is not None and m.get("model_id") is None:
                        mk = getattr(model, "key", None)
                        if mk is not None:
                            m["model_id"] = str(mk)
                    if score_fn is not None:
                        try:
                            m["score"] = score_fn(m, model)
                        except Exception:   # noqa: BLE001 — a scoring
                            # hiccup must not undo a finished member
                            m["score"] = None
                _bump(members_done=1)
                self._progress()
                self.save()
                return
            err = (job.exception if wedged else
                   f"{type(exc).__name__}: {exc}")
            deterministic = isinstance(exc, (ValueError, TypeError))
            with self._lock:
                m["error"] = str(err)[:500]
                if deterministic or attempt >= MAX_ATTEMPTS or wedged:
                    m["status"] = "parked"
                else:
                    m["status"] = "failed"
            _bump(members_failed=1)
            if m["status"] == "parked":
                _bump(members_parked=1)
            get_logger().warning(
                "search %s: member %s attempt %d %s: %s", self.key,
                m["name"], attempt,
                "parked" if m["status"] == "parked" else "failed", err)
            cb = self.on_member_failure
            if cb is not None:
                try:
                    cb(dict(m), attempt)
                except Exception:   # noqa: BLE001 — an owner's log hook
                    pass            # must never undo the parking
            self._progress()
            self.save()
            if m["status"] == "parked":
                return

    def _progress(self) -> None:
        """The search Job's progress: the share of settled members."""
        if self.job is None:
            return
        c = self.counts()
        total = max(1, len(self.members))
        done = c.get("done", 0) + c.get("parked", 0)
        try:
            self.job.update(min(0.99, done / total),
                            f"{done}/{total} members settled")
        except Exception:   # noqa: BLE001 — a cancel reaches the members
            pass            # through their own ticks, not through this one


# ---------------------------------------------------------------------------
# watchdog resume: orphaned search state re-dispatched under its key
# ---------------------------------------------------------------------------

# records whose Job is gone and whose state is unreadable: a few looks,
# then the record is dropped (watchdog._strike's rule)
_STRIKES: Dict[str, int] = {}


def _strike(search_key: str) -> None:
    from h2o3_tpu_torch.parallel import ckpt

    _STRIKES[search_key] = _STRIKES.get(search_key, 0) + 1
    if _STRIKES[search_key] >= MAX_ATTEMPTS:
        ckpt.delete_search_state(search_key)
        _STRIKES.pop(search_key, None)
        from h2o3_tpu_torch.utils.log import get_logger

        get_logger().warning(
            "watchdog: durable search state for %s was unreadable %d "
            "times; record dropped", search_key, MAX_ATTEMPTS)


def _recreate_search_job(search_key: str, state: dict):
    """The search's Job under its original key (the object lived on the
    dead coordinator), so clients keep polling the same id."""
    from h2o3_tpu_torch.core.dkv import DKV, Key
    from h2o3_tpu_torch.core.job import Job

    spec = state.get("spec") or {}
    job = Job(description=spec.get("description")
              or f"{state.get('kind', 'search')} search",
              dest=spec.get("dest"))
    DKV.remove(str(job.key))
    job._key = Key(search_key)
    job.status = Job.FAILED
    job.failed_externally = True
    job.exception = ("search was in flight when its coordinator died; "
                     "recreated from durable search state for resume")
    job.install()
    return job


def resume_orphaned() -> List[str]:
    """Re-dispatch every externally failed search with durable state;
    returns the search keys resumed (the watchdog's tick calls it after
    the job resume, with the same verdict, clean-up and attempt cap)."""
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.core.job import Job
    from h2o3_tpu_torch.parallel import ckpt

    resumed: List[str] = []
    for rec in ckpt.search_state_records():
        sk = str(rec.get("search"))
        job = DKV.get(sk)
        data = None
        if job is None:
            data = ckpt.load_search_state(sk)
            if data is None:
                _strike(sk)
                continue
            st = data.get("state") or {}
            if not (st.get("spec") or {}).get("kind"):
                ckpt.delete_search_state(sk)     # nothing can act on it
                continue
            job = _recreate_search_job(sk, st)
        if not isinstance(job, Job):
            continue
        if job.status in (Job.DONE, Job.CANCELLED) or \
                (job.status == Job.FAILED and not job.failed_externally):
            ckpt.delete_search_state(sk)
            continue
        if not (job.status == Job.FAILED and job.failed_externally):
            continue                     # running or resuming: leave it
        if job.attempt >= MAX_ATTEMPTS:
            ckpt.delete_search_state(sk)
            continue
        if data is None:
            data = ckpt.load_search_state(sk)
        if data is None:
            job.attempt += 1
            job.exception = (f"search resume pass {job.attempt}: durable "
                             f"search state for {sk} is unreadable")
            continue
        if _dispatch_search_resume(job, data.get("state") or {}):
            resumed.append(sk)
    return resumed


def _dispatch_search_resume(job, state: dict) -> bool:
    """One re-dispatch: RESUMING (atomic), the ``search_resume`` op
    broadcast so followers reload the same state file, and the search
    rebuilt on the job's new worker thread under its original key."""
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.parallel import oplog

    spec = state.get("spec") or {}
    kind = spec.get("kind")
    train = DKV.get(str(spec.get("training_frame") or ""))
    if not kind or train is None:
        job.attempt += 1
        what = ("no re-dispatch recipe in the durable state" if not kind
                else f"training frame {spec.get('training_frame')!r} is "
                     f"not in this process's DKV")
        job.exception = f"search resume pass {job.attempt}: {what}"
        return False
    members = state.get("members") or {}
    ndone = sum(1 for m in members.values() if m.get("status") == "done")
    if not job.restart(resumed_from_iteration=ndone):
        return False
    inner = dict(spec.get("spec") or {})
    if oplog.active() and float(inner.get("max_runtime_secs") or 0.0) > 0:
        # a wall-clock budget in a re-broadcast spec would fork the
        # replayed member loops
        inner["max_runtime_secs"] = 0.0
        spec = dict(spec, spec=inner)
        state = dict(state, spec=spec)
    op_seq = None
    if oplog.active():
        try:
            op_seq = oplog.broadcast("search_resume",
                                     {"search": str(job.key), "kind": kind})
        except Exception as e:   # noqa: BLE001 — the cloud relapsed
            job.fail(f"search resume could not broadcast: {e}")
            return False

    def run(j):
        with oplog.turn(op_seq):
            return run_from_state(state, job=j)

    job.start(run, background=True)
    _bump(searches_resumed=1)
    from h2o3_tpu_torch.utils import timeline
    from h2o3_tpu_torch.utils.log import get_logger

    timeline.record("search", "resumed", search=str(job.key),
                    attempt=job.attempt, members_done=ndone)
    get_logger().warning(
        "watchdog: resumed %s search %s (attempt %d) with %d/%d members "
        "already done", kind, job.key, job.attempt, ndone, len(members))
    return True


def run_from_state(state: dict, job=None):
    """Rebuild the AutoML or grid object from its durable spec and train
    it with the restored member records: done members re-attach,
    pending and failed ones run, parked ones stay parked."""
    from h2o3_tpu_torch.core.dkv import DKV

    spec = state.get("spec") or {}
    kind = spec.get("kind")
    train = DKV.get(spec["training_frame"])
    valid = DKV.get(spec["validation_frame"]) \
        if spec.get("validation_frame") else None
    if kind == "automl":
        from h2o3_tpu_torch.automl.automl import H2OAutoML

        lb = DKV.get(spec["leaderboard_frame"]) \
            if spec.get("leaderboard_frame") else None
        aml = H2OAutoML(**(spec.get("spec") or {}))
        aml._search_job = job
        aml._resume_search_state = state
        aml.train(x=spec.get("x"), y=spec["y"], training_frame=train,
                  validation_frame=valid, leaderboard_frame=lb)
        DKV.put((spec.get("spec") or {}).get("project_name"), aml)
        return aml
    if kind == "grid":
        from h2o3_tpu_torch.grid import H2OGridSearch
        from h2o3_tpu_torch.models.model_builder import BUILDERS

        base = BUILDERS[spec["algo"]](**(spec.get("params") or {}))
        g = H2OGridSearch(base, spec["hyper"], grid_id=spec.get("grid_id"),
                          search_criteria=spec.get("criteria"))
        g._search_job = job
        g._resume_search_state = state
        g.train(x=spec.get("x"), y=spec.get("y"), training_frame=train,
                validation_frame=valid,
                recovery_dir=spec.get("recovery_dir"))
        return g
    raise ValueError(f"unknown search kind {kind!r}")


def apply_resume_op(p: dict) -> None:
    """The follower's side of a ``search_resume`` op: reload the same
    durable state from this process's checkpoint dir and replay the
    remaining members. Raises when it is unreadable: training on from
    nothing would fork the replayed programs."""
    from h2o3_tpu_torch.parallel import ckpt

    data = ckpt.load_search_state(p["search"])
    if data is None:
        raise RuntimeError(
            f"resumed {p.get('kind', 'search')} search {p['search']}: "
            f"durable search state is not readable on this process; "
            f"H2O_TPU_OPLOG_CKPT_DIR must be shared storage for a "
            f"cross-host search resume")
    run_from_state(data.get("state") or {})
