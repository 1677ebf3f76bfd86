"""The autonomous recovery watchdog (counterpart of
h2o3_tpu/parallel/watchdog.py): every recovery the control plane offers
happens without an operator.

Each tick (on the supervisor's thread, or driven by hand in tests) it
takes at most one action:

- a **demoted ex-coordinator** rejoins as a follower
  (``distributed.rejoin()``), the remediation its demotion error names;
- a **crashed follower** (``oplog.replay_crashed()``) rejoins too, so a
  FAILED cloud walks RECOVERING -> HEALTHY by itself;
- a **follower watching a silent leader** runs the standby election once
  the leader's heartbeat is stale past ``H2O_TPU_ELECTION_GRACE_S``
  (``oplog.assume_coordination``; pass ``api.server.assume_coordination``
  as ``elect`` to bind REST on a win). ``ElectionLost`` means standing by;
- the **coordinator of a workable cloud** re-dispatches externally
  failed jobs that left durable progress (`resume_failed_jobs`: FAILED
  -> RESUMING -> RUNNING -> DONE from the last durable iteration, under
  the original key), then orphaned AutoML and grid searches that left
  durable search state (``automl/search.resume_orphaned``).

``H2O_TPU_AUTO_RECOVER=0`` turns every action off (manual drills, tests
that drive transitions by hand). A replay thread the watchdog spawns
retires after ``H2O_TPU_REPLAY_IDLE_S`` idle seconds, or, unset, after
20 times the median gap between recent ops (2 min to 1 h; 15 min before
any op). Its state is on ``GET /3/CloudStatus``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from h2o3_tpu_torch.utils import retry

_LOCK = threading.Lock()
_STATE: Dict = {"ticks": 0, "elections": 0, "rejoins": 0,
                "jobs_resumed": 0, "searches_resumed": 0,
                "last_action": "", "last_error": "",
                "last_tick": 0.0, "running": False}

# a job that keeps dying is not resumed forever (poisoned input, a bug in
# the trainer): after this many dispatches it stays FAILED for the client
MAX_ATTEMPTS = 5


def enabled() -> bool:
    """Autonomous recovery master switch (env ``H2O_TPU_AUTO_RECOVER``,
    default on — set 0 for manual drills / hand-driven chaos tests)."""
    return retry.env_int("H2O_TPU_AUTO_RECOVER", 1) != 0


# adaptive replay idle bounds: never retire under traffic jitter, never
# pin an idle thread for the old fixed hour
_REPLAY_IDLE_MIN_S = 120.0
_REPLAY_IDLE_MAX_S = 3600.0
_REPLAY_IDLE_DEFAULT_S = 900.0


def replay_idle_timeout_s() -> float:
    """Idle timeout for watchdog-spawned replay threads.

    ``H2O_TPU_REPLAY_IDLE_S`` > 0 pins it; otherwise it ADAPTS to observed
    op traffic (oplog.observed_op_gap_s): 20× the median inter-op gap,
    clamped to [2 min, 1 h], defaulting to 15 min before any traffic has
    been seen. Replaces the fixed 3600 s that kept replay threads (and
    whatever their last replayed op pinned) alive for an hour on an idle
    cloud while ALSO being too short for genuinely slow op cadences."""
    pinned = retry.env_int("H2O_TPU_REPLAY_IDLE_S", 0)
    if pinned > 0:
        return float(pinned)
    from h2o3_tpu_torch.parallel import oplog

    gap = oplog.observed_op_gap_s()
    if gap is None:
        return _REPLAY_IDLE_DEFAULT_S
    return float(min(max(20.0 * gap, _REPLAY_IDLE_MIN_S),
                     _REPLAY_IDLE_MAX_S))


def status() -> Dict:
    """Snapshot for GET /3/CloudStatus."""
    with _LOCK:
        out = dict(_STATE)
    out["enabled"] = enabled()
    out["replay_idle_timeout_s"] = round(replay_idle_timeout_s(), 1)
    return out


def reset() -> None:
    """Clear the counters (tests / cloud restart)."""
    with _LOCK:
        _STATE.update(ticks=0, elections=0, rejoins=0, jobs_resumed=0,
                      searches_resumed=0, last_action="", last_error="",
                      last_tick=0.0)
    _STRIKES.clear()
    from h2o3_tpu_torch.automl import search

    search._STRIKES.clear()


def _note(action: str, **counters) -> str:
    with _LOCK:
        _STATE["last_action"] = action
        for k, v in counters.items():
            _STATE[k] = _STATE.get(k, 0) + v
    return action


# ---------------------------------------------------------------------------
# job resume: FAILED(externally) + durable progress -> re-dispatch
# ---------------------------------------------------------------------------

def resume_failed_jobs() -> List[str]:
    """Re-dispatch every externally-failed job that persisted durable
    training progress; returns the job keys resumed. Jobs whose Job object
    did not survive to this process (a standby coordinator whose
    control-plane checkpoint predates the job) are RECREATED under their
    original key from the progress file's spec, so clients polling
    ``GET /3/Jobs/{id}`` watch the same id across the handoff."""
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.core.job import Job
    from h2o3_tpu_torch.parallel import ckpt

    resumed: List[str] = []
    for rec in ckpt.job_progress_records():
        jk = str(rec.get("job"))
        job = DKV.get(jk)
        data = None
        if job is None:
            # post-handoff: the Job object lived on the dead coordinator —
            # this recreate path is the only one that pays the full state
            # load before the cheap verdict checks
            data = ckpt.load_job_progress(jk)
            if data is None:
                _strike(jk)              # unreadable: bounded retries
                continue
            spec = data.get("spec") or {}
            if not spec.get("algo"):
                # no re-dispatch recipe in the FILE either: no process can
                # ever act on this record — GC it now
                ckpt.delete_job_progress(jk)
                continue
            job = _recreate_job(jk, spec)
        if not isinstance(job, Job):
            continue
        # cheap verdict checks BEFORE unpickling the training state (the
        # record for a large RUNNING build sits here on every tick)
        if job.status in (Job.DONE, Job.CANCELLED) or \
                (job.status == Job.FAILED and not job.failed_externally):
            # nobody will ever resume this progress (completed: the model
            # supersedes it; worker-crashed/cancelled: the client's to
            # resubmit) — GC the file + record instead of leaking them
            ckpt.delete_job_progress(jk)
            continue
        if not (job.status == Job.FAILED and job.failed_externally):
            continue                     # RUNNING/RESUMING: leave it be
        if job.attempt >= MAX_ATTEMPTS:
            ckpt.delete_job_progress(jk)   # parked for good
            continue
        if data is None:
            data = ckpt.load_job_progress(jk)
        if data is None:
            # torn/corrupt progress file: count the pass so the attempt
            # cap parks (and GCs) it instead of re-reading it every tick
            job.attempt += 1
            job.exception = (f"resume dispatch pass {job.attempt}: durable "
                             f"progress for {jk} is unreadable")
            continue
        if _dispatch_resume(job, data.get("spec") or {}, data):
            resumed.append(jk)
    return resumed


def resume_orphaned_searches() -> List[str]:
    """Re-dispatch every orphaned AutoML/grid search that persisted
    durable search state (automl/search.py owns the machinery; the
    lazy import keeps the recovery layer free of workload imports)."""
    from h2o3_tpu_torch.automl import search

    return search.resume_orphaned()


# bounded retries for records whose Job is gone AND whose progress file is
# unreadable: a transient shared-storage blip deserves another look, a
# permanently torn file must not be re-probed every tick forever
_STRIKES: Dict[str, int] = {}


def _strike(job_key: str) -> None:
    from h2o3_tpu_torch.parallel import ckpt

    _STRIKES[job_key] = _STRIKES.get(job_key, 0) + 1
    if _STRIKES[job_key] >= MAX_ATTEMPTS:
        ckpt.delete_job_progress(job_key)
        _STRIKES.pop(job_key, None)
        from h2o3_tpu_torch.utils.log import get_logger

        get_logger().warning(
            "watchdog: durable progress for job %s was unreadable %d "
            "times — record dropped", job_key, MAX_ATTEMPTS)


def _recreate_job(job_key: str, spec: dict):
    """Rebuild a Job shell under its ORIGINAL key (post-handoff: the new
    leader's DKV may predate the job) so the resume is client-visible."""
    from h2o3_tpu_torch.core.dkv import DKV, Key
    from h2o3_tpu_torch.core.job import Job

    job = Job(description=spec.get("description")
              or f"{spec.get('algo')} Model Build",
              dest=spec.get("model_id"))
    job.dest_type = "Key<Model>"
    job.dest_key = spec.get("model_id")
    DKV.remove(str(job.key))             # drop the auto-made key
    job._key = Key(job_key)
    job.status = Job.FAILED
    job.failed_externally = True
    job.exception = ("job was in flight when its coordinator died; "
                     "recreated from durable progress for resume")
    job.resume_spec = dict(spec)
    job.install()
    return job


def _dispatch_resume(job, spec: dict, data: dict) -> bool:
    """One re-dispatch: RESUMING (atomic — two recovery passes can never
    double-dispatch), rebuild the builder with the restored loop state,
    broadcast the resume op so followers fast-forward from the same file,
    and run the train on the job's (new) worker thread."""
    from h2o3_tpu_torch.core.dkv import DKV, Key
    from h2o3_tpu_torch.core.job import Job
    from h2o3_tpu_torch.models.model_builder import BUILDERS
    from h2o3_tpu_torch.parallel import oplog

    cls = BUILDERS.get(spec.get("algo"))
    train = DKV.get(str(spec.get("training_frame") or ""))
    if cls is None or train is None:
        # not re-dispatchable HERE (unknown builder / frame not in this
        # DKV): count the pass so MAX_ATTEMPTS eventually parks the job
        # instead of it being re-probed on every tick forever
        job.attempt += 1
        what = (f"unknown algo {spec.get('algo')!r}" if cls is None else
                f"training frame {spec.get('training_frame')!r} is not in "
                f"this process's DKV")
        job.exception = f"resume dispatch pass {job.attempt}: {what}"
        return False
    valid = DKV.get(str(spec["validation_frame"])) \
        if spec.get("validation_frame") else None
    if not job.restart(resumed_from_iteration=data.get("iteration")):
        return False
    y = spec.get("y")
    dest = spec.get("model_id") or job.dest
    params = dict(spec.get("params") or {})
    if oplog.active() and float(params.get("max_runtime_secs") or 0.0) > 0:
        # re-broadcast resume on a multi-process cloud: the wall-clock
        # budget is per-process time and would desynchronize the mirrored
        # fit loops (the train/grid handlers clear it the same way; a
        # resume whose ORIGINAL submit predates that fix may still carry
        # one in its durable spec)
        params["max_runtime_secs"] = 0.0
        spec = dict(spec, params=params)
    try:
        builder = cls(**params)
    except Exception as e:   # noqa: BLE001 — param drift is deterministic:
        # fail_local keeps failed_externally False so the identical doomed
        # rebuild is NOT retried on the next recovery pass
        job.fail_local(f"resume dispatch failed rebuilding the "
                       f"{spec.get('algo')} builder: {e}")
        return False
    builder._progress_job = job
    builder._resume_state = data.get("state")
    op_seq = None
    if oplog.active():
        try:
            op_seq = oplog.broadcast("train", {
                "algo": spec["algo"], "params": spec.get("params"),
                "training_frame": spec.get("training_frame"),
                "validation_frame": spec.get("validation_frame"),
                "y": y, "model_id": dest, "resume_job": str(job.key)})
        except Exception as e:   # noqa: BLE001 — cloud relapsed mid-resume
            job.fail(f"resume dispatch could not broadcast: {e}")
            return False

    def run(j):
        with oplog.turn(op_seq):
            model = builder.train(y=y, training_frame=train,
                                  validation_frame=valid)
            if j.status == Job.FAILED:
                # an external FAILED landed mid-train: the wrapper
                # discards the result — installing it at dest would serve
                # a model built against a diverged cloud
                return model
            # the REST train handler's re-home, inside the op's turn: the
            # client captured dest at submit, and a checkpoint right after
            # the op holds the model under the key followers replayed to
            old = str(model.key)
            if dest and old != dest:
                DKV.remove(old)
                model._key = Key(dest)
            if dest:
                DKV.put(dest, model)
            model._parms.setdefault("training_frame", str(train.key))
        return model

    job.start(run, background=True)
    from h2o3_tpu_torch.utils import timeline

    timeline.record("cloud", "job_resumed", job=str(job.key),
                    attempt=job.attempt,
                    from_iteration=data.get("iteration"))
    from h2o3_tpu_torch.utils.log import get_logger

    get_logger().warning(
        "watchdog: resumed job %s (attempt %d) from iteration %s",
        job.key, job.attempt, data.get("iteration"))
    return True


# ---------------------------------------------------------------------------
# the watchdog itself
# ---------------------------------------------------------------------------

class Watchdog:
    """One recovery action per tick; never raises out of tick().

    `elect` overrides the election action (default
    ``oplog.assume_coordination`` — pass ``api.server.assume_coordination``
    to re-bind REST on a win). `follow=True` spawns a follower replay loop
    after an auto-rejoin so the readmitted process resumes replay duty."""

    def __init__(self, interval: Optional[float] = None,
                 elect: Optional[Callable] = None, follow: bool = True):
        from h2o3_tpu_torch.parallel import supervisor

        self.interval = (supervisor.interval_s() if interval is None
                         else float(interval))
        self._elect = elect
        self.follow = follow
        self._born = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._follower_thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Watchdog":
        def run():
            while not self._stop.wait(self.interval):
                self.tick()

        with _LOCK:
            _STATE["running"] = True
        self.tick()
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="h2o3-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with _LOCK:
            _STATE["running"] = False

    # -- one pass ---------------------------------------------------------
    def tick(self) -> str:
        """Evaluate the cloud and take at most one recovery action.
        Returns a short tag naming what happened (tests assert on it)."""
        from h2o3_tpu_torch.parallel import distributed as D
        from h2o3_tpu_torch.parallel import oplog, supervisor

        if not enabled():
            return _note("disabled")
        with _LOCK:
            _STATE["ticks"] += 1
            _STATE["last_tick"] = time.time()
        from h2o3_tpu_torch.obs import metrics as obs_metrics

        obs_metrics.maybe_publish()     # keep this process's series fresh
        try:
            if D.process_count() > 1:
                oplog.maybe_demote()
            if oplog.demoted():
                return self._auto_rejoin("demoted ex-coordinator")
            if not D.is_coordinator():
                if oplog.replay_crashed():
                    return self._auto_rejoin("crashed follower")
                return self._maybe_elect()
            # coordinator: fold evidence, then revive resumable work. The
            # evaluate() here makes the watchdog self-sufficient when the
            # Supervisor thread is parked (long intervals / tests).
            st = supervisor.evaluate()
            if st == supervisor.HEALTHY or D.process_count() <= 1:
                got = resume_failed_jobs()
                if got:
                    from h2o3_tpu_torch.obs import flight

                    flight.record_flight("watchdog_job_resume",
                                         extra={"jobs": got})
                    return _note(f"resumed jobs {got}",
                                 jobs_resumed=len(got))
                sr = resume_orphaned_searches()
                if sr:
                    from h2o3_tpu_torch.obs import flight

                    flight.record_flight("watchdog_search_resume",
                                         extra={"searches": sr})
                    return _note(f"resumed searches {sr}",
                                 searches_resumed=len(sr))
            return _note("idle")
        except Exception as e:   # noqa: BLE001 — a transient KV fault must
            with _LOCK:          # not kill recovery for good
                _STATE["last_error"] = f"{type(e).__name__}: {e}"
            return "error"

    def _auto_rejoin(self, why: str) -> str:
        from h2o3_tpu_torch.parallel import distributed as D

        cursor = D.rejoin()
        if self.follow:
            self._spawn_follower(cursor)
        from h2o3_tpu_torch.obs import flight
        from h2o3_tpu_torch.utils.log import get_logger

        # every autonomous recovery action leaves a flight record: the
        # state that FORCED the action is the postmortem evidence
        flight.record_flight("watchdog_rejoin",
                             extra={"why": why, "caught_up_seq": cursor})
        get_logger().warning("watchdog: auto-rejoined as follower (%s), "
                             "caught up to seq %d", why, cursor)
        return _note(f"rejoined ({why})", rejoins=1)

    def _spawn_follower(self, cursor: int) -> None:
        from h2o3_tpu_torch.parallel import oplog

        t = self._follower_thread
        if t is not None and t.is_alive():
            return
        self._follower_thread = threading.Thread(
            target=lambda: oplog.follower_loop(
                idle_timeout_s=replay_idle_timeout_s(), start_seq=cursor),
            daemon=True, name="h2o3-watchdog-follower")
        self._follower_thread.start()

    def _maybe_elect(self) -> str:
        from h2o3_tpu_torch.core import failure
        from h2o3_tpu_torch.parallel import distributed as D
        from h2o3_tpu_torch.parallel import oplog

        rec = D.epoch_record()
        grace = failure.election_grace_s()
        rows = {r["process"]: r
                for r in failure.cluster_health(stale_after_s=grace)}
        lead = rows.get(rec["leader"])
        if lead is not None and lead["age_s"] < grace:
            return _note("follower (leader alive)")
        if lead is None and time.monotonic() - self._born < grace:
            # no heartbeat row is NOT silence evidence during boot: a
            # follower's watchdog can start before the coordinator's first
            # beat lands — electing now would steal a healthy cloud
            return _note("follower (no leader evidence yet)")
        try:
            elect = self._elect or oplog.assume_coordination
            elect()
        except oplog.ElectionLost as e:
            return _note(f"standing by ({e})")
        from h2o3_tpu_torch.obs import flight
        from h2o3_tpu_torch.utils.log import get_logger

        flight.record_flight("watchdog_election",
                             extra={"epoch": D.epoch(),
                                    "old_leader": rec["leader"]})
        get_logger().warning("watchdog: won the standby election "
                             "(epoch %d)", D.epoch())
        return _note("elected", elections=1)
