"""Cloud supervision: fold liveness and oplog errors into one health
state (counterpart of h2o3_tpu/parallel/supervisor.py).

Reference: water/HeartBeatThread.java — a node that misses enough beats is
declared dead and the cloud reacts (jobs against it fail, new work is
refused) instead of hanging on a peer that will never answer.

This module is that layer for the REST-driven cloud:

- a **state machine** HEALTHY → DEGRADED → FAILED → RECOVERING. Stale
  heartbeats degrade the cloud (and it recovers when beats resume); a
  follower replay crash (an ``oplog/error/{seq}`` key) fails it — the
  per-process program counters have diverged. FAILED is no longer
  terminal: a restarted follower that readmits (``oplog.rejoin``:
  checkpoint restore + suffix re-replay under a fresh incarnation) moves
  the cloud FAILED → RECOVERING, and when every rejoined incarnation is
  caught up with fresh beats and no error evidence remains, RECOVERING →
  HEALTHY — new multi-process ops are accepted again. Jobs failed while
  the cloud was down STAY failed (clients resubmit); only FAILED →
  HEALTHY without passing through RECOVERING is forbidden.
- a **supervisor thread** on the coordinator that re-evaluates the state
  every ``H2O_TPU_SUPERVISE_INTERVAL_S`` (default 2 s) and, on failure,
  marks every in-flight Job FAILED with the follower's traceback (their
  worker threads may be waiting on a dead follower and never unwind).
- **degraded-mode fail-fast**: `ensure_operable()` — called by
  ``oplog.broadcast`` — refuses new multi-process ops immediately with a
  clear :class:`~h2o3_tpu_torch.core.failure.CloudUnhealthyError`. Coordinator-
  local (single-process) scoring keeps serving.

Surfaced via ``GET /3/Cloud`` (``cloud_status`` field) and the dedicated
``GET /3/CloudStatus`` route.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from h2o3_tpu_torch.utils import retry

HEALTHY, DEGRADED, FAILED = "HEALTHY", "DEGRADED", "FAILED"
RECOVERING = "RECOVERING"

# re-entrant: evaluate() must hold it across its hold_until check AND the
# recover() transition, or a degrade(hold_s=...) landing between the two is
# instantly erased together with its hold
_LOCK = threading.RLock()
_STATE: Dict = {"state": HEALTHY, "since": time.time(), "reason": "",
                "remote_trace": "", "hold_until": 0.0,
                "incs_at_failure": {}}
_TRANSITIONS: List[dict] = []          # bounded history for /3/CloudStatus
_TRANSITIONS_MAX = 64
# first evaluate() timestamp: the grace window for processes that have
# NEVER heartbeat (a follower that died at startup has no stale row to
# trip on — absence past the staleness window is itself the signal)
_FIRST_EVAL_TS: Optional[float] = None


def interval_s() -> float:
    return retry.env_float("H2O_TPU_SUPERVISE_INTERVAL_S", 2.0)


def state() -> str:
    with _LOCK:
        return _STATE["state"]


def status() -> Dict:
    """Snapshot for the REST surface: current state + why + history."""
    with _LOCK:
        out = dict(_STATE)
        out["transitions"] = list(_TRANSITIONS)
    return out


def reset() -> None:
    """Back to HEALTHY with a clean history (cloud restart / tests)."""
    global _FIRST_EVAL_TS
    with _LOCK:
        _STATE.update(state=HEALTHY, since=time.time(), reason="",
                      remote_trace="", hold_until=0.0, incs_at_failure={})
        _TRANSITIONS.clear()
        _FIRST_EVAL_TS = None


def _transition(new: str, reason: str, remote_trace: str = "") -> bool:
    """Move to `new` if legal; returns True when the state changed.
    FAILED is sticky EXCEPT toward RECOVERING: replay divergence is only
    healed by a follower readmission (checkpoint restore + suffix
    re-replay under a fresh incarnation) or a cloud restart — never by
    fresh heartbeats alone."""
    with _LOCK:
        cur = _STATE["state"]
        if cur == new or (cur == FAILED and new != RECOVERING):
            return False
        _STATE.update(state=new, since=time.time(), reason=reason,
                      remote_trace=remote_trace)
        _TRANSITIONS.append({"ts": _STATE["since"], "from": cur, "to": new,
                             "reason": reason})
        if len(_TRANSITIONS) > _TRANSITIONS_MAX:
            del _TRANSITIONS[: len(_TRANSITIONS) - _TRANSITIONS_MAX]
    from h2o3_tpu_torch.obs import metrics as obs_metrics
    from h2o3_tpu_torch.utils import timeline
    from h2o3_tpu_torch.utils.log import get_logger

    log = get_logger()
    (log.error if new == FAILED else log.warning)(
        "cloud %s -> %s: %s", cur, new, reason)
    timeline.record("cloud", f"{cur}->{new}", reason=reason)
    obs_metrics.inc("h2o3_cloud_transitions_total", to=new)
    return True


def degrade(reason: str, hold_s: float = 0.0) -> None:
    """Mark the cloud DEGRADED: new multi-process ops are refused until it
    recovers. `hold_s` pins the state for at least that long — degrades
    whose evidence is NOT in the heartbeat table (ack timeouts, abandoned
    turnstile slots: the peer may be wedged yet still beating) must not be
    erased by the supervisor's next fresh-heartbeat evaluation."""
    changed = _transition(DEGRADED, reason)
    with _LOCK:
        if _STATE["state"] != DEGRADED:
            return
        if not changed:
            # already degraded: the newest evidence becomes the headline
            # (operators reading /3/CloudStatus see why it is STILL down)
            _STATE["reason"] = reason
        if hold_s > 0:
            _STATE["hold_until"] = max(_STATE.get("hold_until", 0.0),
                                       time.time() + hold_s)


def release_hold() -> None:
    """Lift an event-derived degrade hold ahead of its expiry — used when
    the event is positively resolved (e.g. a demoted ex-coordinator
    completed its rejoin as a follower), so the next evaluation can
    recover on liveness evidence instead of waiting out (or never
    outliving) the pin."""
    with _LOCK:
        _STATE["hold_until"] = 0.0


def recover(reason: str = "heartbeats fresh, no oplog errors") -> None:
    """DEGRADED/RECOVERING → HEALTHY when liveness (and, for RECOVERING,
    catch-up) evidence returns — never straight from FAILED: that edge
    only exists through RECOVERING (readmission) or reset()."""
    if _transition(HEALTHY, reason):
        with _LOCK:
            _STATE["hold_until"] = 0.0


def _incarnations_now() -> Dict[int, int]:
    """Highest incarnation currently on record per process, folded from
    the heartbeat table and any standing rejoin records. Snapshotted at
    fail() time so the FAILED -> RECOVERING gate can demand a STRICTLY
    newer incarnation — wall-clock comparisons would let cross-host clock
    skew block (or leftover records trigger) recovery."""
    from h2o3_tpu_torch.core import failure
    from h2o3_tpu_torch.parallel import oplog

    incs: Dict[int, int] = {}
    for r in failure.cluster_health(stale_after_s=float("inf")):
        if r.get("process") is not None:
            incs[int(r["process"])] = int(r.get("incarnation", 0))
    for p, i in oplog.expected_incarnations().items():
        incs[p] = max(incs.get(p, 0), i)
    return incs


def fail(reason: str, remote_trace: str = "") -> None:
    """Mark the cloud FAILED (follower replay crash: program counters
    diverged) and fail every in-flight Job with the remote traceback.
    Jobs are failed ONCE, here — a later recovery readmits the cloud for
    NEW ops but never resurrects a job built against the diverged state."""
    incs = _incarnations_now()
    with _LOCK:
        if not _transition(FAILED, reason, remote_trace):
            return
        _STATE["incs_at_failure"] = incs
    # a FAILED cloud is exactly the moment evidence starts evaporating
    # (jobs get failed, clients give up): dump the flight record NOW so
    # the postmortem has the timeline/spans/metrics as they stood
    from h2o3_tpu_torch.obs import flight

    flight.record_flight("cloud_failed",
                         extra={"reason": reason,
                                "remote_trace": remote_trace[-2000:]})
    _fail_running_jobs(reason, remote_trace)


def begin_recovery(reason: str) -> bool:
    """FAILED → RECOVERING: readmission evidence arrived (a rejoin record
    under a fresh incarnation). New multi-process ops stay refused until
    every rejoined incarnation is caught up (then RECOVERING → HEALTHY)."""
    return _transition(RECOVERING, reason)


def ensure_operable() -> None:
    """Degraded-mode fail-fast for new multi-process ops."""
    from h2o3_tpu_torch.core.failure import CloudUnhealthyError

    with _LOCK:
        st, reason, trace = (_STATE["state"], _STATE["reason"],
                             _STATE["remote_trace"])
    if st != HEALTHY:
        raise CloudUnhealthyError(
            f"cloud is {st} ({reason}) — refusing new multi-process op; "
            "single-process scoring stays available", remote_trace=trace)


def _fail_running_jobs(reason: str, remote_trace: str) -> None:
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.core.job import Job

    msg = f"cloud FAILED while this job was in flight: {reason}"
    if remote_trace:
        msg += f"\n--- remote traceback ---\n{remote_trace}"
    for k in list(DKV.keys()):
        j = DKV.get(k)
        if isinstance(j, Job) and j.is_running:
            j.fail(msg)


def evaluate() -> str:
    """One supervision pass: fold oplog error keys and the heartbeat table
    into the state machine. Returns the resulting state. Deterministic and
    thread-free — the chaos tests drive it directly; the Supervisor thread
    just calls it on a timer."""
    global _FIRST_EVAL_TS
    from h2o3_tpu_torch.core import failure
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import oplog

    failure.faultpoint("supervisor.evaluate")
    if _FIRST_EVAL_TS is None:
        _FIRST_EVAL_TS = time.time()
    if D.process_count() > 1:
        # leadership-view refresh: a returned ex-coordinator discovers a
        # standby's newer epoch here (within one supervision tick) and
        # demotes instead of broadcasting against a cloud it lost
        oplog.maybe_demote()
    errors = oplog.error_records()
    fatal = [(s, r) for s, r in errors if r.get("fatal", True)]
    if fatal:
        seq, rec = fatal[0]
        fail(f"follower replay of op {seq} ({rec.get('kind', '?')}) crashed",
             str(rec.get("trace", "")))
        return state()
    if errors:
        # non-fatal follower faults only (e.g. a lost ack write after a
        # successful replay): the op stream did not diverge — degrade, and
        # hold so fresh beats from the faulting peer don't erase it while
        # the record stands
        seq, rec = errors[0]
        degrade(f"follower non-fatal oplog fault at op {seq} "
                f"({rec.get('kind', '?')}): "
                f"{str(rec.get('trace', ''))[-200:]}",
                hold_s=failure.heartbeat_stale_s())
        return state()
    # -- readmission arc: FAILED -> RECOVERING -> HEALTHY ----------------
    if state() == FAILED:
        # fresh = an incarnation STRICTLY newer than the one on record at
        # fail() time — not a wall-clock comparison, which cross-host
        # clock skew would defeat (a rejoin stamped a few seconds "before"
        # the failure would block the arc forever)
        incs0 = status().get("incs_at_failure") or {}
        fresh = [r for r in oplog.rejoin_records()
                 if r.get("proc") is not None
                 and int(r.get("inc", 0)) > int(incs0.get(int(r["proc"]), 0))]
        if fresh:
            begin_recovery(
                f"process(es) {[r.get('proc') for r in fresh]} rejoined "
                "with fresh incarnation(s); replaying oplog suffix from "
                "checkpoint")
    if state() == RECOVERING:
        recs = oplog.rejoin_records()
        health = failure.cluster_health()
        health_by = {r["process"]: r for r in health}
        # every rejoined incarnation caught up AND no process anywhere in
        # the cluster gone stale — a SECOND follower dying during the
        # outage (no rejoin record of its own) must keep us out of
        # HEALTHY, or new ops get accepted and burn the full ack timeout
        stale = [r["process"] for r in health if not r["healthy"]]
        # ... including a peer that died leaving NO heartbeat row (same
        # never-beat signal as the degrade path below: absence past the
        # staleness window, measured from supervision start)
        missing_dead = (D.process_count() - len(health) > 0
                        and time.time() - _FIRST_EVAL_TS
                        > failure.heartbeat_stale_s())
        caught_up = bool(recs) and not stale and not missing_dead and all(
            r.get("phase") == "caught_up"
            and health_by.get(r.get("proc"), {}).get("healthy", False)
            and health_by.get(r.get("proc"), {}).get("incarnation", 0)
            >= int(r.get("inc", 0))
            for r in recs)
        if caught_up:
            recover("all rejoined incarnations caught up (checkpoint + "
                    "suffix replayed, heartbeats fresh, no oplog errors)")
        return state()
    health = failure.cluster_health()
    expected = D.process_count()
    if expected > 1:
        stale_s = failure.heartbeat_stale_s()
        dead = [r for r in health if not r["healthy"]]
        missing = expected - len(health)
        if dead:
            degrade("stale heartbeat from process(es) "
                    f"{[r['process'] for r in dead]} (age > {stale_s:.1f}s)")
        elif missing > 0 and time.time() - _FIRST_EVAL_TS > stale_s:
            # a process that NEVER beat has no stale row to trip on —
            # absence past the staleness window is the death signal (a
            # follower that crashed at startup)
            degrade(f"{missing} process(es) have never heartbeat "
                    f"(> {stale_s:.1f}s after supervision start)")
        elif health and missing <= 0:
            with _LOCK:
                # check-and-recover under one lock acquisition: a concurrent
                # degrade(hold_s=...) from an ack-timeout handler must either
                # land before (hold observed, no recovery) or after (its hold
                # survives the transition) — never in between
                if time.time() >= _STATE.get("hold_until", 0.0):
                    # fresh beats only recover once any event-derived degrade
                    # (ack timeout / turnstile abandonment) has aged out — a
                    # wedged peer can keep beating while not replaying
                    recover()
    return state()


class Supervisor:
    """Background evaluator (coordinator-side HeartBeatThread analog).

    Owns the autonomous recovery watchdog (parallel/watchdog.py) when
    ``H2O_TPU_AUTO_RECOVER`` is on: supervision detects the failures, the
    watchdog's daemon thread performs the recoveries — elections, rejoins,
    durable-job resumes — with no operator in the loop."""

    def __init__(self, interval: Optional[float] = None):
        self.interval = interval_s() if interval is None else float(interval)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.watchdog = None

    def start(self) -> "Supervisor":
        from h2o3_tpu_torch.utils.log import get_logger

        def run():
            from h2o3_tpu_torch.parallel import oplog

            while not self._stop.wait(self.interval):
                try:
                    evaluate()
                    # a rejoiner's op that needs its peers (ROADMAP C47)
                    oplog.serve_joint_replays()
                except Exception as e:   # noqa: BLE001 — a transient KV
                    # hiccup must not kill supervision for good; but a
                    # PERMANENTLY-failing evaluate dying silently is an
                    # outage multiplier — leave a trace
                    get_logger().debug("supervisor tick failed "
                                       "(will retry): %s", e)

        try:
            evaluate()
        except Exception as e:   # noqa: BLE001
            get_logger().debug("initial supervision pass failed "
                               "(thread will retry): %s", e)
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="h2o3-supervisor")
        self._thread.start()
        from h2o3_tpu_torch.parallel import watchdog as _wd

        # at most ONE watchdog per process: a standby whose own watchdog
        # just won the election re-enters here via start_server — stacking
        # a second ticker would double every recovery scan and corrupt the
        # module-level counters
        if _wd.enabled() and not _wd.status().get("running"):
            self.watchdog = _wd.Watchdog().start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
