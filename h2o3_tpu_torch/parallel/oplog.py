"""The operation log: the cross-process control plane of REST-driven
work (counterpart of h2o3_tpu/parallel/oplog.py).

Reference: in the JVM cloud any node takes a REST request and fans the
work out over RPC (water/RPC.java). Here the coordinator appends each op
a REST handler runs (its kind and metadata: paths, keys, parameters) to
a sequence in the cloud KV (``oplog/{seq}``, over the
``torch.distributed`` store of parallel/distributed.py), and every
follower replays the ops in order (`follower_loop`) through the same
framework call, so each process holds the same frames and models. Data
never travels here: files are read from the shared filesystem by every
process, as the parse tier already does.

Every hand-off is acknowledged and bounded. A follower writes
``oplog/ack/{seq}/{proc}`` after each replay; the coordinator's `turn()`
ends with `wait_acks(seq)`, which raises
:class:`~h2o3_tpu_torch.core.failure.CloudUnhealthyError` with the
remote traceback from ``oplog/error/{seq}`` when a replay crashed, or a
timeout diagnosis when a follower went silent. `publish()` retries lost
puts and rolls its sequence slot back on failure, so a lost op never
leaves a follower stalled at a gap. A restarted follower readmits from
the newest control-plane checkpoint (`rejoin`); a standby takes over a
silent coordinator (`assume_coordination`, the epoch record written
first-writer-wins).

A train op on a row-sharded cloud (parallel/mesh.py) keeps step with
its followers through its collectives: every histogram, leaf sum and
metric is an all-reduce that every rank joins. A follower lost mid-train
ends the coordinator's collective with CloudUnhealthyError (at once when
its sockets close, at the latest at the mesh's timeout); the cloud
FAILs and the op's slot becomes a noop, so a rejoin does not replay a
train its peers cannot join. An op that completed a collective whose
result it keeps (a train, an import) ends in a control-plane checkpoint
of its own: the coordinator snapshots inside the op's turn, every
follower writes its rows as a rank section before it acknowledges, and
the checkpoint is booked once every follower did. A follower that dies
after such an op's last collective but before its section and ack
leaves the op unbooked in the suffix (ROADMAP C47): the rejoin's solo
replay of it meets a collective, and the rejoiner then replays that op
jointly (`_joint_replay`): it asks the coordinator through
``oplog/joint/{seq}``, the coordinator's supervisor tick runs the op
again beside it in the mesh's new generation (`serve_joint_replays`),
snapshots the result and books the checkpoint once the rejoiner, its
section written, acknowledged. The coordinator refuses (and the rejoin
fails) when a second run would not see what the first saw: the op
replaced a DKV object that existed before it (recorded at the op's end
as ``oplog/rewrites/{seq}``), a later op changed state, or a third
process would have to join. The fault point
``oplog.replay.collectives_done`` marks that window. A REST-serving
coordinator never enters a collective outside an op's turn
(`unmirrored_collective_risk`): the followers would never join it; the
threads an op starts for its members (AutoML, grids) carry its context
(`op_context`, `adopt_op_context`).
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
import traceback
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from h2o3_tpu_torch.core import failure
from h2o3_tpu_torch.parallel import distributed as D
from h2o3_tpu_torch.utils import retry

_SEQ = 0
_PREFIX = "oplog"
_RAPIDS_SESSIONS: Dict[str, Any] = {}     # follower-side session mirror

# coordinator-side execution turnstile: broadcast order == execution
# order. REST jobs run in background threads, so without this two
# concurrent requests could run in the opposite order from the follower's
# strictly sequential replay, and the two processes' DKVs would fork.
_EXEC_COND = threading.Condition()
_NEXT_EXEC = 0
# ops whose holder gave up (turn timeout) or died: the turnstile skips
# them instead of waiting forever on a thread that will never arrive
_ABANDONED: set = set()
# the seq currently INSIDE its turn (None between turns): lets a timed-out
# waiter tell a slow-but-alive head holder (leave it be) from one that
# died before ever entering its turn (release its slot)
_EXECUTING: Optional[int] = None
# turnstile epoch: reset() bumps it, and a turn that entered under an
# older epoch must NOT advance the new epoch's _NEXT_EXEC on exit — a
# straggler op thread outliving a cloud restart would otherwise clobber
# the restarted sequence mid-stream
_GEN = 0
# when the turnstile head last moved (advance/enter/exit), monotonic. A
# waiter only declares the head holder DEAD if the head has sat idle —
# parked on the same slot with nobody executing — for a full grace
# window: a LIVE holder between publish and turn enters within one
# cond-wait tick, so transient _EXECUTING==None gaps must not read as
# death (they would sticky-FAIL a merely backlogged cloud)
_HEAD_IDLE_SINCE = 0.0
_HEAD_GRACE_S = 5.0
# publish() runs on concurrent REST handler threads: sequence allocation
# and the kv_put must be atomic or two ops can claim the same slot (one
# overwrites the other in the KV and the follower stalls at the gap)
_PUB_LOCK = threading.Lock()
# coordinator-side seq -> op identity token. Acks are matched on the
# TOKEN, not just the slot number: a rolled-back slot can be reclaimed by
# a different op (that is the rollback contract), and an indeterminate
# kv_put (reported lost but actually landed) can leave a follower ack for
# the ORIGINAL op under the same seq — which must not satisfy wait_acks
# for the reclaiming op.
_OP_IDS: Dict[int, str] = {}
_OP_IDS_CAP = 4096
# coordinator-side seq -> op kind, for `turn` (pruned with _OP_IDS)
_OP_KINDS: Dict[int, str] = {}
# op kinds whose collectives keep no state (a predict's metrics, a
# download's gather): a rejoin's solo replay skips those collectives, so
# the op stays replayable without a checkpoint of its own
_SOLO_KINDS = frozenset({"noop", "checkpoint", "predict", "leaf_assignment",
                         "staged_proba", "score_batch", "gather"})


class OplogPublishError(RuntimeError):
    """An op could not be durably published to the cloud KV (after the
    retry budget); its claimed sequence slot was rolled back."""


class OplogTurnTimeout(RuntimeError):
    """The coordinator-side execution turnstile did not reach this op's
    slot within the deadline — an earlier ticket holder is wedged or died
    before entering its turn. The slot is abandoned (later ops skip it)."""


class OplogAckError(RuntimeError):
    """A follower replayed an op but could not durably write its ack (after
    a second retry round on top of kv_put's own budget). The follower must
    not proceed silently: to the coordinator a lost ack is
    indistinguishable from this process dying."""


# reentrancy guard: while the coordinator executes an op inside turn() (or
# a follower replays one in _apply), nested framework calls — AutoML's base
# models, CV submodels, grid entries — must NOT broadcast their own ops:
# the follower replays the TOP-level op and re-runs the nested programs
# itself, so a nested broadcast would double-execute them on the follower.
_TLS = threading.local()

# set by api.server.start_server: this process is the coordinator of a
# REST-driven cloud, so mirrored work on handler threads is only legal
# inside a broadcast op's turn (the follower replays ops, nothing else).
REST_SERVING = False

# set when this process discovers a NEWER epoch record naming another
# leader while it believed itself the coordinator: it must refuse to run
# multi-process ops (locally OR broadcast) until it rejoins as a follower
_DEMOTED = False

# set when THIS process's replay loop died on a replay crash: the recovery
# watchdog reads it to nudge the failed follower through rejoin() without
# an operator; rejoin() clears it
_REPLAY_CRASHED = False


def demoted() -> bool:
    """True when this process lost coordination to a newer epoch and has
    not yet rejoined as a follower (see maybe_demote)."""
    return _DEMOTED


def replay_crashed() -> bool:
    """True when this process's follower replay loop crashed and it has
    not yet rejoined (the watchdog's auto-rejoin trigger)."""
    return _REPLAY_CRASHED


# recent op arrival times (coordinator: publish; follower: replay) — the
# signal the watchdog's ADAPTIVE replay idle timeout is derived from: a
# busy cloud keeps its replay threads patient, an idle one lets them
# retire quickly instead of pinning a thread for a fixed hour
_OP_TIMES: "collections.deque[float]" = collections.deque(maxlen=32)


def note_op_seen() -> None:
    _OP_TIMES.append(time.time())


def observed_op_gap_s() -> Optional[float]:
    """Median gap between recently seen ops (seconds); None until at least
    two ops have been observed this process-lifetime."""
    ts = list(_OP_TIMES)
    if len(ts) < 2:
        return None
    gaps = sorted(b - a for a, b in zip(ts, ts[1:]))
    return float(gaps[len(gaps) // 2])


def _in_op() -> bool:
    return bool(getattr(_TLS, "in_op", False))


def unmirrored_collective_risk() -> bool:
    """True when the calling thread is about to run a collective the other
    processes will NOT mirror: coordinator of a REST-serving multi-process
    cloud, outside any op turn."""
    return (REST_SERVING and D.process_count() > 1 and D.is_coordinator()
            and not _in_op())


def _collectives() -> int:
    """Collectives this process's row mesh completed so far (0 without
    one)."""
    from h2o3_tpu_torch.parallel import mesh

    m = mesh.current()
    return m.stats()["collectives"] if m is not None else 0


def _keeps_collective_state(kind: Optional[str], since: int) -> bool:
    """True when an op of `kind` completed a collective since the count
    `since` and keeps what it computed: a rejoin could not replay it
    alone, so the op ends in a checkpoint."""
    return kind not in _SOLO_KINDS and _collectives() != since


def defer_booking(rec: Dict[str, Any]) -> bool:
    """Called by parallel/ckpt.py with a snapshot written for op
    ``rec["seq"]``: when this thread holds that op's turn, the turn
    books it once every follower acknowledged the op (True); else the
    caller books it now (False)."""
    if not _in_op() or getattr(_TLS, "seq", None) != rec.get("seq"):
        return False
    _TLS.pending_ckpt = rec
    return True


def solo_replay() -> bool:
    """True while this thread replays a rejoin's suffix: its peers are
    not replaying with it, so no collective can complete (an op that
    needs one fails the rejoin at once instead of waiting out the mesh's
    timeout; a predict's metrics, which no state keeps, are skipped)."""
    return bool(getattr(_TLS, "solo", False))


def note_collective_failure(msg: str) -> None:
    """A collective of the row mesh failed in this process. Inside a
    coordinator's op the cloud FAILs (its running jobs fail from outside,
    so the watchdog may resume them after a rejoin) and the op's slot is
    marked to become a noop."""
    seq = getattr(_TLS, "seq", None)
    if seq is None or not getattr(_TLS, "in_op", False):
        return
    _TLS.collective_failed = True
    from h2o3_tpu_torch.parallel import supervisor

    supervisor.fail(f"op {seq}: {msg}")


def active() -> bool:
    """Coordinator with followers attached: REST handlers must broadcast."""
    return D.process_count() > 1 and D.is_coordinator() and not _in_op()


def _turn_timeout_s() -> float:
    return retry.env_float("H2O_TPU_TURN_TIMEOUT_S", 1800.0)


def _ack_timeout_s() -> float:
    return retry.env_float("H2O_TPU_OP_ACK_TIMEOUT_S", 300.0)


def reset(next_seq: int = 0) -> None:
    """Reset the coordinator-side protocol state (sequence counter,
    turnstile, abandoned slots). Test/bootstrap/standby-takeover use."""
    global _SEQ, _NEXT_EXEC, _EXECUTING, _GEN, _HEAD_IDLE_SINCE
    global _REPLAY_CRASHED
    _REPLAY_CRASHED = False
    with _EXEC_COND:
        _SEQ = next_seq
        _NEXT_EXEC = next_seq
        _EXECUTING = None
        _GEN += 1
        _HEAD_IDLE_SINCE = time.monotonic()
        _ABANDONED.clear()
        _OP_IDS.clear()
        _OP_KINDS.clear()
        _EXEC_COND.notify_all()
    _JOINT_SERVED.clear()
    from h2o3_tpu_torch.parallel import ckpt

    ckpt.reset()


def snapshot_op_ids() -> Dict[int, str]:
    """Recent op identity tokens, for the control-plane checkpoint: a
    coordinator restored from it can still match in-flight acks."""
    with _PUB_LOCK:
        return dict(_OP_IDS)


def current_seq() -> int:
    """Next sequence to be claimed (ops < this are published)."""
    with _PUB_LOCK:
        return _SEQ


def publish(kind: str, payload: Dict[str, Any]) -> int:
    """Append one op (coordinator only); followers replay in sequence.
    Returns the op's sequence number (the coordinator's execution ticket).

    The KV put is retried with exponential backoff + jitter; if it still
    does not land, the claimed sequence slot is rolled back and a clear
    :class:`OplogPublishError` raises — the old silent-False path left
    the follower stalled at a sequence gap forever."""
    global _SEQ
    failure.faultpoint("oplog.publish")
    note_op_seen()            # adaptive replay-idle signal (traffic clock)
    # _PUB_LOCK spans claim + put: rollback is only sound while no LATER
    # slot has been claimed (a gap would stall the follower forever). The
    # hold is bounded — kv_put absorbs transient transport faults with its
    # own small backoff budget; a put that still fails is a HARD loss that
    # rolls back and raises (callers that must survive it, e.g. the
    # scoring micro-batcher, retry the whole publish for a fresh slot).
    from h2o3_tpu_torch.obs import metrics as obs_metrics
    from h2o3_tpu_torch.obs import tracing

    with _PUB_LOCK:
        seq = _SEQ
        _SEQ += 1
        op_id = uuid.uuid4().hex[:16]
        ok, cause = False, None
        # the op record carries the REST ingress trace context so the
        # follower's replay + ack land in the SAME span tree as the
        # coordinator's handler (publish -> replay -> ack, one trace)
        with tracing.span("oplog.publish", kind=kind, seq=seq) as psp:
            try:
                failure.faultpoint("oplog.kv_put")
                op_rec = {"kind": kind, "payload": payload, "op_id": op_id}
                if psp:
                    op_rec["trace"] = psp.ctx()
                ok = D.kv_put(f"{_PREFIX}/{seq}", json.dumps(op_rec))
            except Exception as e:   # noqa: BLE001 — converted below
                cause = e
            if not ok:
                _SEQ = seq       # gapless rollback: next publish reuses it
                raise OplogPublishError(
                    f"failed to publish oplog op {seq} ({kind}): "
                    f"{cause or 'kv_put did not land'}") from cause
        _OP_IDS[seq] = op_id     # reclaim overwrites: acks match THIS op
        _OP_KINDS[seq] = kind
        if len(_OP_IDS) > _OP_IDS_CAP:
            for old in sorted(_OP_IDS)[: len(_OP_IDS) - _OP_IDS_CAP]:
                del _OP_IDS[old]
                _OP_KINDS.pop(old, None)
    obs_metrics.inc("h2o3_oplog_ops_published_total")
    return seq


def broadcast(kind: str, payload: Dict[str, Any]) -> Optional[int]:
    """Publish when this process is the coordinator of a live multi-process
    cloud; no-op single-process (the common local path pays nothing).
    Returns the execution ticket (None single-process).

    Degraded-mode fail-fast: when the supervisor has marked the cloud
    DEGRADED/FAILED, new multi-process ops are refused immediately with a
    clear CloudUnhealthyError instead of being queued toward a collective
    the dead/stale follower will never join. A DEMOTED ex-coordinator
    (a standby won the epoch while this process was away) refuses too:
    silently falling through to local execution would fork its state from
    the cloud the new coordinator now leads."""
    if D.process_count() > 1:
        # leadership-view refresh before publishing: a standby's takeover
        # must be discovered here, not one supervision tick later. Single-
        # process there is no standby — that fast path keeps paying
        # nothing (the docstring's contract).
        maybe_demote()
    if _DEMOTED:
        rec = D.epoch_record()
        raise failure.CloudUnhealthyError(
            f"this process was demoted to follower (epoch "
            f"{rec['epoch']} is led by process {rec['leader']}): refusing "
            "to execute a multi-process op against a cloud it no longer "
            "coordinates — rejoin() as a follower or restart")
    if active():
        from h2o3_tpu_torch.parallel import supervisor

        supervisor.ensure_operable()
        return publish(kind, payload)
    return None


def _neutralize_slots(slots: List[int], why: str) -> None:
    """Best-effort cleanup for abandoned turnstile slots, OUTSIDE the
    condition lock: overwrite each published op with a 'noop' (KV upsert
    semantics) so a follower that has not reached it yet replays nothing
    instead of running a program the coordinator never will. If a
    follower ALREADY acked one of these ops, the divergence is certain —
    the follower ran a program the coordinator never will — and the
    cloud FAILs (sticky); otherwise it degrades with a hold. A follower
    mid-replay that acks after the check is the residual race; the hold
    window plus the next op's ack matching bounds how long that hides."""
    diverged = []
    for s in slots:
        if acks_for(s, _OP_IDS.get(s)):
            diverged.append(s)
        try:
            D.kv_put(f"{_PREFIX}/{s}",
                     json.dumps({"kind": "noop",
                                 "payload": {"abandoned": why}}))
        except Exception:   # noqa: BLE001 — cleanup stays best-effort
            pass
    from h2o3_tpu_torch.parallel import supervisor

    if diverged:
        supervisor.fail(f"abandoned op(s) {diverged} were already "
                        f"replayed by a follower ({why}): program "
                        "counters diverged")
    else:
        supervisor.degrade(f"turnstile abandoned op(s) {slots}: {why}",
                           hold_s=failure.heartbeat_stale_s())


@contextlib.contextmanager
def turn(seq: Optional[int], timeout_s: Optional[float] = None):
    """Hold the coordinator's device-execution turnstile for op `seq`:
    ops run their device programs in exactly broadcast order, matching the
    follower's sequential replay. No-op when seq is None.

    Bounded: if the turnstile does not reach `seq` within `timeout_s`
    (env ``H2O_TPU_TURN_TIMEOUT_S``), this raises
    :class:`OplogTurnTimeout` and abandons `seq`'s slot so later ops skip
    it; if the op at the head of the turnstile never ENTERED its turn
    (its holder died between publish and turn — as opposed to being alive
    inside a long device program), the head slot is released too, so ops
    behind it do not each re-pay the full deadline. Abandoned slots are
    neutralized to 'noop' in the KV and the cloud is degraded.
    On successful completion the coordinator waits (bounded, env
    ``H2O_TPU_OP_ACK_TIMEOUT_S``) for every follower's replay ack. An op
    that completed a collective whose result it keeps is snapshotted
    before the turnstile moves on, and the snapshot is booked after the
    acks (every follower's rank section is then written)."""
    global _NEXT_EXEC, _EXECUTING, _HEAD_IDLE_SINCE
    if seq is None:
        yield
        return
    if timeout_s is None:
        timeout_s = _turn_timeout_s()
    deadline = time.monotonic() + timeout_s
    abandoned: List[int] = []
    with _EXEC_COND:
        my_gen = _GEN
        while True:
            if _GEN != my_gen:
                raise OplogTurnTimeout(
                    f"turnstile was reset (cloud restart) while op {seq} "
                    "waited — op not executed")
            if seq < _NEXT_EXEC or seq in _ABANDONED:
                # a timed-out waiter released this slot presuming its
                # holder dead; executing now would be out of broadcast
                # order — refuse (the op in the KV is already a noop).
                # If the turnstile is parked ON this slot, advance it so
                # waiters behind do not stall on a holder that just left.
                if _NEXT_EXEC == seq:
                    _ABANDONED.discard(seq)
                    _NEXT_EXEC = seq + 1
                    while _NEXT_EXEC in _ABANDONED:
                        _ABANDONED.discard(_NEXT_EXEC)
                        _NEXT_EXEC += 1
                    _HEAD_IDLE_SINCE = time.monotonic()
                    _EXEC_COND.notify_all()
                raise OplogTurnTimeout(
                    f"op {seq}'s turnstile slot was abandoned (holder "
                    "presumed dead after a waiter's deadline) — op not "
                    "executed")
            while _NEXT_EXEC in _ABANDONED:
                _ABANDONED.discard(_NEXT_EXEC)
                _NEXT_EXEC += 1
                _HEAD_IDLE_SINCE = time.monotonic()
                _EXEC_COND.notify_all()
            if _NEXT_EXEC == seq:
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                stuck = _NEXT_EXEC
                abandoned.append(seq)
                _ABANDONED.add(seq)
                # release the head slot ONLY if its holder never entered
                # for a full grace window: a LIVE holder between publish
                # and turn enters within one cond-wait tick, so a
                # transient _EXECUTING gap right after the previous op's
                # exit must not read as death on a busy-but-healthy cloud
                grace = min(_HEAD_GRACE_S, timeout_s)
                if _EXECUTING != stuck and \
                        time.monotonic() - _HEAD_IDLE_SINCE >= grace:
                    abandoned.append(stuck)
                    _ABANDONED.add(stuck)
                _EXEC_COND.notify_all()
                break
            _EXEC_COND.wait(timeout=min(remaining, 1.0))
        if abandoned:
            head_note = (f"; released never-entered head slot "
                         f"{abandoned[1]}" if len(abandoned) > 1 else "")
            err = OplogTurnTimeout(
                f"op {seq} waited {timeout_s:.1f}s for the execution "
                f"turnstile (stuck at op {_NEXT_EXEC} — its holder is "
                f"wedged or died); slot {seq} abandoned{head_note}")
        else:
            _EXECUTING = seq
            _HEAD_IDLE_SINCE = time.monotonic()
    if abandoned:
        _neutralize_slots(abandoned, f"turn timeout after {timeout_s:.1f}s")
        raise err
    from h2o3_tpu_torch.parallel import ckpt

    _TLS.in_op = True
    _TLS.seq = seq
    _TLS.collective_failed = False
    _TLS.pending_ckpt = None
    c0 = _collectives()
    before = _dkv_state() if D.process_count() > 1 else None
    rewrites = False
    try:
        yield
        kept = _keeps_collective_state(_OP_KINDS.get(seq), c0)
        if _TLS.pending_ckpt is None and not _TLS.collective_failed \
                and kept:
            try:
                ckpt.write_checkpoint(seq)      # booked below
            except Exception as e:   # noqa: BLE001 — the op succeeded
                _log_ckpt_failure(seq, e)
        if before is not None and (kept or _TLS.pending_ckpt is not None):
            rewrites = _note_rewrites(seq, before)
    finally:
        failed = getattr(_TLS, "collective_failed", False)
        pending = getattr(_TLS, "pending_ckpt", None)
        _TLS.in_op = False
        _TLS.seq = None
        _TLS.collective_failed = False
        _TLS.pending_ckpt = None
        if failed:
            # the op's collective lost a peer: no process finished it, and
            # a rejoined follower must not replay it alone (its
            # collectives would have no peer); a resume re-dispatches it
            D.kv_put(f"{_PREFIX}/{seq}", json.dumps(
                {"kind": "noop", "payload": {"abandoned": "collective "
                                             "failed"}}))
        with _EXEC_COND:
            if _GEN == my_gen:
                _EXECUTING = None
                _NEXT_EXEC = seq + 1
                while _NEXT_EXEC in _ABANDONED:
                    _ABANDONED.discard(_NEXT_EXEC)
                    _NEXT_EXEC += 1
                _HEAD_IDLE_SINCE = time.monotonic()
                _EXEC_COND.notify_all()
            # else: the turnstile was reset() (cloud restart) while this
            # op was in flight — a straggler must not clobber the new
            # epoch's sequence position
    # reached only when the body completed: bounded follower-ack wait, so a
    # dead/crashed follower surfaces HERE as a clear error instead of
    # hanging the NEXT collective this handler (or any later op) runs
    try:
        wait_acks(seq)
    except BaseException:
        if pending is not None:
            ckpt.discard(pending)     # a follower's section may be missing
        raise
    if rewrites:
        D.kv_delete(f"{_REWRITES_PREFIX}{seq}")    # no rejoin replays it
    if pending is not None:
        # every follower replayed the op, its rank section written: the
        # snapshot is whole
        try:
            ckpt.commit(pending)
        except Exception as e:   # noqa: BLE001 — the op succeeded
            _log_ckpt_failure(seq, e)
        return
    # the op is fully acknowledged cloud-wide: feed the checkpoint
    # accountant — every H2O_TPU_OPLOG_CHECKPOINT_OPS acked ops it
    # snapshots the control plane and truncates the acked prefix, keeping
    # live oplog/* keys O(interval) (never raises; see parallel/ckpt.py)
    ckpt.note_acked_op(seq)


def _log_ckpt_failure(seq: int, e: BaseException) -> None:
    from h2o3_tpu_torch.utils.log import get_logger

    get_logger().warning("checkpoint of op %d failed (a rejoin restores "
                         "an older one): %s", seq, e)


# ---------------------------------------------------------------------------
# acknowledgment protocol
# ---------------------------------------------------------------------------

def expected_acks() -> int:
    """Follower count: every non-coordinator process acks each replay."""
    return max(D.process_count() - 1, 0)


def acks_for(seq: int, op_id: Optional[str] = None,
             min_incs: Optional[Dict[int, int]] = None) -> List[str]:
    """Ack keys recorded for op `seq`; with `op_id`, only acks carrying
    that identity token (stale acks from a lost-then-landed op whose slot
    was rolled back and reclaimed do not count for the reclaiming op).
    With `min_incs` ({proc: incarnation}), acks from an OLDER incarnation
    of a since-rejoined process are rejected too: the dead predecessor's
    leftover ack must not vouch for a replay only its successor can do."""
    out = []
    for k, v in D.kv_dir(f"{_PREFIX}/ack/{seq}/"):
        try:
            rec = json.loads(v)
        except (ValueError, TypeError):
            continue
        if not isinstance(rec, dict):
            continue               # truncated/corrupt ack: doesn't count
        if op_id is not None and rec.get("op_id") != op_id:
            continue
        if min_incs:
            try:
                proc = int(rec.get("proc", k.rsplit("/", 1)[-1]))
            except (ValueError, TypeError):
                continue
            if int(rec.get("inc", 0)) < min_incs.get(proc, 0):
                continue
        out.append(k)
    return out


def error_for(seq: int) -> Optional[dict]:
    raw = D.kv_try_get(f"{_PREFIX}/error/{seq}")
    if raw is None:
        return None
    try:
        return json.loads(raw)
    except ValueError:
        return {"kind": "?", "trace": str(raw)}


def error_records() -> List[Tuple[int, dict]]:
    """All follower replay failures, as (seq, {kind, trace}) sorted by seq
    (the supervisor folds these into the cloud health state)."""
    out = []
    for k, v in D.kv_dir(f"{_PREFIX}/error/"):
        try:
            seq = int(k.rsplit("/", 1)[-1])
            out.append((seq, json.loads(v)))
        except (ValueError, TypeError):
            continue
    return sorted(out, key=lambda t: t[0])


def wait_acks(seq: Optional[int], timeout_s: Optional[float] = None) -> None:
    """Bounded wait until every follower acked replaying op `seq`.

    Raises :class:`~h2o3_tpu_torch.core.failure.CloudUnhealthyError` — carrying
    the follower's traceback when its replay crashed (``oplog/error/{seq}``
    appears), or a timeout diagnosis when a follower went silent. Either
    way the supervisor is notified so the cloud health state degrades and
    subsequent multi-process ops are refused fast. No-op single-process,
    with acks disabled (timeout <= 0), or for a None ticket."""
    if seq is None:
        return
    n = expected_acks()
    if n <= 0:
        return
    if timeout_s is None:
        timeout_s = _ack_timeout_s()
    if timeout_s <= 0:
        return
    from h2o3_tpu_torch.parallel import ckpt, supervisor

    poll = retry.AdaptivePoll(min_s=0.001, max_s=0.25)
    deadline = time.monotonic() + timeout_s
    # one rejoin-record scan per wait, not per poll tick: an incarnation
    # bump mid-wait means the follower crashed, which surfaces through the
    # error/FAILED branches below — the stale-ack floor can't regress
    min_incs = expected_incarnations()
    while True:
        err = error_for(seq)
        if err is not None:
            trace = str(err.get("trace", ""))
            if err.get("fatal", True):
                msg = (f"follower replay of op {seq} ({err.get('kind', '?')}) "
                       f"crashed")
                supervisor.fail(msg, trace)
            else:
                # e.g. a lost ack write: the replay itself succeeded, so
                # states did not diverge — degrade, don't sticky-FAIL
                msg = (f"follower reported a non-fatal oplog fault at op "
                       f"{seq} ({err.get('kind', '?')})")
                supervisor.degrade(msg, hold_s=failure.heartbeat_stale_s())
            raise failure.CloudUnhealthyError(msg, remote_trace=trace)
        if supervisor.state() == supervisor.FAILED:
            # the cloud already failed on ANOTHER op's evidence (a replay
            # crash elsewhere in the stream): no ack for this op is ever
            # coming — bail now with that diagnosis, not a generic
            # timeout 300s later
            st = supervisor.status()
            raise failure.CloudUnhealthyError(
                f"cloud FAILED while waiting for op {seq} acks: "
                f"{st['reason']}", remote_trace=st["remote_trace"])
        got = len(acks_for(seq, _OP_IDS.get(seq), min_incs))
        if got >= n:
            return
        if seq <= ckpt.truncated_through():
            # the compactor truncated this op's records mid-wait: that
            # only happens after the checkpoint op covering it was fully
            # acked, which proves every follower replayed through `seq` —
            # the acks are gone, not missing
            return
        if time.monotonic() >= deadline:
            msg = (f"op {seq}: {got}/{n} follower acks within "
                   f"{timeout_s:.1f}s — follower dead or stalled "
                   f"(H2O_TPU_OP_ACK_TIMEOUT_S bounds this wait)")
            # event-derived degrade: hold it past the next heartbeat
            # evaluation so fresh beats from a wedged-but-beating peer do
            # not instantly erase the evidence
            supervisor.degrade(msg, hold_s=failure.heartbeat_stale_s())
            raise failure.CloudUnhealthyError(msg)
        poll.wait()


# ---------------------------------------------------------------------------
# follower side
# ---------------------------------------------------------------------------

def _ack(seq: int, op_id: Optional[str] = None) -> None:
    """Record this process's replay acknowledgment for op `seq`, carrying
    the op's identity token so the coordinator can tell this replay from
    one of a lost op that previously occupied the same slot.

    A lost ack write is NOT swallowed: silently proceeding would convert a
    SUCCESSFUL replay into a full coordinator ``wait_acks`` stall plus a
    misleading "follower dead" degrade. After a second retry round (on top
    of kv_put's own budget) this best-effort records a NON-fatal error for
    the op — ``wait_acks`` surfaces it immediately with the true story
    instead of a generic timeout, and the supervisor degrades (states did
    not diverge, so the cloud is not FAILED) — then raises
    :class:`OplogAckError`: a follower that cannot write acks cannot
    participate."""
    failure.faultpoint("oplog.ack")
    proc = D.process_index()
    key = f"{_PREFIX}/ack/{seq}/{proc}"
    val = json.dumps({"proc": proc, "ts": time.time(), "op_id": op_id,
                      "inc": failure.incarnation()})
    ok = D.kv_put(key, val)
    for delay in retry.backoff_delays():
        if ok:
            return
        time.sleep(delay)
        ok = D.kv_put(key, val)
    if ok:
        return
    msg = (f"process {proc} replayed op {seq} but could not write its ack "
           f"({key}) — replay succeeded, states did not diverge, but this "
           f"process can no longer confirm replays")
    _record_error(seq, "ack", msg, fatal=False)
    raise OplogAckError(msg)


def _record_error(seq: int, kind: str, trace: str, fatal: bool = True) -> None:
    """Best-effort publish of a follower-side failure for op `seq` so the
    coordinator's ``wait_acks`` and the supervisor see the real story
    instead of a bare timeout. `fatal=False` marks faults where the replay
    itself did NOT diverge (e.g. a lost ack write) — the supervisor
    degrades instead of sticky-FAILing. A loss of the error record itself
    is logged loudly: there is no further channel left."""
    from h2o3_tpu_torch.obs import metrics as obs_metrics

    obs_metrics.inc("h2o3_oplog_errors_total")
    if not D.kv_put(f"{_PREFIX}/error/{seq}",
                    json.dumps({"kind": kind, "trace": trace[-4000:],
                                "fatal": bool(fatal)})):
        from h2o3_tpu_torch.utils.log import get_logger

        get_logger().error(
            "oplog: error record for op %d (%s) could not be written — the "
            "coordinator will only see a generic ack timeout: %s",
            seq, kind, trace[-500:])


def _apply(kind: str, p: Dict[str, Any]) -> None:
    """Replay one op through the framework call its REST handler made on
    the coordinator, with the same keys, so both processes hold the same
    objects under the same names."""
    if kind == "noop":
        # liveness probe: replay and ack with no framework work
        return
    if kind == "checkpoint":
        # the coordinator's snapshot marker: the follower's ack proves
        # every earlier op was replayed (which licenses the truncation),
        # and its rows of every sharded frame are its rank section
        from h2o3_tpu_torch.parallel import ckpt

        seq = replaying_seq()
        if seq is not None:
            ckpt.write_rank_section(seq)
        return
    from h2o3_tpu_torch.core.dkv import DKV, Key

    if kind == "import_file":
        from h2o3_tpu_torch.ingest.parser import import_file

        kw = {"header": int(p["header"]) if p.get("header") is not None
              else 0}
        if p.get("col_names"):
            kw["col_names"] = p["col_names"]
        if p.get("col_types"):
            kw["col_types"] = p["col_types"]
        import_file(p["path"], destination_frame=p.get("destination_frame"),
                    **kw)
        return
    if kind == "parse_stream":
        # every process appends the same batch text to its own frame
        from h2o3_tpu_torch.ingest.chunked import append_csv

        fr = DKV.get(p["frame"])
        if fr is None:
            raise KeyError(f"parse_stream: frame {p['frame']!r} not found")
        append_csv(fr, p["data"], p.get("separator") or None)
        return
    if kind == "train":
        from h2o3_tpu_torch.models.model_builder import BUILDERS

        cls = BUILDERS[p["algo"]]
        params = dict(p.get("params") or {})
        train = DKV.get(p["training_frame"])
        valid = DKV.get(p["validation_frame"]) if p.get("validation_frame") \
            else None
        builder = cls(**params)
        if p.get("resume_job"):
            # a resumed dispatch: every process fast-forwards from the
            # same durable progress file (a shared checkpoint dir). A
            # process that cannot read it fails the replay loudly: training
            # from iteration 0 while the coordinator fast-forwards would
            # fork the two processes' models with no error naming why
            from h2o3_tpu_torch.parallel import ckpt

            data = ckpt.load_job_progress(p["resume_job"])
            if data is None:
                raise RuntimeError(
                    f"resumed train for job {p['resume_job']}: durable "
                    f"progress is not readable on this process; "
                    f"H2O_TPU_OPLOG_CKPT_DIR must be shared storage for "
                    f"a cross-host job resume")
            builder._resume_state = data.get("state")
        model = builder.train(y=p.get("y"), training_frame=train,
                              validation_frame=valid)
        if p.get("model_id"):
            old = str(model.key)
            if old != p["model_id"]:
                DKV.remove(old)
            model._key = str(p["model_id"])
        model.install()
        return
    if kind in ("predict", "leaf_assignment", "staged_proba"):
        m = DKV.get(p["model"])
        fr = DKV.get(p["frame"])
        dest = p.get("destination_frame")
        if kind == "leaf_assignment":
            pred = m.predict_leaf_node_assignment(fr, type=p["type"])
        elif kind == "staged_proba":
            pred = m.staged_predict_proba(fr)
        elif p.get("contributions"):
            pred = m.predict_contributions(fr, key=dest)
        else:
            pred = m.predict(fr)
        if dest and str(pred.key) != dest:
            DKV.remove(str(pred.key))
            pred._key = Key(dest)
        pred.install()
        if p.get("with_metrics") and not solo_replay():
            # the v3 handler also computes metrics: the same programs
            # (and on a row-sharded cloud the same collectives)
            m.model_performance(fr)
        return
    if kind == "gather":
        # a coordinator's download of a row-sharded frame: this rank's
        # part of the gather of every column (nothing to keep: a solo
        # replay skips it)
        if solo_replay():
            return
        fr = DKV.get(p["frame"])
        if fr is None:
            raise KeyError(f"gather: frame {p['frame']!r} not found")
        for nm in fr.names:
            fr.col(nm).to_numpy()
        return
    if kind == "score_batch":
        # one replay scores every request of the coordinator's micro-batch
        # through the same executor
        from h2o3_tpu_torch import scoring

        m = DKV.get(p["model"])
        entries = [(DKV.get(r["frame"]), r.get("destination_frame"),
                    bool(r.get("with_metrics")))
                   for r in p.get("requests", [])]
        scoring.execute_batch(m, entries)
        return
    if kind == "rapids":
        from h2o3_tpu_torch.rapids import Session, exec_rapids

        sid = p.get("session_id", "oplog")
        sess = _RAPIDS_SESSIONS.get(sid)
        if sess is None:
            sess = _RAPIDS_SESSIONS[sid] = Session(sid)
        exec_rapids(p["ast"], sess)
        return
    if kind == "generic":
        from h2o3_tpu_torch.models.generic import Generic

        model = Generic(path=p["path"]).train()
        DKV.remove(str(model.key))
        model._key = str(p["model_id"])
        DKV.put(p["model_id"], model)
        return
    if kind == "artifact_import":
        # every process installs the artifact's model under the same key
        from h2o3_tpu_torch.artifact import load_model

        load_model(p["dir"], p.get("model_id"))
        return
    if kind == "grid":
        from h2o3_tpu_torch.grid import H2OGridSearch
        from h2o3_tpu_torch.models.model_builder import BUILDERS

        cls = BUILDERS[p["algo"]]
        base = cls(**(p.get("params") or {}))
        grid = H2OGridSearch(base, p["hyper"], grid_id=p["grid_id"],
                             search_criteria=p.get("criteria"))
        train = DKV.get(p["training_frame"])
        valid = DKV.get(p["validation_frame"]) if p.get("validation_frame") \
            else None
        grid.train(y=p.get("y"), training_frame=train,
                   validation_frame=valid)
        return
    if kind == "automl":
        # one op is the whole build: the coordinator pinned the seed and
        # cleared max_runtime_secs before the broadcast, so every process
        # walks the same model sequence
        from h2o3_tpu_torch.automl.automl import H2OAutoML

        aml = H2OAutoML(**p["spec"])
        train = DKV.get(p["training_frame"])
        valid = DKV.get(p["validation_frame"]) if p.get("validation_frame") \
            else None
        lb = DKV.get(p["leaderboard_frame"]) if p.get("leaderboard_frame") \
            else None
        aml.train(x=p.get("x"), y=p["y"], training_frame=train,
                  validation_frame=valid, leaderboard_frame=lb)
        # the coordinator's Job installs the project key: mirror it
        DKV.put(p["spec"]["project_name"], aml)
        return
    if kind == "search_resume":
        # an orphaned AutoML or grid search re-dispatched: every process
        # reloads the same durable search state and walks the remaining
        # members in plan order
        from h2o3_tpu_torch.automl import search

        search.apply_resume_op(p)
        return
    raise ValueError(f"unknown oplog op {kind!r}")


def replaying_seq() -> Optional[int]:
    """The op this thread replays as a follower (None elsewhere)."""
    return getattr(_TLS, "replay_seq", None)


def _replay(seq: int, kind: str, payload: Dict[str, Any]) -> None:
    """Apply one op as a follower; an op that completed a collective
    whose result it keeps ends with this rank's section of the
    checkpoint the coordinator writes for it (before the ack)."""
    _TLS.replay_seq = seq
    c0 = _collectives()
    try:
        _apply(kind, payload)
        kept = _keeps_collective_state(kind, c0)
        # the window a rejoin repairs with a joint replay: the op's
        # collectives are done, its rank section and ack are not
        failure.faultpoint("oplog.replay.collectives_done")
        if kept:
            from h2o3_tpu_torch.parallel import ckpt

            ckpt.write_rank_section(seq)
    finally:
        _TLS.replay_seq = None


def follower_loop(idle_timeout_s: float = 120.0,
                  on_op: Optional[Callable[[str, dict], None]] = None,
                  start_seq: int = 0) -> int:
    """Replay coordinator ops until a 'shutdown' op (or idle timeout).
    Returns the number of ops applied. Runs on every non-coordinator
    process of a multi-process cloud whose coordinator serves REST.

    Each successful replay is acknowledged (``oplog/ack/{seq}/{proc}``);
    a replay crash is surfaced to the cloud (``oplog/error/{seq}`` with
    the traceback) BEFORE re-raising, so the coordinator's `wait_acks`
    and the supervisor see the failure instead of a bare collective hang.
    Polling is adaptive (1→250 ms): hot while ops stream, cheap idle.
    The loop returns when this process becomes the coordinator (it won
    a standby election).
    `start_seq` resumes the replay cursor after a checkpoint restore
    (``rejoin()`` returns it): ops before it were truncated or already
    folded into this process's state."""
    i, applied = start_seq, 0
    poll = retry.AdaptivePoll(min_s=0.001, max_s=0.25)
    deadline = time.time() + idle_timeout_s
    epoch0 = D.epoch()
    while time.time() < deadline:
        if D.epoch() != epoch0 and D.is_coordinator():
            # this process won a standby election: a leader publishes,
            # it never replays its own ops
            return applied
        raw = D.kv_try_get(f"{_PREFIX}/{i}")
        if raw is None:
            poll.wait()
            continue
        poll.reset()
        op = json.loads(raw)
        if op["kind"] == "shutdown":
            _ack(i, op.get("op_id"))
            return applied
        from h2o3_tpu_torch.obs import metrics as obs_metrics
        from h2o3_tpu_torch.obs import tracing

        # the op's trace context (minted at the coordinator's REST
        # ingress) parents this replay — and the ack nests under the
        # replay — so /3/Trace/{id} shows publish -> replay -> ack
        tctx = op.get("trace")
        t_replay0 = time.time() * 1000.0
        try:
            failure.faultpoint("oplog.replay")
            _replay(i, op["kind"], op["payload"])
        except Exception:
            # surface the replay failure to the cloud BEFORE dying: the
            # coordinator (and operators reading /3/Cloud health) see the
            # error instead of a bare collective hang. The crash flag lets
            # this process's recovery watchdog auto-rejoin.
            global _REPLAY_CRASHED
            _REPLAY_CRASHED = True
            _record_error(i, op["kind"], traceback.format_exc())
            tracing.record_span("oplog.replay", tctx, t_replay0,
                                publish=True, status="error",
                                kind=op["kind"], seq=i)
            raise
        t_ack0 = time.time() * 1000.0
        _ack(i, op.get("op_id"))
        # span KV writes happen AFTER the ack landed: tracing must never
        # add latency to the coordinator's wait_acks path
        rsp = tracing.record_span("oplog.replay", tctx, t_replay0, t_ack0,
                                  publish=True, kind=op["kind"], seq=i)
        tracing.record_span(
            "oplog.ack",
            {"trace_id": tctx["trace_id"],
             "span_id": rsp["span_id"]} if rsp else None,
            t_ack0, publish=True, seq=i)
        obs_metrics.inc("h2o3_oplog_ops_replayed_total")
        obs_metrics.maybe_publish()
        note_op_seen()        # adaptive replay-idle signal (traffic clock)
        if on_op is not None:
            on_op(op["kind"], op["payload"])
        applied += 1
        i += 1
        deadline = time.time() + idle_timeout_s
    raise TimeoutError(f"oplog follower idle for {idle_timeout_s}s at op {i}")


# ---------------------------------------------------------------------------
# follower readmission (rejoin) — water/Paxos.java re-admission analog:
# a restarted node re-derives state (here: checkpoint + oplog suffix)
# instead of the cloud staying FAILED forever
# ---------------------------------------------------------------------------

_REJOIN_PREFIX = f"{_PREFIX}/rejoin/"


def _write_rejoin(proc: int, inc: int, phase: str, seq: int) -> None:
    D.kv_put(f"{_REJOIN_PREFIX}{proc}",
             json.dumps({"proc": proc, "inc": inc, "phase": phase,
                         "seq": int(seq), "ts": time.time()}))


def rejoin_records() -> List[dict]:
    """Per-process readmission records ({proc, inc, phase, seq, ts}),
    sorted by proc. Phase is 'replaying' while the suffix replay runs and
    'caught_up' once the process reached the oplog head."""
    out = []
    for _k, v in D.kv_dir(_REJOIN_PREFIX):
        try:
            rec = json.loads(v)
        except (ValueError, TypeError):
            continue
        if isinstance(rec, dict):       # truncated/corrupt record: skip
            out.append(rec)
    return sorted(out, key=lambda r: r.get("proc", -1))


def expected_incarnations() -> Dict[int, int]:
    """Minimum acceptable incarnation per process: a proc that rejoined at
    incarnation i must ack with inc >= i — anything older is a leftover
    from its dead predecessor."""
    return {int(r["proc"]): int(r.get("inc", 0)) for r in rejoin_records()
            if r.get("proc") is not None}


def rejoin() -> int:
    """Readmit THIS restarted process: bump the incarnation, restore the
    latest control-plane checkpoint, replay the acknowledged oplog suffix
    (acking each op under the fresh incarnation), delete the failure
    evidence this replay supersedes, and publish a 'caught_up' rejoin
    record the supervisor folds into FAILED -> RECOVERING -> HEALTHY.

    Returns the caught-up sequence — pass it to ``follower_loop(...,
    start_seq=...)`` to keep replaying live ops. A crash during the
    suffix replay records ``oplog/error/{seq}`` like the normal loop (the
    cloud re-FAILs with the true story) and re-raises.

    A DEMOTED ex-coordinator rejoining this way is restored to service:
    it adopts the newer epoch's leadership view, and on a successful
    catch-up the demotion flag and the supervisor's demotion hold are
    cleared — this is exactly the "rejoin() as a follower" remediation
    the demotion error advertises."""
    global _DEMOTED, _REPLAY_CRASHED
    from h2o3_tpu_torch.parallel import ckpt

    proc = D.process_index()
    rec = D.epoch_record()
    if rec["epoch"] >= D.epoch():
        # adopt the cloud's current leadership view before replaying: a
        # standby may have taken a newer epoch while this process was down
        D.set_leader(rec["leader"], rec["epoch"])
    # a REAL process restart boots with the local incarnation counter at
    # 0 — seed it from the cloud's evidence (heartbeat table + standing
    # rejoin record) first, or the second crash/restart cycle would rejoin
    # at an incarnation the supervisor's strictly-newer FAILED->RECOVERING
    # gate has already seen and the cloud would stay FAILED forever
    on_record = expected_incarnations().get(proc, 0)
    for r in failure.cluster_health(stale_after_s=float("inf")):
        if r.get("process") == proc:
            on_record = max(on_record, int(r.get("incarnation", 0)))
    if failure.incarnation() < on_record:
        failure.set_incarnation(on_record)
    inc = failure.bump_incarnation()
    failure.heartbeat()                    # announce the fresh incarnation
    # the live ranks' group has a dead peer (this process's predecessor):
    # every rank builds the next generation at its next collective
    D.next_mesh_generation()
    cursor, _snap = ckpt.load_latest()
    _write_rejoin(proc, inc, "replaying", cursor)
    _TLS.solo = True
    try:
        while True:
            raw = D.kv_try_get(f"{_PREFIX}/{cursor}")
            if raw is None:
                break                          # reached the head
            op = json.loads(raw)
            if op["kind"] == "shutdown":
                break
            try:
                failure.faultpoint("oplog.rejoin.replay")
                try:
                    _replay(cursor, op["kind"], op["payload"])
                except failure.CloudUnhealthyError as e:
                    if not getattr(e, "solo", False):
                        raise
                    # the op kept a collective's result and its checkpoint
                    # was never booked (this rank died after the op's last
                    # collective, before its ack): replay it with the live
                    # ranks
                    _joint_replay(cursor, op, inc)
            except Exception:
                _record_error(cursor, op["kind"], traceback.format_exc())
                raise
            _ack(cursor, op.get("op_id"))
            cursor += 1
    finally:
        _TLS.solo = False
    # a successful re-replay through `cursor` supersedes the dead
    # incarnation's failure evidence for those ops: the programs ARE
    # replayable, and this process's state now includes them
    for s, _rec in error_records():
        if s < cursor:
            D.kv_delete(f"{_PREFIX}/error/{s}")
    _write_rejoin(proc, inc, "caught_up", cursor)
    _REPLAY_CRASHED = False          # readmitted: the crashed loop's state
    if _DEMOTED:                     # was rebuilt from ckpt + suffix
        # caught up as a follower of the new epoch: the demotion did its
        # job. Clear the flag and lift the supervisor's infinite demotion
        # hold so liveness evidence can recover the health state.
        _DEMOTED = False
        from h2o3_tpu_torch.parallel import supervisor

        supervisor.release_hold()
    from h2o3_tpu_torch.obs import metrics as obs_metrics
    from h2o3_tpu_torch.utils import timeline

    obs_metrics.inc("h2o3_oplog_rejoins_total")
    timeline.record("cloud", "rejoin", proc=proc, inc=inc,
                    caught_up_seq=cursor)
    return cursor


_JOINT_PREFIX = f"{_PREFIX}/joint/"
_ANSWER_PREFIX = f"{_PREFIX}/joint_answer/"
_REWRITES_PREFIX = f"{_PREFIX}/rewrites/"
_JOINT_SERVED: set = set()
# kinds of op that change no object a later op reads
_INERT_KINDS = ("noop", "checkpoint")


def _dkv_state() -> Dict[str, tuple]:
    """Every object in this process's DKV (a frame with its names and
    columns), held so that none is freed while an op runs: an object the
    op replaced, removed or rebuilt shows as a changed entry
    (`_same_entry`)."""
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.core.frame import Frame

    out = {}
    for k in DKV.keys():
        v = DKV.get(k)
        out[k] = ((v, tuple(v.names), tuple(v.col(n) for n in v.names))
                  if isinstance(v, Frame) else (v, (), ()))
    return out


def _same_entry(a: tuple, b: Optional[tuple]) -> bool:
    return (b is not None and a[0] is b[0] and a[1] == b[1]
            and len(a[2]) == len(b[2])
            and all(x is y for x, y in zip(a[2], b[2])))


def _note_rewrites(seq: int, before: Dict[str, tuple]) -> bool:
    """Coordinator, at the end of op `seq`, which kept a collective's
    result: record the DKV keys that held an object before the op and
    hold another (or none) after it (True when there are any). Run again
    on such a DKV the op would read its own output, so a rejoin cannot
    replay it jointly (ROADMAP C47)."""
    now = _dkv_state()
    changed = sorted(k for k, v in before.items()
                     if not _same_entry(v, now.get(k)))
    if changed:
        D.kv_put(f"{_REWRITES_PREFIX}{seq}", json.dumps(changed))
    return bool(changed)


def _joint_replay(seq: int, op: Dict[str, Any], inc: int) -> None:
    """A rejoiner's replay of op `seq` together with the live ranks (ROADMAP
    C47): it asks the coordinator (``oplog/joint/{seq}``) to run the op
    again in the mesh's new generation and waits for its answer. When the
    coordinator agrees it runs the op itself with its peers (its rank
    section written as in a live replay), and the coordinator books the
    op's checkpoint once this rank acknowledged it. A refusal raises: the
    rejoin fails as it would without a joint replay."""
    proc = D.process_index()
    D.kv_put(f"{_JOINT_PREFIX}{seq}", json.dumps(
        {"proc": proc, "inc": int(inc), "kind": op["kind"],
         "ts": time.time()}))
    deadline = time.monotonic() + _ack_timeout_s()
    poll = retry.AdaptivePoll(min_s=0.01, max_s=0.25)
    while True:
        raw = D.kv_try_get(f"{_ANSWER_PREFIX}{seq}")
        ans = json.loads(raw) if raw is not None else None
        if ans is not None and ans.get("proc") == proc \
                and int(ans.get("inc", -1)) == int(inc):
            break
        if time.monotonic() > deadline:
            raise failure.CloudUnhealthyError(
                f"rejoin: the coordinator never answered the joint replay "
                f"of op {seq} ({op['kind']})")
        poll.wait()
    D.kv_delete(f"{_ANSWER_PREFIX}{seq}")
    if not ans.get("ok"):
        raise RuntimeError(f"rejoin: op {seq} ({op['kind']}) cannot be "
                           f"replayed jointly: {ans.get('reason')}")
    _TLS.solo = False
    try:
        _replay(seq, op["kind"], op["payload"])
    finally:
        _TLS.solo = True


def serve_joint_replays() -> List[int]:
    """Coordinator: answer every joint replay a rejoiner asked for (once
    each) and start the ones it can run; returns their seqs. The
    supervisor calls this every tick."""
    if D.process_count() < 2 or not D.is_coordinator():
        return []
    started = []
    for k, v in D.kv_dir(_JOINT_PREFIX):
        try:
            seq, rec = int(k.rsplit("/", 1)[-1]), json.loads(v)
        except (ValueError, TypeError):
            continue
        tag = (seq, int(rec.get("proc", -1)), int(rec.get("inc", 0)),
               rec.get("ts"))
        if tag in _JOINT_SERVED:
            continue
        _JOINT_SERVED.add(tag)
        why = _joint_refusal(seq)
        D.kv_put(f"{_ANSWER_PREFIX}{seq}", json.dumps(
            {"proc": rec.get("proc"), "inc": rec.get("inc", 0),
             "ok": why is None, "reason": why}))
        if why is not None:
            D.kv_delete(f"{_JOINT_PREFIX}{seq}")
            from h2o3_tpu_torch.utils.log import get_logger

            get_logger().warning("joint replay of op %d refused: %s", seq,
                                 why)
            continue
        threading.Thread(target=_serve_joint, args=(seq, rec), daemon=True,
                         name=f"h2o3-joint-replay-{seq}").start()
        started.append(seq)
    return started


def _joint_refusal(seq: int) -> Optional[str]:
    """Why the coordinator cannot run op `seq` again beside a rejoiner
    (None when it can). Its run must see what its first run saw: so the
    op may not have replaced an object it existed before (an assign onto
    one of its own inputs, a train or an AutoML project under a key that
    was taken), no op that changes state may have run after it, and the
    coordinator must be the only live peer (another follower would not
    join the replay)."""
    if D.process_count() > 2:
        return (f"{D.process_count()} processes: only the coordinator "
                "replays an op beside a rejoiner")
    raw = D.kv_try_get(f"{_REWRITES_PREFIX}{seq}")
    if raw is not None:
        return (f"the op replaced {', '.join(json.loads(raw))}, which a "
                "second run would read in place of its inputs")
    for s in range(seq + 1, current_seq()):
        later = D.kv_try_get(f"{_PREFIX}/{s}")
        kind = json.loads(later)["kind"] if later is not None else None
        if kind is not None and kind not in _INERT_KINDS:
            return f"op {s} ({kind}) ran after it"
    return None


def _serve_joint(seq: int, rec: dict) -> None:
    """Run op `seq` again beside the rejoiner, snapshot the result, wait
    for the rejoiner's ack (its rank section is then written) and book
    the checkpoint."""
    from h2o3_tpu_torch.parallel import ckpt
    from h2o3_tpu_torch.utils.log import get_logger

    log = get_logger()
    raw = D.kv_try_get(f"{_PREFIX}/{seq}")
    if raw is None:
        log.warning("joint replay of op %d: the op is gone", seq)
        return
    op = json.loads(raw)
    t0 = time.monotonic()
    _TLS.in_op, _TLS.seq = True, seq
    _TLS.collective_failed, _TLS.pending_ckpt = False, None
    try:
        _apply(op["kind"], op["payload"])
        ckpt.write_checkpoint(seq)
        pending = _TLS.pending_ckpt
    except Exception as e:   # noqa: BLE001 — the rejoin reports its side
        log.warning("joint replay of op %d failed: %s", seq, e)
        return
    finally:
        _TLS.in_op, _TLS.seq, _TLS.pending_ckpt = False, None, None
        _TLS.collective_failed = False
    deadline = time.monotonic() + _ack_timeout_s()
    floor = {int(rec["proc"]): int(rec.get("inc", 0))}
    while not acks_for(seq, op.get("op_id"), floor):
        if time.monotonic() > deadline:
            ckpt.discard(pending)
            log.warning("joint replay of op %d: no ack from process %s",
                        seq, rec["proc"])
            return
        time.sleep(0.02)
    ckpt.commit(pending)
    D.kv_delete(f"{_JOINT_PREFIX}{seq}")
    from h2o3_tpu_torch.utils import timeline

    timeline.record("cloud", "joint_replay", seq=seq, proc=rec["proc"],
                    ms=(time.monotonic() - t0) * 1000.0)


def op_context() -> Dict[str, Any]:
    """This thread's op context (the op it executes or replays), for
    threads an op starts to do its work (AutoML's and grids' members)."""
    return {k: getattr(_TLS, k, None)
            for k in ("in_op", "seq", "replay_seq", "solo")}


@contextlib.contextmanager
def adopt_op_context(ctx: Dict[str, Any]):
    """Run the block in `ctx`, an op context from `op_context`."""
    old = op_context()
    for k, v in ctx.items():
        setattr(_TLS, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(_TLS, k, v)


# ---------------------------------------------------------------------------
# standby-coordinator handoff — water/Paxos.java leader = lowest live node.
# A follower assumes coordination when the coordinator's heartbeat stays
# silent past the election grace; the old coordinator, if it returns,
# detects the newer epoch and demotes.
# ---------------------------------------------------------------------------

class ElectionLost(RuntimeError):
    """This process is not the deterministic election winner (the lowest
    live process index), or the coordinator is not dead enough yet."""


def _sealed_next_seq(caught_up_seq: Optional[int] = None) -> int:
    """Where the new epoch's sequence starts: past everything any
    follower acknowledged, past the newest checkpoint, and past whatever
    the caller itself replayed — the new coordinator must never reuse a
    slot some process already ran a program for."""
    from h2o3_tpu_torch.parallel import ckpt

    hi = -1
    for k, _v in D.kv_dir(f"{_PREFIX}/ack/"):
        parts = k.split("/")
        if len(parts) >= 3 and parts[1] == "ack" and parts[2].isdigit():
            hi = max(hi, int(parts[2]))
    rec = ckpt.latest()
    if rec is not None:
        hi = max(hi, int(rec[1].get("next_seq", rec[0] + 1)) - 1)
    if caught_up_seq is not None:
        hi = max(hi, int(caught_up_seq) - 1)
    return hi + 1


def assume_coordination(caught_up_seq: Optional[int] = None,
                        force: bool = False) -> dict:
    """Deterministic standby takeover (Paxos-lite: lowest live process
    index wins). Preconditions unless `force`: the recorded leader's
    heartbeat is silent past ``H2O_TPU_ELECTION_GRACE_S`` AND this
    process is the lowest-indexed live one. On win: seal the old epoch's
    oplog at the last acknowledged sequence, write the new epoch record,
    adopt leadership locally (``distributed.is_coordinator`` flips), and
    reset the turnstile at the sealed sequence. Device-resident scoring
    sessions are dropped (they rebuild from the DKV on first use).

    Returns {epoch, leader, next_seq}. The caller re-binds the REST
    server (``api.server.assume_coordination`` does both)."""
    proc = D.process_index()
    raw0 = D.epoch_record_raw()
    rec = D.epoch_record()
    old_leader, old_epoch = rec["leader"], rec["epoch"]
    if not force:
        if proc == old_leader:
            raise ElectionLost(
                f"process {proc} already leads epoch {old_epoch}")
        grace = failure.election_grace_s()
        health = failure.cluster_health(stale_after_s=grace)
        by_proc = {r["process"]: r for r in health}
        lead_row = by_proc.get(old_leader)
        if lead_row is not None and lead_row["age_s"] < grace:
            raise ElectionLost(
                f"coordinator {old_leader} beat {lead_row['age_s']:.1f}s "
                f"ago — inside the election grace "
                f"({grace:.1f}s, H2O_TPU_ELECTION_GRACE_S); not assuming")
        live = sorted(r["process"] for r in failure.cluster_health()
                      if r["healthy"] and r["process"] != old_leader)
        winner = live[0] if live else proc
        if winner != proc:
            raise ElectionLost(
                f"election winner is process {winner} (lowest live index; "
                f"this is {proc}) — standing by")
    failure.faultpoint("oplog.election")
    sealed_next = _sealed_next_seq(caught_up_seq)
    D.kv_put(f"{_PREFIX}/sealed/{old_epoch}",
             json.dumps({"next_seq": sealed_next, "by": proc,
                         "ts": time.time()}))
    new_epoch = old_epoch + 1
    # first writer wins: the record lands only if it is still the one
    # this election read, so of two standbys racing one election exactly
    # one adopts the new epoch; the other reads the winner's claim
    if not D.write_epoch_record(new_epoch, proc, expect=raw0):
        rb = D.epoch_record()
        if rb["epoch"] > old_epoch or rb["leader"] != old_leader:
            D.set_leader(rb["leader"], rb["epoch"])
            raise ElectionLost(
                f"concurrent election: process {rb['leader']} claimed "
                f"epoch {rb['epoch']} over this claim of {new_epoch}; "
                "standing down")
        raise failure.CloudUnhealthyError(
            f"could not write epoch record {new_epoch}; election aborted")
    D.set_leader(proc, new_epoch)
    global _DEMOTED
    _DEMOTED = False
    reset(next_seq=sealed_next)
    # the old leader's rank is dead in the current group: every live rank
    # builds the next generation at its next collective
    D.next_mesh_generation()
    # device-resident scoring sessions belonged to the old epoch's program
    # stream; drop them so first use rebuilds from the (checkpoint-
    # restored) DKV models on THIS process's devices
    from h2o3_tpu_torch import scoring

    scoring.purge()
    # supervision restarts from evidence: the dead old leader's stale beat
    # will degrade the cloud until it rejoins as a follower
    from h2o3_tpu_torch.parallel import supervisor

    supervisor.reset()
    failure.heartbeat()
    from h2o3_tpu_torch.utils import timeline

    timeline.record("cloud", "assume_coordination", epoch=new_epoch,
                    leader=proc, next_seq=sealed_next)
    from h2o3_tpu_torch.utils.log import get_logger

    get_logger().warning(
        "process %d assumed cloud coordination: epoch %d (was %d led by "
        "%d), oplog sealed at next_seq=%d", proc, new_epoch, old_epoch,
        old_leader, sealed_next)
    return {"epoch": new_epoch, "leader": proc, "next_seq": sealed_next}


def maybe_demote() -> Optional[dict]:
    """Leadership-view refresh: if the cloud's epoch record is newer than
    this process's view, adopt it. When this process BELIEVED it was the
    coordinator (it returned from a stall to find a standby leading a
    newer epoch), it demotes: the flag makes `broadcast` refuse ops, and
    the supervisor records why. Returns the adopted record, else None."""
    global _DEMOTED
    rec = D.epoch_record()
    if rec["epoch"] < D.epoch():
        return None
    if rec["epoch"] == D.epoch() and rec["leader"] == D.leader():
        return None
    # same-epoch leader mismatch happens when two standbys raced an
    # election and both wrote epoch N+1 (the record is a last-writer-wins
    # upsert): the overwritten winner must discover it lost here, or the
    # cloud splits brain with two coordinators publishing under one epoch
    was_leading = D.is_coordinator()
    D.set_leader(rec["leader"], rec["epoch"])
    if was_leading and rec["leader"] != D.process_index():
        _DEMOTED = True
        from h2o3_tpu_torch.parallel import supervisor

        supervisor.degrade(
            f"demoted: process {rec['leader']} assumed coordination "
            f"(epoch {rec['epoch']}) while this ex-coordinator was away — "
            "rejoin() as a follower or restart this process",
            hold_s=float("inf"))
        from h2o3_tpu_torch.utils import timeline

        timeline.record("cloud", "demoted", epoch=rec["epoch"],
                        leader=rec["leader"])
    return rec


def follower_lag() -> List[dict]:
    """Per-follower replay progress for GET /3/CloudStatus: last acked
    sequence, ack lag vs the coordinator's published head, incarnation.
    Truncated (checkpointed) acks count as caught-up-to-checkpoint, so
    every follower has a row even when a checkpoint truncated all of its
    acks."""
    from h2o3_tpu_torch.parallel import ckpt

    head = current_seq()                 # ops < head are published
    last: Dict[int, int] = {}
    incs: Dict[int, int] = {}
    for k, v in D.kv_dir(f"{_PREFIX}/ack/"):
        parts = k.split("/")
        if len(parts) < 4 or not parts[2].isdigit():
            continue
        try:
            s, p = int(parts[2]), int(parts[3])
        except ValueError:
            continue
        if s >= last.get(p, -1):
            last[p] = s
            try:
                rec = json.loads(v)
            except (ValueError, TypeError):
                rec = None
            if isinstance(rec, dict):   # guard like acks_for: a corrupt
                incs[p] = int(rec.get("inc", 0))   # ack must not 500 the
                                                   # status route
    base = ckpt.latest_seq()
    exp_incs = expected_incarnations()
    procs = set(last) | set(exp_incs) | {
        p for p in range(D.process_count()) if p != D.leader()}
    rows = []
    for p in sorted(procs):
        la = last.get(p, base if base is not None else -1)
        rows.append({"process": p,
                     "incarnation": incs.get(p, exp_incs.get(p, 0)),
                     "last_acked_seq": la,
                     "ack_lag": max(head - 1 - la, 0)})
    return rows
