"""The port's cloud supervision tier (tests/test_supervision.py's cases
on the port): the acknowledged oplog, bounded waits, retry with backoff,
the HEALTHY/DEGRADED/FAILED/RECOVERING state machine, control-plane
checkpoints, rejoin, the standby election and the recovery watchdog.

Reference: water/RPC.java retries every remote task with exponential
backoff; water/HeartBeatThread.java turns a silent node death into an
explicit cloud event. These tests drive the whole protocol (publish,
replay, ack, error, heartbeat, supervise) in one process: the cloud KV
is `distributed.memory_kv()` (a dict), the topology is monkeypatched to
look like a 2-process cloud, and `failure.inject()` supplies the crashes
a dead peer would. tests/test_torch_cloud_mp.py runs real processes.
The reference's cases on the jax client's KV quirks, on its scoring
micro-batcher's broadcast (ROADMAP A14.7) and on `fetch_remote` (A14.5)
are recast for what the port has; a parity case holds the KV records of
one scripted sequence to the reference's.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

from h2o3_tpu_torch.core import failure
from h2o3_tpu_torch.parallel import ckpt
from h2o3_tpu_torch.parallel import distributed as D
from h2o3_tpu_torch.parallel import oplog, supervisor
from h2o3_tpu_torch.utils import retry

pytestmark = pytest.mark.chaos


@pytest.fixture()
def cl():
    import h2o3_tpu_torch

    return h2o3_tpu_torch.init(device="cpu")


@pytest.fixture(autouse=True)
def _keep_dkv():
    """A rejoin installs every object of its snapshot, including ones
    other tests of this worker removed since: each package's DKV is put
    back as it was, the very same objects, when a test ends."""
    from h2o3_tpu.core.dkv import DKV as JDKV

    from h2o3_tpu_torch.core.dkv import DKV

    saved = [(d, dict(d._store)) for d in (DKV, JDKV)]
    yield
    for d, items in saved:
        with d._lock:
            d._store.clear()
            d._store.update(items)


@pytest.fixture()
def mem_cloud(monkeypatch):
    """Simulated 2-process cloud: dict-backed KV + coordinator topology.
    the process itself stays one process (work runs locally), which
    is exactly what makes the protocol paths deterministic here."""
    with D.memory_kv() as kv:
        monkeypatch.setattr(D, "process_count", lambda: 2)
        monkeypatch.setattr(D, "is_coordinator", lambda: True)
        monkeypatch.setenv("H2O_TPU_RETRY_BASE_MS", "1")
        # bound every ack wait so a test bug can never park a thread on
        # the production 300 s default (tests override per-case as needed)
        monkeypatch.setenv("H2O_TPU_OP_ACK_TIMEOUT_S", "30")
        # checkpointing off by default: tests that exercise it opt in (a
        # surprise 'checkpoint' op would shift every seq assertion here)
        monkeypatch.setenv("H2O_TPU_OPLOG_CHECKPOINT_OPS", "0")
        # synchronous checkpoints: the ckpt op lands at a deterministic
        # seq and the chaos fault injections hit the op they target (the
        # async path has its own dedicated test)
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_ASYNC", "0")
        # these tests drive every transition BY HAND — the autonomous
        # watchdog would race them (its own tests re-enable it)
        monkeypatch.setenv("H2O_TPU_AUTO_RECOVER", "0")
        failure.set_incarnation(0)
        D.reset_leadership()
        oplog._DEMOTED = False
        oplog.reset()
        supervisor.reset()
        yield kv
        ckpt.wait_idle()       # never leak an in-flight ckpt across tests
    failure.set_incarnation(0)
    D.reset_leadership()
    oplog._DEMOTED = False
    oplog.reset()
    supervisor.reset()


# ---------------------------------------------------------------------------
# retry.py
# ---------------------------------------------------------------------------

class TestRetry:
    def test_succeeds_after_transient_failures(self):
        calls, slept = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert retry.retry_call(flaky, retries=4, base_s=0.001,
                                sleep=slept.append) == "ok"
        assert len(calls) == 3 and len(slept) == 2

    def test_exhaustion_raises_original_error(self):
        slept = []
        with pytest.raises(OSError, match="always"):
            retry.retry_call(lambda: (_ for _ in ()).throw(OSError("always")),
                             retries=3, base_s=0.001, sleep=slept.append)
        assert len(slept) == 2          # attempts-1 backoffs

    def test_retry_on_filters_exception_types(self):
        calls = []

        def boom():
            calls.append(1)
            raise ValueError("not retryable here")

        with pytest.raises(ValueError):
            retry.retry_call(boom, retries=5, retry_on=(OSError,),
                             sleep=lambda s: None)
        assert len(calls) == 1          # no retries for non-matching type

    def test_backoff_doubles_and_caps(self):
        ds = list(retry.backoff_delays(attempts=6, base_s=0.01, max_s=0.05,
                                       jitter=0.0))
        assert ds == [0.01, 0.02, 0.04, 0.05, 0.05]

    def test_backoff_jitter_bounded(self):
        for d, nominal in zip(retry.backoff_delays(attempts=4, base_s=0.01,
                                                   max_s=10.0, jitter=0.5),
                              (0.01, 0.02, 0.04)):
            assert 0.5 * nominal <= d <= 1.5 * nominal

    def test_adaptive_poll_grows_and_resets(self):
        slept = []
        p = retry.AdaptivePoll(min_s=0.001, max_s=0.25, sleep=slept.append)
        for _ in range(12):
            p.wait()
        assert slept[0] == pytest.approx(0.001)
        assert slept[-1] == pytest.approx(0.25)       # capped cold
        assert all(b >= a for a, b in zip(slept, slept[1:]))
        p.reset()
        assert p.current_s == pytest.approx(0.001)    # hot again


# ---------------------------------------------------------------------------
# publish: lost-put rollback + retry
# ---------------------------------------------------------------------------

class TestPublish:
    def test_lost_kv_put_raises_and_rolls_back_seq(self, mem_cloud,
                                                   monkeypatch):
        monkeypatch.setenv("H2O_TPU_RETRY_MAX", "2")
        monkeypatch.setattr(D, "kv_put", lambda k, v: False)
        with pytest.raises(oplog.OplogPublishError, match="op 0"):
            oplog.publish("noop", {})
        # slot rolled back: nothing at seq 0, and the next publish (with a
        # working KV) re-claims 0 — the follower sees a gapless sequence
        monkeypatch.undo()
        monkeypatch.setenv("H2O_TPU_RETRY_BASE_MS", "1")
        assert oplog.publish("noop", {}) == 0
        assert "oplog/0" in mem_cloud

    def test_injected_put_loss_rolls_back_and_caller_retry_lands(
            self, mem_cloud):
        """A HARD put loss (transport retries exhausted) raises with the
        slot rolled back; a caller retrying the publish — the scoring
        micro-batcher's pattern — gets the SAME slot, so the follower
        still sees a gapless sequence."""
        with failure.inject("oplog.kv_put", times=1):
            seq = retry.retry_call(oplog.publish, "noop", {},
                                   retry_on=(oplog.OplogPublishError,),
                                   base_s=0.001)
        assert seq == 0
        assert json.loads(mem_cloud["oplog/0"])["kind"] == "noop"

    def test_publish_faultpoint_fails_cleanly(self, mem_cloud):
        with failure.inject("oplog.publish", times=1):
            with pytest.raises(failure.InjectedFault):
                oplog.publish("noop", {})
        assert oplog.publish("noop", {}) == 0         # nothing was claimed


# ---------------------------------------------------------------------------
# turn(): bounded turnstile wait + slot abandonment
# ---------------------------------------------------------------------------

class TestTurnDeadline:
    def test_dead_predecessor_raises_instead_of_hanging(self, mem_cloud,
                                                        monkeypatch):
        monkeypatch.setenv("H2O_TPU_OP_ACK_TIMEOUT_S", "0")  # isolate turnstile
        oplog.publish("noop", {})            # seq 0: holder never turns
        seq1 = oplog.publish("noop", {})
        t0 = time.monotonic()
        with pytest.raises(oplog.OplogTurnTimeout, match="stuck at op 0"):
            with oplog.turn(seq1, timeout_s=0.3):
                pass
        assert time.monotonic() - t0 < 5.0   # bounded, not the old forever

    def test_timed_out_waiter_releases_never_entered_head(self, mem_cloud,
                                                          monkeypatch):
        """A head holder that died between publish and turn must not cost
        every later op its own full deadline: the first timed-out waiter
        releases the head slot too, neutralizes both ops to noops in the
        KV, and degrades the cloud."""
        monkeypatch.setenv("H2O_TPU_OP_ACK_TIMEOUT_S", "0")
        for _ in range(3):
            oplog.publish("noop", {})
        with pytest.raises(oplog.OplogTurnTimeout, match="head slot 0"):
            with oplog.turn(1, timeout_s=0.2):       # 0 never turned
                pass
        # both abandoned ops are neutralized so a lagging follower
        # replays nothing the coordinator never ran
        for s in (0, 1):
            assert json.loads(mem_cloud[f"oplog/{s}"])["kind"] == "noop"
        assert supervisor.state() == supervisor.DEGRADED
        # op 2 enters IMMEDIATELY — no serial re-pay of the deadline
        t0 = time.monotonic()
        ran = []
        with oplog.turn(2, timeout_s=5.0):
            ran.append(2)
        assert ran == [2] and time.monotonic() - t0 < 1.0

    def test_late_arriving_holder_of_abandoned_slot_refuses(self, mem_cloud,
                                                            monkeypatch):
        """The presumed-dead holder shows up after all: it must refuse to
        execute out of broadcast order (its op is already a noop) and
        hand the turnstile onward instead of stalling it."""
        monkeypatch.setenv("H2O_TPU_OP_ACK_TIMEOUT_S", "0")
        for _ in range(2):
            oplog.publish("noop", {})
        with pytest.raises(oplog.OplogTurnTimeout):
            with oplog.turn(1, timeout_s=0.2):
                pass
        with pytest.raises(oplog.OplogTurnTimeout, match="abandoned"):
            with oplog.turn(0, timeout_s=5.0):       # the late holder
                raise AssertionError("abandoned op must not execute")
        # and the turnstile moved on: a fresh op proceeds instantly
        seq = oplog.publish("noop", {})
        with oplog.turn(seq, timeout_s=5.0):
            pass

    def test_slow_executing_head_is_left_alone(self, mem_cloud,
                                               monkeypatch):
        """A head holder INSIDE its turn (long device program) is alive —
        a timed-out waiter abandons only itself, never the head."""
        monkeypatch.setenv("H2O_TPU_OP_ACK_TIMEOUT_S", "0")
        oplog.publish("noop", {})
        seq1 = oplog.publish("noop", {})
        entered = threading.Event()
        release = threading.Event()
        done = []

        def slow_head():
            with oplog.turn(0, timeout_s=5.0):
                entered.set()
                release.wait(10)
            done.append(0)

        t = threading.Thread(target=slow_head, daemon=True)
        t.start()
        assert entered.wait(5)
        with pytest.raises(oplog.OplogTurnTimeout) as ei:
            with oplog.turn(seq1, timeout_s=0.2):
                pass
        assert "head slot" not in str(ei.value)      # head NOT released
        release.set()
        t.join(10)
        assert done == [0]                           # head completed fine

    def test_none_ticket_stays_free(self):
        with oplog.turn(None):               # single-process path: no-op
            pass


# ---------------------------------------------------------------------------
# ack protocol + follower loop
# ---------------------------------------------------------------------------

class TestAcks:
    def test_follower_acks_each_replay(self, mem_cloud):
        t = threading.Thread(
            target=lambda: oplog.follower_loop(idle_timeout_s=10),
            daemon=True)
        t.start()
        for _ in range(3):
            seq = oplog.broadcast("noop", {})
            with oplog.turn(seq, timeout_s=10):
                pass                          # exit waits for the ack
        assert {f"oplog/ack/{i}/0" for i in range(3)} <= set(mem_cloud)
        oplog.publish("shutdown", {})
        t.join(timeout=10)
        assert not t.is_alive()

    def test_wait_acks_timeout_degrades_cloud(self, mem_cloud):
        oplog.publish("noop", {})            # no follower running
        t0 = time.monotonic()
        with pytest.raises(failure.CloudUnhealthyError, match="0/1"):
            oplog.wait_acks(0, timeout_s=0.3)
        assert time.monotonic() - t0 < 5.0
        assert supervisor.state() == supervisor.DEGRADED
        # the degrade is HELD: a wedged peer that keeps beating must not
        # instantly re-arm the cloud on the next heartbeat evaluation
        now = time.time()
        for p in (0, 1):
            mem_cloud[f"h2o3/heartbeat/{p}"] = json.dumps({"ts": now,
                                                           "proc": p})
        assert supervisor.evaluate() == supervisor.DEGRADED
        # ... and recovers once the hold ages out
        with supervisor._LOCK:
            supervisor._STATE["hold_until"] = time.time() - 1
        assert supervisor.evaluate() == supervisor.HEALTHY

    def test_wait_acks_bails_fast_when_cloud_already_failed(self,
                                                           mem_cloud):
        """A replay crash on ANOTHER op must fail this op's ack wait
        immediately with that diagnosis — not a generic timeout 300s
        later."""
        supervisor.fail("follower replay of op 3 crashed",
                        "Traceback ...\nOtherOpBoom")
        t0 = time.monotonic()
        with pytest.raises(failure.CloudUnhealthyError,
                           match="OtherOpBoom"):
            oplog.wait_acks(7, timeout_s=300.0)
        assert time.monotonic() - t0 < 5.0

    def test_wait_acks_surfaces_remote_traceback(self, mem_cloud):
        mem_cloud["oplog/error/0"] = json.dumps(
            {"kind": "train", "trace": "Traceback ...\nBoomError: kaput"})
        with pytest.raises(failure.CloudUnhealthyError,
                           match="BoomError: kaput") as ei:
            oplog.wait_acks(0, timeout_s=5)
        assert "BoomError" in ei.value.remote_trace
        assert supervisor.state() == supervisor.FAILED

    def test_replay_crash_error_key_before_death(self, mem_cloud):
        oplog.publish("noop", {})
        with failure.inject("oplog.replay", times=1):
            with pytest.raises(failure.InjectedFault):
                oplog.follower_loop(idle_timeout_s=5)
        rec = json.loads(mem_cloud["oplog/error/0"])
        assert rec["kind"] == "noop"
        assert "injected fault: oplog.replay" in rec["trace"]

    def test_lost_ack_hits_timeout_not_error_path(self, mem_cloud):
        oplog.publish("noop", {})
        with failure.inject("oplog.ack", times=1):
            with pytest.raises(failure.InjectedFault):
                oplog.follower_loop(idle_timeout_s=5)
        assert "oplog/error/0" not in mem_cloud   # replay itself succeeded
        with pytest.raises(failure.CloudUnhealthyError, match="acks"):
            oplog.wait_acks(0, timeout_s=0.2)

    def test_lost_ack_write_is_loud_and_nonfatal(self, mem_cloud,
                                                 monkeypatch):
        """A follower whose ack WRITE is lost (kv_put budget exhausted)
        must not silently proceed — the coordinator would stall the full
        ack timeout and then degrade with a misleading 'follower dead'
        diagnosis. It records a NON-fatal error (the replay succeeded:
        states did not diverge) and dies; wait_acks surfaces the true
        story immediately and the cloud DEGRADES rather than
        sticky-FAILs."""
        monkeypatch.setenv("H2O_TPU_RETRY_MAX", "2")
        real = D.kv_put
        monkeypatch.setattr(
            D, "kv_put",
            lambda k, v: False if k.startswith("oplog/ack/")
            else real(k, v))
        oplog.publish("noop", {})
        with pytest.raises(oplog.OplogAckError, match="could not write"):
            oplog.follower_loop(idle_timeout_s=5)
        rec = json.loads(mem_cloud["oplog/error/0"])
        assert rec["kind"] == "ack" and rec["fatal"] is False
        t0 = time.monotonic()
        with pytest.raises(failure.CloudUnhealthyError, match="non-fatal"):
            oplog.wait_acks(0, timeout_s=30)
        assert time.monotonic() - t0 < 5.0            # no 30 s stall
        assert supervisor.state() == supervisor.DEGRADED
        assert supervisor.evaluate() == supervisor.DEGRADED  # not FAILED

    def test_transient_ack_loss_absorbed_by_retry(self, mem_cloud,
                                                  monkeypatch):
        """One blipped ack write is absorbed by _ack's second retry round:
        the ack lands, no error record appears, wait_acks returns."""
        real = D.kv_put
        fails = {"left": 1}

        def flaky(k, v):
            if k.startswith("oplog/ack/") and fails["left"]:
                fails["left"] -= 1
                return False
            return real(k, v)

        monkeypatch.setattr(D, "kv_put", flaky)
        oplog.publish("noop", {})
        oplog.publish("shutdown", {})
        assert oplog.follower_loop(idle_timeout_s=5) == 1
        assert "oplog/ack/0/0" in mem_cloud
        assert "oplog/error/0" not in mem_cloud
        oplog.wait_acks(0, timeout_s=5)               # ack landed: no raise

    def test_stale_ack_cannot_satisfy_a_reclaimed_slot(self, mem_cloud):
        """Indeterminate put: op 0's kv_put reported lost (slot rolled
        back) but the follower acked SOMETHING under seq 0. A different
        op reclaiming the slot must not be satisfied by that stale ack —
        acks match on the op identity token, not the slot number."""
        with failure.inject("oplog.kv_put", times=1):
            with pytest.raises(oplog.OplogPublishError):
                oplog.publish("noop", {})
        mem_cloud["oplog/ack/0/1"] = json.dumps(
            {"proc": 1, "ts": time.time(), "op_id": "the-lost-op"})
        assert oplog.publish("noop", {"fresh": True}) == 0   # reclaimed
        with pytest.raises(failure.CloudUnhealthyError, match="0/1"):
            oplog.wait_acks(0, timeout_s=0.3)

    def test_abandoned_slot_already_replayed_fails_cloud(self, mem_cloud,
                                                         monkeypatch):
        """If a follower ALREADY replayed an op whose turnstile slot gets
        abandoned, the divergence is certain (the follower ran a program
        the coordinator never will): sticky FAILED, not a held degrade."""
        monkeypatch.setenv("H2O_TPU_OP_ACK_TIMEOUT_S", "0")
        oplog.publish("noop", {})            # head; holder never arrives
        seq1 = oplog.publish("noop", {})
        op0 = json.loads(mem_cloud["oplog/0"])
        mem_cloud["oplog/ack/0/1"] = json.dumps(
            {"proc": 1, "ts": time.time(), "op_id": op0["op_id"]})
        with pytest.raises(oplog.OplogTurnTimeout):
            with oplog.turn(seq1, timeout_s=0.2):
                pass
        assert supervisor.state() == supervisor.FAILED
        assert "diverged" in supervisor.status()["reason"]

    def test_follower_idle_timeout_error_path(self, mem_cloud):
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="idle for 0.2s at op 0"):
            oplog.follower_loop(idle_timeout_s=0.2)
        assert time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# supervisor state machine
# ---------------------------------------------------------------------------

class TestSupervisor:
    def test_stale_heartbeat_degrades_then_recovers(self, mem_cloud):
        now = time.time()
        mem_cloud["h2o3/heartbeat/0"] = json.dumps({"ts": now, "proc": 0})
        mem_cloud["h2o3/heartbeat/1"] = json.dumps({"ts": now - 1000,
                                                    "proc": 1})
        assert supervisor.evaluate() == supervisor.DEGRADED
        st = supervisor.status()
        assert "stale heartbeat" in st["reason"] and "[1]" in st["reason"]
        with pytest.raises(failure.CloudUnhealthyError):
            oplog.broadcast("noop", {})      # degraded: refused fast
        # the peer comes back: beats refresh, the cloud recovers
        mem_cloud["h2o3/heartbeat/1"] = json.dumps({"ts": time.time(),
                                                    "proc": 1})
        assert supervisor.evaluate() == supervisor.HEALTHY
        assert oplog.broadcast("noop", {}) == 0      # serving again

    def test_never_beaten_follower_degrades_after_grace(self, mem_cloud,
                                                        monkeypatch):
        """A follower that died at STARTUP has no stale heartbeat row to
        trip on — its absence past the staleness window must degrade the
        cloud all the same."""
        now = time.time()
        mem_cloud["h2o3/heartbeat/0"] = json.dumps({"ts": now, "proc": 0})
        assert supervisor.evaluate() == supervisor.HEALTHY   # inside grace
        monkeypatch.setattr(supervisor, "_FIRST_EVAL_TS", now - 100)
        assert supervisor.evaluate() == supervisor.DEGRADED
        assert "never heartbeat" in supervisor.status()["reason"]
        # the missing peer finally boots and beats: cloud recovers
        mem_cloud["h2o3/heartbeat/1"] = json.dumps({"ts": time.time(),
                                                    "proc": 1})
        assert supervisor.evaluate() == supervisor.HEALTHY

    def test_replay_error_fails_cloud_permanently(self, mem_cloud):
        mem_cloud["oplog/error/4"] = json.dumps({"kind": "predict",
                                                 "trace": "tb"})
        assert supervisor.evaluate() == supervisor.FAILED
        # FAILED is sticky: fresh heartbeats do NOT recover a diverged cloud
        now = time.time()
        for p in (0, 1):
            mem_cloud[f"h2o3/heartbeat/{p}"] = json.dumps({"ts": now,
                                                           "proc": p})
        del mem_cloud["oplog/error/4"]
        assert supervisor.evaluate() == supervisor.FAILED

    def test_failed_cloud_fails_inflight_jobs_with_trace(self, mem_cloud):
        from h2o3_tpu_torch.core.job import Job

        ev = threading.Event()
        job = Job(description="wedged collective")
        job.start(lambda j: ev.wait(10), background=True)
        try:
            supervisor.fail("follower replay of op 7 crashed",
                            "Traceback ...\nRemoteBoom: dead peer")
            assert job.status == Job.FAILED
            assert "RemoteBoom: dead peer" in job.exception
        finally:
            ev.set()
        time.sleep(0.05)                     # worker unwinds...
        assert job.status == Job.FAILED      # ...but cannot resurrect DONE

    def test_created_job_failed_by_supervisor_never_runs(self, mem_cloud):
        """A job failed while still CREATED (cloud died between submit
        and thread start) must honor the verdict, not resurrect itself
        to RUNNING and execute against a dead cloud."""
        from h2o3_tpu_torch.core.job import Job

        job = Job(description="doomed before start")
        supervisor.fail("cloud died pre-start", "pre-start trace")
        assert job.status == Job.FAILED
        ran = []
        job.start(lambda j: ran.append(1), background=False)
        assert ran == []
        assert job.status == Job.FAILED
        assert "pre-start trace" in job.exception

    def test_cluster_health_staleness_boundary(self, mem_cloud):
        now = time.time()
        mem_cloud["h2o3/heartbeat/0"] = json.dumps({"ts": now - 29.0,
                                                    "proc": 0})
        mem_cloud["h2o3/heartbeat/1"] = json.dumps({"ts": now - 31.0,
                                                    "proc": 1})
        rows = failure.cluster_health(stale_after_s=30.0)
        by_proc = {r["process"]: r for r in rows}
        assert by_proc[0]["healthy"] is True       # just inside the window
        assert by_proc[1]["healthy"] is False      # just past it
        assert by_proc[1]["age_s"] > by_proc[0]["age_s"]

    def test_heartbeat_faultpoint_drops_beat(self, mem_cloud):
        with failure.inject("failure.heartbeat", times=1):
            with pytest.raises(failure.InjectedFault):
                failure.heartbeat()
        assert failure.heartbeat()           # next beat lands
        assert "h2o3/heartbeat/0" in mem_cloud

    def test_recover_check_is_atomic_with_hold(self, mem_cloud,
                                               monkeypatch):
        """evaluate() must hold the state lock ACROSS its hold_until check
        and the recover() transition: a degrade(hold_s=...) landing from
        another thread (an ack-timeout handler recording fresh wedged-peer
        evidence) can then never slip between the two and be erased
        together with its hold."""
        supervisor.degrade("old evidence")               # hold expired
        now = time.time()
        for p in (0, 1):
            mem_cloud[f"h2o3/heartbeat/{p}"] = json.dumps({"ts": now,
                                                           "proc": p})
        lock_held_during_recover = []
        real = supervisor.recover

        def spying(*a, **k):
            got = []

            def probe():
                ok = supervisor._LOCK.acquire(timeout=0.2)
                if ok:
                    supervisor._LOCK.release()
                got.append(ok)

            t = threading.Thread(target=probe)
            t.start()
            t.join()
            lock_held_during_recover.append(not got[0])
            return real(*a, **k)

        monkeypatch.setattr(supervisor, "recover", spying)
        assert supervisor.evaluate() == supervisor.HEALTHY
        assert lock_held_during_recover == [True]


# ---------------------------------------------------------------------------
# distributed KV fallbacks
# ---------------------------------------------------------------------------

class _FlakyStore:
    """A TCPStore whose first `fail` sets raise a transport error, or
    every set when `fail` is None."""

    def __init__(self, store, fail=1):
        self._s, self.fail, self.sets = store, fail, 0

    def set(self, key, value):
        self.sets += 1
        if self.fail is None or self.sets <= self.fail:
            raise RuntimeError("Connection reset by peer")
        self._s.set(key, value)

    def __getattr__(self, name):
        return getattr(self._s, name)


@pytest.fixture()
def tcp_store():
    """A real TCPStore in this process, installed as the cloud's store
    (process 0 of a cloud of one)."""
    import datetime

    import torch.distributed as dist

    st = dist.TCPStore("127.0.0.1", 0, 1, True,
                       timeout=datetime.timedelta(seconds=30),
                       wait_for_workers=False)
    D.initialize(store=st, num_processes=1, process_id=0)
    yield st
    D.shutdown()


class TestKVFallbacks:
    """The KV on a ``torch.distributed`` store (the reference's cases on
    client's quirks, recast for the store's)."""

    def test_kv_put_transient_fault_retried_and_indexed(self, tcp_store,
                                                        monkeypatch):
        monkeypatch.setenv("H2O_TPU_RETRY_BASE_MS", "1")
        flaky = _FlakyStore(tcp_store, fail=1)
        monkeypatch.setattr(D, "_STORE", flaky)
        assert D.kv_put("a/k", "v1") is True         # second attempt
        assert D.kv_put("a/k", "v2") is True         # upsert
        assert D.kv_try_get("a/k") == "v2"
        assert D.kv_dir("a/") == [("a/k", "v2")]     # indexed once
        assert D.kv_put_if_absent("a/k", "v3") is False
        assert D.kv_put_if_absent("a/j", "v4") is True
        assert sorted(D.kv_dir("a/")) == [("a/j", "v4"), ("a/k", "v2")]

    def test_absent_reads_never_block_and_get_keeps_deadline(self,
                                                             tcp_store):
        t0 = time.monotonic()
        assert D.kv_try_get("nope") is None
        assert D.kv_dir("nope/") == []
        assert time.monotonic() - t0 < 1.0           # no store timeout
        t0 = time.monotonic()
        assert D.kv_get("nope", timeout_ms=200) is None
        assert 0.15 < time.monotonic() - t0 < 5.0    # waited, no retry
        D.kv_put("x/1", "a")
        D.kv_delete("x/1")
        assert D.kv_try_get("x/1") is None and D.kv_dir("x/") == []
        D._compact_index(tcp_store)
        assert "x/1" not in D._index_names(tcp_store)
        D.kv_put("x/1", "b")                         # re-created: listed
        assert D.kv_dir("x/") == [("x/1", "b")]

    def test_kv_put_real_loss_returns_false(self, tcp_store, monkeypatch):
        monkeypatch.setenv("H2O_TPU_RETRY_MAX", "2")
        monkeypatch.setenv("H2O_TPU_RETRY_BASE_MS", "1")
        flaky = _FlakyStore(tcp_store, fail=None)
        monkeypatch.setattr(D, "_STORE", flaky)
        assert D.kv_put("k", "v") is False
        assert flaky.sets == 2
        assert D.kv_try_get("k") is None


# ---------------------------------------------------------------------------
# predictions on a mirrored cloud (the micro-batcher's coalesced op and
# degraded local serving are ROADMAP A14.7)
# ---------------------------------------------------------------------------

def _acker(kv, stop, proc=1, inc=0):
    """Stands in for a follower's replay duty: acks every op."""
    while not stop.is_set():
        for k in list(kv.keys()):
            m = re.fullmatch(r"oplog/(\d+)", k)
            if not m or f"oplog/ack/{m.group(1)}/{proc}" in kv:
                continue
            try:
                rec = json.loads(kv[k])
            except (ValueError, TypeError, KeyError):
                continue
            kv[f"oplog/ack/{m.group(1)}/{proc}"] = json.dumps(
                {"proc": proc, "ts": time.time(),
                 "op_id": rec.get("op_id"), "inc": inc})
        time.sleep(0.005)


class TestScoringSupervision:
    def _served(self, cl, mem_cloud):
        import numpy as np

        from h2o3_tpu_torch.api.server import start_server
        from h2o3_tpu_torch.core.frame import Column, Frame
        from h2o3_tpu_torch.models.tree.gbm import GBM

        rng = np.random.default_rng(3)
        fr = Frame()
        fr.add("x", Column.from_numpy(rng.standard_normal(128)))
        fr.add("y", Column.from_numpy(rng.standard_normal(128)))
        fr.install()
        m = GBM(ntrees=3, max_depth=3, seed=1).train(y="y",
                                                      training_frame=fr)
        return start_server(port=0), m, fr

    def test_predict_ships_a_mirrored_predict_op(self, cl, mem_cloud):
        import numpy as np

        from h2o3_tpu_torch.core.dkv import DKV

        now = time.time()
        for p in (0, 1):
            mem_cloud[f"h2o3/heartbeat/{p}"] = json.dumps({"ts": now,
                                                           "proc": p})
        srv, m, fr = self._served(cl, mem_cloud)
        stop = threading.Event()
        t = threading.Thread(target=_acker, args=(mem_cloud, stop),
                             daemon=True)
        t.start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            _post(base, f"/3/Predictions/models/{m.key}/frames/{fr.key}",
                  {"predictions_frame": "p_mirrored"})
        finally:
            stop.set()
            t.join(5)
            srv.stop()
        ops = [json.loads(v) for k, v in mem_cloud.items()
               if re.fullmatch(r"oplog/\d+", k)]
        assert [o["kind"] for o in ops] == ["predict"]
        assert ops[0]["payload"]["destination_frame"] == "p_mirrored"
        got = DKV.get("p_mirrored")
        want = m.predict(fr)
        assert np.array_equal(got.col(got.names[0]).to_numpy(),
                              want.col(want.names[0]).to_numpy())
        for k in ("p_mirrored", str(fr.key), str(m.key)):
            DKV.remove(k)

    def test_degraded_cloud_refuses_predict_with_503(self, cl, mem_cloud):
        from h2o3_tpu_torch.core.dkv import DKV

        srv, m, fr = self._served(cl, mem_cloud)
        supervisor.degrade("peer went quiet")
        try:
            base = f"http://127.0.0.1:{srv.port}"
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base, f"/3/Predictions/models/{m.key}/frames/"
                      f"{fr.key}", {})
            assert ei.value.code == 503
            assert "peer went quiet" in ei.value.read().decode()
        finally:
            srv.stop()
        assert not any(re.fullmatch(r"oplog/\d+", k) for k in mem_cloud)
        for k in (str(fr.key), str(m.key)):
            DKV.remove(k)

    def test_score_batch_replay_matches_the_coordinator(self, cl,
                                                        mem_cloud):
        import numpy as np

        from h2o3_tpu_torch.core.dkv import DKV
        from h2o3_tpu_torch.core.frame import Column, Frame
        from h2o3_tpu_torch.models.tree.gbm import GBM

        rng = np.random.default_rng(5)
        fr = Frame()
        fr.add("x", Column.from_numpy(rng.standard_normal(96)))
        fr.add("y", Column.from_numpy(rng.standard_normal(96)))
        fr.install()
        m = GBM(ntrees=3, max_depth=3, seed=2).train(y="y",
                                                      training_frame=fr)
        oplog._apply("score_batch", {
            "model": str(m.key),
            "requests": [{"frame": str(fr.key),
                          "destination_frame": "p_batch",
                          "with_metrics": True}]})
        got, want = DKV.get("p_batch"), m.predict(fr)
        assert np.array_equal(got.col(got.names[0]).to_numpy(),
                              want.col(want.names[0]).to_numpy())
        for k in ("p_batch", str(fr.key), str(m.key)):
            DKV.remove(k)


# ---------------------------------------------------------------------------
# REST surface: lifecycle wiring + end-to-end chaos (acceptance criteria)
# ---------------------------------------------------------------------------

def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


def _post(base, path, data):
    body = "&".join(f"{k}={urllib.request.quote(str(v))}"
                    for k, v in data.items()).encode()
    req = urllib.request.Request(base + path, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _wait_job(base, key, timeout_s=60.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        j = _get(base, f"/3/Jobs/{urllib.request.quote(key, safe='')}")
        j = j["jobs"][0]
        if j["status"] not in ("CREATED", "RUNNING"):
            return j
        time.sleep(0.05)
    raise AssertionError(f"job {key} still running after {timeout_s}s")


@pytest.fixture()
def chaos_csv(tmp_path):
    import numpy as np

    rng = np.random.default_rng(0)
    p = tmp_path / "chaos.csv"
    with open(p, "w") as f:
        f.write("x,y\n")
        for _ in range(200):
            x = rng.normal()
            f.write(f"{x:.5f},{'YN'[int(x > 0)]}\n")
    return str(p)


class TestRestSupervision:
    def test_heartbeat_and_supervisor_autostart_multiprocess(
            self, cl, mem_cloud, monkeypatch):
        """Satellite 3 regression: start_server on a multi-process cloud
        wires the beater + supervisor; stop() tears both down."""
        from h2o3_tpu_torch.api.server import start_server

        monkeypatch.setenv("H2O_TPU_SUPERVISE_INTERVAL_S", "0.05")
        srv = start_server(port=0)
        try:
            hb, sup = srv.heartbeat_thread, srv.supervisor
            assert hb is not None and sup is not None
            deadline = time.time() + 10
            while time.time() < deadline and \
                    "h2o3/heartbeat/0" not in mem_cloud:
                time.sleep(0.02)
            assert "h2o3/heartbeat/0" in mem_cloud    # /3/Cloud liveness
            assert _get(f"http://127.0.0.1:{srv.port}",
                        "/3/CloudStatus")["state"] == "HEALTHY"
        finally:
            srv.stop()
        assert srv.heartbeat_thread is None and srv.supervisor is None
        assert hb._stop.is_set() and sup._stop.is_set()

    def test_no_duplicate_beater_when_runtime_already_beats(
            self, cl, mem_cloud, monkeypatch):
        """On a real multi-process cloud core.runtime already runs the
        beater on every process — start_server must not stack a second
        one on the coordinator."""
        from h2o3_tpu_torch.api.server import start_server
        from h2o3_tpu_torch.core import runtime

        monkeypatch.setenv("H2O_TPU_SUPERVISE_INTERVAL_S", "3600")
        sentinel = failure.HeartbeatThread(interval_s=3600)
        monkeypatch.setattr(runtime._CLUSTER, "_heartbeat", sentinel)
        srv = start_server(port=0)
        try:
            assert srv.heartbeat_thread is None       # runtime's suffices
            assert srv.supervisor is not None
        finally:
            srv.stop()

    def test_restarted_cloud_server_rederives_state_from_evidence(
            self, cl, mem_cloud, monkeypatch):
        """A re-started cloud must not inherit the previous incarnation's
        sticky FAILED verdict — but persistent error keys in the KV must
        immediately re-derive it."""
        from h2o3_tpu_torch.api.server import start_server

        monkeypatch.setenv("H2O_TPU_SUPERVISE_INTERVAL_S", "3600")
        supervisor.fail("old incarnation crashed", "stale trace")
        srv = start_server(port=0)          # fresh KV: verdict cleared
        try:
            assert supervisor.state() == supervisor.HEALTHY
        finally:
            srv.stop()
        # same restart but the error key SURVIVED (same coordination
        # service): the synchronous first evaluate() re-fails immediately
        supervisor.fail("old incarnation crashed", "stale trace")
        mem_cloud["oplog/error/2"] = json.dumps({"kind": "train",
                                                 "trace": "still here"})
        srv = start_server(port=0)
        try:
            assert supervisor.state() == supervisor.FAILED
            assert "op 2" in supervisor.status()["reason"]
        finally:
            srv.stop()

    def test_single_process_server_skips_supervision_threads(self, cl):
        from h2o3_tpu_torch.api.server import start_server

        srv = start_server(port=0)
        try:
            assert srv.heartbeat_thread is None and srv.supervisor is None
            out = _get(f"http://127.0.0.1:{srv.port}", "/3/Cloud")
            assert out["cloud_status"] == "HEALTHY"
        finally:
            srv.stop()

    def test_replay_crash_fails_job_with_remote_trace(self, cl, mem_cloud,
                                                      monkeypatch,
                                                      chaos_csv):
        """an injected follower replay crash surfaces on the
        coordinator as a FAILED job carrying the remote traceback within
        the ack timeout — the pre-supervision oplog would have sat in the
        unbounded publish/turn waits forever."""
        from h2o3_tpu_torch.api.server import start_server

        monkeypatch.setenv("H2O_TPU_OP_ACK_TIMEOUT_S", "20")
        monkeypatch.setenv("H2O_TPU_SUPERVISE_INTERVAL_S", "0.05")
        srv = start_server(port=0)
        base = f"http://127.0.0.1:{srv.port}"

        def doomed_follower():
            # the injected crash is the POINT — die like a real follower
            # would, without tripping pytest's unhandled-thread warning
            with pytest.raises(failure.InjectedFault):
                oplog.follower_loop(idle_timeout_s=30)

        follower = threading.Thread(target=doomed_follower, daemon=True)
        try:
            with failure.inject("oplog.replay", times=1):
                follower.start()
                out = _post(base, "/3/Parse",
                            {"source_frames": f'["{chaos_csv}"]',
                             "destination_frame": "chaos.hex"})
                job = _wait_job(base, out["job"]["key"]["name"])
            assert job["status"] == "FAILED"
            assert "injected fault: oplog.replay" in (job["exception"] or "")
            assert "remote traceback" in (job["exception"] or "")
            # the supervisor folded the error key into cloud state ...
            st = _get(base, "/3/CloudStatus")
            assert st["state"] == "FAILED"
            assert st["oplog_errors"] and \
                "oplog.replay" in st["oplog_errors"][0]["trace"]
            cloud = _get(base, "/3/Cloud")
            assert cloud["cloud_status"] == "FAILED"
            assert cloud["cloud_healthy"] is False
            # ... and new multi-process ops are refused fast with a 503
            t0 = time.monotonic()
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base, "/3/Parse",
                      {"source_frames": f'["{chaos_csv}"]',
                       "destination_frame": "chaos2.hex"})
            assert ei.value.code == 503
            assert time.monotonic() - t0 < 10.0
            body = json.loads(ei.value.read())
            assert "FAILED" in body.get("msg", "")
        finally:
            srv.stop()
            follower.join(timeout=5)
            # drain the failed job's worker thread (the supervisor marks
            # the Job FAILED while its thread may still be mid-parse) so
            # no straggler outlives this test's cloud epoch
            from h2o3_tpu_torch.core.dkv import DKV

            jobj = DKV.get(job["key"]["name"]) if "job" in locals() else None
            th = getattr(jobj, "_thread", None)
            if th is not None:
                th.join(timeout=30)

    def test_cloudstatus_reflects_stale_heartbeat_transitions(
            self, cl, mem_cloud, monkeypatch):
        """GET /3/CloudStatus walks HEALTHY -> DEGRADED ->
        HEALTHY as a peer's heartbeat goes stale and returns."""
        from h2o3_tpu_torch.api.server import start_server

        monkeypatch.setenv("H2O_TPU_SUPERVISE_INTERVAL_S", "3600")
        srv = start_server(port=0)          # evaluate() driven by the test
        base = f"http://127.0.0.1:{srv.port}"
        try:
            now = time.time()
            mem_cloud["h2o3/heartbeat/1"] = json.dumps({"ts": now,
                                                        "proc": 1})
            supervisor.evaluate()
            assert _get(base, "/3/CloudStatus")["state"] == "HEALTHY"
            mem_cloud["h2o3/heartbeat/1"] = json.dumps({"ts": now - 999,
                                                        "proc": 1})
            supervisor.evaluate()
            st = _get(base, "/3/CloudStatus")
            assert st["state"] == "DEGRADED"
            assert "stale heartbeat" in st["reason"]
            assert any(not r["healthy"] for r in st["process_health"])
            mem_cloud["h2o3/heartbeat/1"] = json.dumps({"ts": time.time(),
                                                        "proc": 1})
            supervisor.evaluate()
            st = _get(base, "/3/CloudStatus")
            assert st["state"] == "HEALTHY"
            trans = [(t["from"], t["to"]) for t in st["transitions"]]
            assert ("HEALTHY", "DEGRADED") in trans
            assert ("DEGRADED", "HEALTHY") in trans
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# checkpoint + compaction
# ---------------------------------------------------------------------------

def _live_oplog_keys(kv):
    slots = [k for k in kv if re.fullmatch(r"oplog/\d+", k)]
    acks = [k for k in kv if k.startswith("oplog/ack/")]
    return slots, acks


class TestCheckpointCompaction:
    def test_footprint_stays_o_interval_after_many_ops(self, mem_cloud,
                                                       monkeypatch,
                                                       tmp_path):
        """after N >> interval acknowledged ops, live oplog/*
        keys stay O(interval) — the acked prefix is truncated at every
        checkpoint instead of living in the KV forever."""
        monkeypatch.setenv("H2O_TPU_OPLOG_CHECKPOINT_OPS", "8")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        t = threading.Thread(
            target=lambda: oplog.follower_loop(idle_timeout_s=15),
            daemon=True)
        t.start()
        for i in range(50):
            seq = oplog.broadcast("noop", {"i": i})
            with oplog.turn(seq, timeout_s=15):
                pass
        slots, acks = _live_oplog_keys(mem_cloud)
        # 50 user ops (+ interleaved checkpoint ops) went through; only
        # the un-truncated tail may remain
        assert len(slots) <= 2 * 8, sorted(slots)
        assert len(acks) <= 2 * 8, sorted(acks)
        assert ckpt.latest_seq() is not None and ckpt.latest_seq() >= 32
        # checkpoint records themselves are GCd (H2O_TPU_OPLOG_CKPT_KEEP)
        assert len([k for k in mem_cloud
                    if k.startswith("oplog/ckpt/")]) <= ckpt.keep_ckpts()
        assert supervisor.evaluate() != supervisor.FAILED
        oplog.publish("shutdown", {})
        t.join(timeout=15)
        assert not t.is_alive()

    def test_checkpoint_restores_dkv_control_plane(self, cl, mem_cloud,
                                                   monkeypatch, tmp_path):
        """A checkpoint carries the DKV control plane: an object installed
        before the snapshot comes back via load_latest (the rejoin
        restore path), and the resume cursor points past the ckpt op."""
        from h2o3_tpu_torch.core.dkv import DKV

        monkeypatch.setenv("H2O_TPU_OPLOG_CHECKPOINT_OPS", "2")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        DKV.put("ckpt_probe_key", {"hello": 1})
        t = threading.Thread(
            target=lambda: oplog.follower_loop(idle_timeout_s=10),
            daemon=True)
        t.start()
        try:
            for i in range(3):
                seq = oplog.broadcast("noop", {"i": i})
                with oplog.turn(seq, timeout_s=10):
                    pass
            assert ckpt.latest_seq() is not None
            DKV.remove("ckpt_probe_key")
            next_seq, snap = ckpt.load_latest()
            assert DKV.get("ckpt_probe_key") == {"hello": 1}
            assert next_seq == ckpt.latest_seq() + 1
            assert "ckpt_probe_key" in snap["dkv"]["objects"]
        finally:
            DKV.remove("ckpt_probe_key")
            oplog.publish("shutdown", {})
            t.join(timeout=10)

    def test_checkpoint_failure_never_fails_the_user_op(self, mem_cloud,
                                                        monkeypatch,
                                                        tmp_path):
        """A failed snapshot write is logged and retried at the next
        interval — the op that crossed the threshold still succeeds."""
        monkeypatch.setenv("H2O_TPU_OPLOG_CHECKPOINT_OPS", "2")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        t = threading.Thread(
            target=lambda: oplog.follower_loop(idle_timeout_s=10),
            daemon=True)
        t.start()
        try:
            with failure.inject("ckpt.write", times=1):
                for i in range(2):
                    seq = oplog.broadcast("noop", {"i": i})
                    with oplog.turn(seq, timeout_s=10):
                        pass          # 2nd turn triggers the doomed ckpt
            assert ckpt.latest_seq() is None          # write was injected
            for i in range(2):
                seq = oplog.broadcast("noop", {"i": i})
                with oplog.turn(seq, timeout_s=10):
                    pass
            assert ckpt.latest_seq() is not None      # next interval landed
        finally:
            oplog.publish("shutdown", {})
            t.join(timeout=10)

    def test_async_checkpoint_does_not_block_crossing_op(self, mem_cloud,
                                                         monkeypatch,
                                                         tmp_path):
        """With H2O_TPU_OPLOG_CKPT_ASYNC (the production default) the user
        op that crosses the interval threshold returns while the snapshot
        is still in flight on the background thread; the checkpoint and
        truncation land shortly after (ckpt.wait_idle joins them)."""
        monkeypatch.setenv("H2O_TPU_OPLOG_CHECKPOINT_OPS", "2")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_ASYNC", "1")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        gate = threading.Event()
        real_write = ckpt.write_checkpoint

        def gated_write(seq):
            gate.wait(10)              # park the snapshot until released
            return real_write(seq)

        monkeypatch.setattr(ckpt, "write_checkpoint", gated_write)
        t = threading.Thread(
            target=lambda: oplog.follower_loop(idle_timeout_s=15),
            daemon=True)
        t.start()
        try:
            for i in range(2):
                seq = oplog.broadcast("noop", {"i": i})
                with oplog.turn(seq, timeout_s=15):
                    pass               # 2nd op's turn tail spawns the ckpt
            # the crossing op is DONE while the snapshot is still parked
            # behind the gate: async checkpointing never billed it
            assert ckpt.latest_seq() is None
            gate.set()
            assert ckpt.wait_idle(timeout_s=15)
            assert ckpt.latest_seq() == 2            # ops 0,1 then ckpt op
            slots, acks = _live_oplog_keys(mem_cloud)
            assert not slots and not acks            # prefix truncated
        finally:
            gate.set()
            oplog.publish("shutdown", {})
            t.join(timeout=15)

    def test_ops_acked_during_inflight_ckpt_still_count(self, mem_cloud,
                                                        monkeypatch,
                                                        tmp_path):
        """User ops acknowledged while an async checkpoint is still
        truncating must count toward the NEXT interval — dropping them
        would stretch the effective interval past
        H2O_TPU_OPLOG_CHECKPOINT_OPS under load and break the documented
        O(interval) bound on live oplog keys."""
        monkeypatch.setenv("H2O_TPU_OPLOG_CHECKPOINT_OPS", "2")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_ASYNC", "1")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        gate, entered = threading.Event(), threading.Event()
        real_trunc = ckpt.truncate_through

        def gated_trunc(seq):
            entered.set()
            gate.wait(10)              # park the compaction tail
            return real_trunc(seq)

        monkeypatch.setattr(ckpt, "truncate_through", gated_trunc)
        t = threading.Thread(
            target=lambda: oplog.follower_loop(idle_timeout_s=15),
            daemon=True)
        t.start()
        try:
            for i in range(2):
                seq = oplog.broadcast("noop", {"i": i})
                with oplog.turn(seq, timeout_s=15):
                    pass
            assert entered.wait(10)    # ckpt op acked, truncation parked
            # a full interval's worth of user ops acks while the first
            # checkpoint is still in flight
            for i in range(2):
                seq = oplog.broadcast("noop", {"i": i})
                with oplog.turn(seq, timeout_s=15):
                    pass
            gate.set()
            assert ckpt.wait_idle(timeout_s=15)
            first = ckpt.latest_seq()
            assert first == 2                        # ops 0,1 then ckpt op
            # the next acked op crosses the (already-reached) threshold:
            # checkpoint 2 fires — the in-flight window lost no counts
            seq = oplog.broadcast("noop", {"final": True})
            with oplog.turn(seq, timeout_s=15):
                pass
            assert ckpt.wait_idle(timeout_s=15)
            assert ckpt.latest_seq() > first
        finally:
            gate.set()
            oplog.publish("shutdown", {})
            t.join(timeout=15)

    def test_demoted_excoordinator_checkpoint_refuses(self, mem_cloud):
        """A stalled ex-coordinator's in-flight checkpoint thread resuming
        after a standby won the epoch must not publish (at a stale seq) or
        truncate the shared KV — same gate broadcast() enforces."""
        oplog._DEMOTED = True
        assert ckpt.checkpoint_now() is None
        assert oplog.current_seq() == 0              # nothing published

    def test_truncation_mid_wait_is_not_an_ack_timeout(self, mem_cloud,
                                                       monkeypatch,
                                                       tmp_path):
        """A wait_acks(N) poller racing the compactor must treat a
        truncated prefix as satisfied: truncation only runs after the
        covering checkpoint op was fully acked, so op N's vanished ack
        records prove success — timing out (and degrading the cloud) for
        a fully-acknowledged op would be a false alarm."""
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        seq = oplog.publish("noop", {})
        oplog._ack(seq, json.loads(mem_cloud[f"oplog/{seq}"])["op_id"])
        # the compactor truncates the acked prefix between two of the
        # waiter's polls: the ack record disappears
        ckpt.truncate_through(seq)
        assert f"oplog/ack/{seq}/0" not in mem_cloud
        t0 = time.monotonic()
        oplog.wait_acks(seq, timeout_s=5)            # returns, no raise
        assert time.monotonic() - t0 < 2.0
        assert supervisor.state() == supervisor.HEALTHY


# ---------------------------------------------------------------------------
# incarnations + follower readmission
# ---------------------------------------------------------------------------

class TestIncarnations:
    def test_stale_incarnation_ack_rejected(self, mem_cloud):
        """A proc that rejoined at incarnation 1 must ack with inc >= 1:
        an ack its dead predecessor (inc 0) left behind — even with the
        RIGHT op identity token — cannot satisfy wait_acks."""
        oplog._write_rejoin(0, 1, "caught_up", 0)
        seq = oplog.publish("noop", {})
        op_id = json.loads(mem_cloud[f"oplog/{seq}"])["op_id"]
        mem_cloud[f"oplog/ack/{seq}/0"] = json.dumps(
            {"proc": 0, "ts": time.time(), "op_id": op_id, "inc": 0})
        with pytest.raises(failure.CloudUnhealthyError, match="0/1"):
            oplog.wait_acks(seq, timeout_s=0.3)
        # the fresh incarnation's ack does satisfy it
        mem_cloud[f"oplog/ack/{seq}/0"] = json.dumps(
            {"proc": 0, "ts": time.time(), "op_id": op_id, "inc": 1})
        oplog.wait_acks(seq, timeout_s=5)

    def test_heartbeat_carries_incarnation(self, mem_cloud):
        failure.set_incarnation(3)
        failure.heartbeat()
        rows = failure.cluster_health()
        assert rows[0]["incarnation"] == 3


class TestRejoinRecovery:
    def test_full_loop_crash_rejoin_recover_new_op(self, cl, mem_cloud,
                                                   monkeypatch, tmp_path):
        """follower replay crash -> cloud FAILED ->
        follower rejoins from the checkpoint (fresh incarnation, suffix
        re-replayed, error evidence superseded) -> supervisor walks
        FAILED -> RECOVERING -> HEALTHY, reported via GET /3/CloudStatus
        -> a NEW multi-process op (oplog broadcast) succeeds."""
        from h2o3_tpu_torch.api.server import start_server

        monkeypatch.setenv("H2O_TPU_OPLOG_CHECKPOINT_OPS", "4")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        monkeypatch.setenv("H2O_TPU_OP_ACK_TIMEOUT_S", "15")
        monkeypatch.setenv("H2O_TPU_SUPERVISE_INTERVAL_S", "3600")
        srv = start_server(port=0)
        base = f"http://127.0.0.1:{srv.port}"
        try:
            # phase 1: healthy op stream deep enough to land a checkpoint
            def doomed():
                with pytest.raises(failure.InjectedFault):
                    oplog.follower_loop(idle_timeout_s=15)

            t1 = threading.Thread(target=doomed, daemon=True)
            t1.start()
            for i in range(5):
                seq = oplog.broadcast("noop", {"i": i})
                with oplog.turn(seq, timeout_s=15):
                    pass
            assert ckpt.latest_seq() is not None
            # phase 2: follower killed mid-replay -> FAILED
            with failure.inject("oplog.replay", times=1):
                seq = oplog.broadcast("noop", {"crash": True})
                with pytest.raises(failure.CloudUnhealthyError,
                                   match="injected fault"):
                    with oplog.turn(seq, timeout_s=15):
                        pass
            t1.join(timeout=10)
            assert supervisor.state() == supervisor.FAILED
            assert _get(base, "/3/CloudStatus")["state"] == "FAILED"
            with pytest.raises(failure.CloudUnhealthyError):
                oplog.broadcast("noop", {})          # refused while down
            # phase 3: the follower restarts and rejoins from the ckpt
            cursor = oplog.rejoin()
            assert cursor == oplog.current_seq()     # crashed op included
            assert failure.incarnation() == 1
            assert not oplog.error_records()         # evidence superseded
            assert supervisor.evaluate() == supervisor.HEALTHY
            st = _get(base, "/3/CloudStatus")
            assert st["state"] == "HEALTHY"
            trans = [(t["from"], t["to"]) for t in st["transitions"]]
            assert ("FAILED", "RECOVERING") in trans
            assert ("RECOVERING", "HEALTHY") in trans
            assert st["checkpoint_seq"] is not None
            rows = {r["process"]: r for r in st["process_health"]}
            assert rows[0]["incarnation"] == 1
            assert rows[0]["ack_lag"] == 0
            assert st["rejoins"][0]["phase"] == "caught_up"
            # phase 4: NEW multi-process ops are accepted and complete
            t2 = threading.Thread(
                target=lambda: oplog.follower_loop(idle_timeout_s=15,
                                                   start_seq=cursor),
                daemon=True)
            t2.start()
            seq = oplog.broadcast("noop", {"post_recovery": True})
            with oplog.turn(seq, timeout_s=15):
                pass                                  # acked by inc 1
            oplog.publish("shutdown", {})
            t2.join(timeout=15)
            assert not t2.is_alive()
        finally:
            srv.stop()

    def test_rejoin_crash_records_error_and_refails(self, mem_cloud,
                                                    monkeypatch, tmp_path):
        """A follower killed AGAIN mid-rejoin-replay surfaces the true
        story (error key) and the cloud re-FAILs instead of reporting a
        phantom recovery."""
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        oplog.publish("noop", {})
        supervisor.fail("follower died", "tb")
        with failure.inject("oplog.rejoin.replay", times=1):
            with pytest.raises(failure.InjectedFault):
                oplog.rejoin()
        assert oplog.error_records()
        assert supervisor.evaluate() == supervisor.FAILED
        # second restart completes the rejoin; cloud recovers
        cursor = oplog.rejoin()
        assert cursor == 1
        assert supervisor.evaluate() == supervisor.HEALTHY
        assert failure.incarnation() == 2

    def test_recovering_waits_for_caught_up_phase(self, mem_cloud):
        """A rejoin record still in phase 'replaying' moves the cloud to
        RECOVERING but NOT to HEALTHY — new ops stay refused until the
        suffix replay completes."""
        supervisor.fail("follower died", "tb")
        failure.set_incarnation(1)
        failure.heartbeat()
        oplog._write_rejoin(0, 1, "replaying", 0)
        assert supervisor.evaluate() == supervisor.RECOVERING
        with pytest.raises(failure.CloudUnhealthyError, match="RECOVERING"):
            oplog.broadcast("noop", {})
        oplog._write_rejoin(0, 1, "caught_up", 0)
        assert supervisor.evaluate() == supervisor.HEALTHY

    def test_rejoin_gate_is_incarnation_not_wallclock(self, mem_cloud):
        """FAILED -> RECOVERING is gated on an incarnation STRICTLY newer
        than the one on record at fail() time: a leftover rejoin record
        from a previous recovery must not re-trigger the arc, and a
        genuinely fresh rejoin stamped by a skewed clock (ts 'before' the
        failure) must not be blocked by it."""
        # a previous recovery left proc 0's inc-1 rejoin record standing
        failure.set_incarnation(1)
        failure.heartbeat()
        oplog._write_rejoin(0, 1, "caught_up", 0)
        supervisor.fail("follower died again", "tb")
        assert supervisor.evaluate() == supervisor.FAILED   # stale record
        # the restarted follower rejoins at inc 2, but its host clock runs
        # an hour behind the coordinator's
        failure.set_incarnation(2)
        failure.heartbeat()
        oplog._write_rejoin(0, 2, "caught_up", 0)
        k = f"{oplog._REJOIN_PREFIX}0"
        rec = json.loads(mem_cloud[k])
        rec["ts"] -= 3600.0
        mem_cloud[k] = json.dumps(rec)
        assert supervisor.evaluate() == supervisor.HEALTHY

    def test_second_real_restart_rejoins_strictly_newer(self, mem_cloud,
                                                        monkeypatch,
                                                        tmp_path):
        """A REAL process restart boots with the local incarnation counter
        at 0. The second crash/restart cycle must still produce an
        incarnation strictly newer than the one on cloud record at
        failure time — otherwise the FAILED -> RECOVERING gate can never
        be satisfied again and the cloud is permanently down."""
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        oplog.publish("noop", {})
        supervisor.fail("follower died", "tb")
        oplog.rejoin()
        assert failure.incarnation() == 1
        assert supervisor.evaluate() == supervisor.HEALTHY
        # crash again; the restarted process forgot its local counter
        supervisor.fail("follower died again", "tb2")
        failure.set_incarnation(0)
        oplog.rejoin()
        assert failure.incarnation() == 2    # seeded from cloud evidence
        assert supervisor.evaluate() == supervisor.HEALTHY

    def test_recovering_blocked_by_never_beaten_process(self, mem_cloud):
        """RECOVERING -> HEALTHY is also blocked by a peer that died
        leaving NO heartbeat row — same never-beat signal as the degrade
        path: absence past the staleness window."""
        supervisor.fail("follower 0 replay crashed", "tb")
        failure.set_incarnation(1)
        failure.heartbeat()
        oplog._write_rejoin(0, 1, "caught_up", 0)
        supervisor._FIRST_EVAL_TS = time.time() - 3600   # long past grace
        assert supervisor.evaluate() == supervisor.RECOVERING
        # the absent process finally beats: recovery completes
        mem_cloud["h2o3/heartbeat/1"] = json.dumps(
            {"ts": time.time(), "proc": 1, "inc": 0})
        assert supervisor.evaluate() == supervisor.HEALTHY

    def test_recovering_blocked_by_other_stale_process(self, mem_cloud):
        """RECOVERING -> HEALTHY demands the WHOLE cluster be live, not
        just the processes with rejoin records: a second follower that
        went silent during the outage (stale beat, no rejoin of its own)
        must keep new ops refused instead of letting each one burn the
        full ack timeout against a dead peer."""
        supervisor.fail("follower 0 replay crashed", "tb")
        mem_cloud["h2o3/heartbeat/1"] = json.dumps(
            {"ts": time.time() - 3600, "proc": 1, "inc": 0})
        failure.set_incarnation(1)
        failure.heartbeat()
        oplog._write_rejoin(0, 1, "caught_up", 0)
        assert supervisor.evaluate() == supervisor.RECOVERING
        with pytest.raises(failure.CloudUnhealthyError):
            oplog.broadcast("noop", {})
        # the silent process comes back: recovery completes
        mem_cloud["h2o3/heartbeat/1"] = json.dumps(
            {"ts": time.time(), "proc": 1, "inc": 0})
        assert supervisor.evaluate() == supervisor.HEALTHY

    def test_jobs_failed_once_stay_failed_across_recovery(self, mem_cloud):
        """Jobs in flight when the cloud died are failed ONCE (externally,
        with the remote trace); a later recovery never resurrects them."""
        from h2o3_tpu_torch.core.job import Job

        ev = threading.Event()
        job = Job(description="in flight at failure")
        job.start(lambda j: ev.wait(10), background=True)
        try:
            supervisor.fail("follower died", "RemoteBoom")
            assert job.status == Job.FAILED
            assert job.failed_externally is True
        finally:
            ev.set()
        failure.set_incarnation(1)
        failure.heartbeat()
        oplog._write_rejoin(0, 1, "caught_up", 0)
        assert supervisor.evaluate() == supervisor.HEALTHY
        assert job.status == Job.FAILED              # still failed
        assert "RemoteBoom" in job.exception


# ---------------------------------------------------------------------------
# standby-coordinator handoff
# ---------------------------------------------------------------------------

@pytest.fixture()
def standby_cloud(monkeypatch):
    """Simulated 2-process cloud where THIS process (index 0) is a
    FOLLOWER: the epoch record names process 1 as leader. is_coordinator
    stays REAL (leader-based) so the election can flip it."""
    with D.memory_kv() as kv:
        monkeypatch.setattr(D, "process_count", lambda: 2)
        monkeypatch.setenv("H2O_TPU_RETRY_BASE_MS", "1")
        monkeypatch.setenv("H2O_TPU_OP_ACK_TIMEOUT_S", "30")
        monkeypatch.setenv("H2O_TPU_OPLOG_CHECKPOINT_OPS", "0")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_ASYNC", "0")
        monkeypatch.setenv("H2O_TPU_AUTO_RECOVER", "0")
        failure.set_incarnation(0)
        D.write_epoch_record(0, 1)
        D.set_leader(1, 0)
        oplog._DEMOTED = False
        oplog.reset()
        supervisor.reset()
        yield kv
    failure.set_incarnation(0)
    D.reset_leadership()
    oplog._DEMOTED = False
    oplog.reset()
    supervisor.reset()


def _gbm_and_frame(seed=7):
    import numpy as np

    from h2o3_tpu_torch.core.frame import Column, Frame
    from h2o3_tpu_torch.models.tree.gbm import GBM

    rng = np.random.default_rng(seed)
    n = 400
    fr = Frame()
    x1 = rng.standard_normal(n)
    x2 = rng.standard_normal(n)
    fr.add("x1", Column.from_numpy(x1))
    fr.add("x2", Column.from_numpy(x2))
    y = np.where(x1 - 0.5 * x2 > 0, "Y", "N")
    fr.add("y", Column.from_numpy(y, ctype="enum"))
    model = GBM(ntrees=5, max_depth=3, seed=1).train(y="y",
                                                     training_frame=fr)
    score = Frame()
    score.add("x1", Column.from_numpy(rng.standard_normal(64)))
    score.add("x2", Column.from_numpy(rng.standard_normal(64)))
    return model, score


class TestHandoff:
    def test_election_refused_inside_grace_or_when_not_winner(
            self, cl, standby_cloud, monkeypatch):
        monkeypatch.setenv("H2O_TPU_ELECTION_GRACE_S", "60")
        now = time.time()
        # the leader is still beating: no election
        standby_cloud["h2o3/heartbeat/1"] = json.dumps({"ts": now,
                                                        "proc": 1})
        failure.heartbeat()
        with pytest.raises(oplog.ElectionLost, match="inside the election"):
            oplog.assume_coordination()
        assert not D.is_coordinator()
        # the leader itself never runs an election
        D.set_leader(0, 0)
        D.write_epoch_record(0, 0)
        with pytest.raises(oplog.ElectionLost, match="already leads"):
            oplog.assume_coordination()

    def test_follower_assumes_epoch_and_serves_scoring_bitwise(
            self, cl, standby_cloud, monkeypatch, tmp_path):
        """The coordinator dies with a score_batch op in flight; the
        surviving follower (which replayed and acked it) wins the
        deterministic election, seals the oplog past it, writes epoch 1,
        re-binds the REST server, and, once the ex-coordinator is back as
        a follower, serves a scoring request whose predictions are
        bitwise the pre-handoff replay's."""
        import numpy as np

        from h2o3_tpu_torch import scoring
        from h2o3_tpu_torch.api import server as api_server
        from h2o3_tpu_torch.core.dkv import DKV

        monkeypatch.setenv("H2O_TPU_ELECTION_GRACE_S", "5")
        monkeypatch.setenv("H2O_TPU_SUPERVISE_INTERVAL_S", "3600")
        model, score_fr = _gbm_and_frame()
        DKV.put(str(score_fr.key), score_fr)
        # the old coordinator published a score_batch op; we are the
        # follower replaying it (the in-flight op at the handoff boundary)
        standby_cloud["oplog/0"] = json.dumps({
            "kind": "score_batch", "op_id": "inflight-op",
            "payload": {"model": str(model.key),
                        "requests": [{"frame": str(score_fr.key),
                                      "destination_frame": "pred_before",
                                      "with_metrics": False}]}})
        with pytest.raises(TimeoutError):
            oplog.follower_loop(idle_timeout_s=0.3)   # replays op 0, acks
        assert "oplog/ack/0/0" in standby_cloud
        before = DKV.get("pred_before")
        assert before is not None
        before_vals = {c: np.asarray(before.col(c).data).copy()
                       for c in before.names}
        # the coordinator goes silent past the election grace
        standby_cloud["h2o3/heartbeat/1"] = json.dumps(
            {"ts": time.time() - 999, "proc": 1})
        failure.heartbeat()
        srv = api_server.assume_coordination(port=0, caught_up_seq=1)
        try:
            assert D.is_coordinator() and D.epoch() == 1
            rec = D.epoch_record()
            assert rec["epoch"] == 1 and rec["leader"] == 0
            sealed = json.loads(standby_cloud["oplog/sealed/0"])
            assert sealed["next_seq"] == 1           # past the acked op
            base = f"http://127.0.0.1:{srv.port}"
            st = _get(base, "/3/CloudStatus")
            assert st["epoch"] == 1 and st["leader"] == 0
            # the dead ex-coordinator degrades the cloud: a predict is
            # refused (degraded local serving is ROADMAP A14.7) until it
            # is back as a follower, beating and acking
            assert st["state"] == supervisor.DEGRADED
            path = (f"/3/Predictions/models/"
                    f"{urllib.request.quote(str(model.key), safe='')}"
                    f"/frames/"
                    f"{urllib.request.quote(str(score_fr.key), safe='')}")
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base, path, {"predictions_frame": "pred_after"})
            assert ei.value.code == 503
            standby_cloud["h2o3/heartbeat/1"] = json.dumps(
                {"ts": time.time(), "proc": 1, "inc": 1})
            assert supervisor.evaluate() == supervisor.HEALTHY
            stop = threading.Event()
            acker = threading.Thread(target=_acker,
                                     args=(standby_cloud, stop, 1, 1),
                                     daemon=True)
            acker.start()
            try:
                out = _post(base, path, {"predictions_frame": "pred_after"})
            finally:
                stop.set()
                acker.join(5)
            after = DKV.get(out["predictions_frame"]["name"])
            assert after is not None
            for c in before.names:
                av = np.asarray(after.col(c).data)
                bv = before_vals[c]
                assert np.array_equal(av[: len(bv)], bv[: len(av)]), c
        finally:
            srv.stop()
            DKV.remove("pred_before")
            DKV.remove("pred_after")
            DKV.remove(str(score_fr.key))
            DKV.remove(str(model.key))
            scoring.purge()

    def test_returned_ex_coordinator_demotes_on_newer_epoch(
            self, cl, standby_cloud):
        """The old coordinator comes back from a stall to find a standby
        leading a newer epoch: it adopts the record, refuses to run
        multi-process ops, and the supervisor says why."""
        D.set_leader(0, 0)                 # we BELIEVE we lead epoch 0
        D.write_epoch_record(2, 1)         # but proc 1 took epoch 2
        assert oplog.maybe_demote() is not None
        assert not D.is_coordinator() and D.epoch() == 2
        with pytest.raises(failure.CloudUnhealthyError, match="demoted"):
            oplog.broadcast("noop", {})
        assert "demoted" in supervisor.status()["reason"]

    def test_concurrent_election_loser_stands_down(self, cl, standby_cloud,
                                                   monkeypatch):
        """Two standbys race an election for epoch 1. The epoch record is
        written first-writer-wins (compare-and-set against the record the
        election read), so the later claimant's write does not land: it
        adopts the winner's record and stands down, never serving as a
        second coordinator under the same epoch."""
        monkeypatch.setenv("H2O_TPU_ELECTION_GRACE_S", "1")
        standby_cloud["h2o3/heartbeat/1"] = json.dumps(
            {"ts": time.time() - 999, "proc": 1})     # old leader dead
        failure.heartbeat()
        real_write = D.write_epoch_record

        def racing_write(epoch_no, leader_proc, expect=None):
            # a concurrent standby's claim lands first; ours is a
            # compare-and-set against the record both elections read
            real_write(epoch_no, 2, expect=expect)
            return real_write(epoch_no, leader_proc, expect=expect)

        monkeypatch.setattr(D, "write_epoch_record", racing_write)
        with pytest.raises(oplog.ElectionLost, match="concurrent election"):
            oplog.assume_coordination()
        # the loser adopted the winner's record and is NOT coordinator
        assert D.leader() == 2 and D.epoch() == 1
        assert not D.is_coordinator()

    def test_same_epoch_leader_overwrite_demotes(self, cl, standby_cloud):
        """Residual split-brain window: both racing standbys pass their
        read-back before the other's overwrite lands, so both briefly
        believe they lead epoch 1. The periodic maybe_demote must catch
        the same-epoch leader mismatch and demote the overwritten one."""
        D.set_leader(0, 1)                 # we BELIEVE we lead epoch 1
        D.write_epoch_record(1, 2)         # but proc 2's claim won the KV
        assert oplog.maybe_demote() is not None
        assert not D.is_coordinator()
        assert D.leader() == 2 and D.epoch() == 1
        with pytest.raises(failure.CloudUnhealthyError, match="demoted"):
            oplog.broadcast("noop", {})
        # matching view + record is a no-op (no demotion churn)
        D.write_epoch_record(1, 2)
        assert oplog.maybe_demote() is None


# ---------------------------------------------------------------------------
# the typed shard error; DKV snapshot restores
# ---------------------------------------------------------------------------

class TestSatelliteFixes:
    def test_shard_unavailable_error_names_owner_and_remedy(self):
        err = failure.ShardUnavailableError("cannot score frame f1",
                                            owners=[1, 2])
        assert isinstance(err, failure.CloudUnhealthyError)   # -> HTTP 503
        assert err.owners == [1, 2]
        assert "process(es) [1, 2]" in str(err)
        assert "Remediation" in str(err) and "rejoin" in str(err)

    def test_restore_puts_kv_entries_only_where_absent(self, cl,
                                                       mem_cloud):
        """restore_control_plane resurrects only the KV entries the live
        cloud lost: a key still present is at least as new as the
        snapshot's copy (first writer wins, not last)."""
        from h2o3_tpu_torch.core.dkv import DKV

        mem_cloud["h2o3/dkv/meta/K1"] = "live"
        DKV.restore_control_plane({"objects": {}, "kv": {
            "h2o3/dkv/meta/K1": "stale", "h2o3/dkv/meta/K2": "lost"}})
        assert mem_cloud["h2o3/dkv/meta/K1"] == "live"
        assert mem_cloud["h2o3/dkv/meta/K2"] == "lost"

    def test_snapshot_isolates_keys_and_restores_onto_given_device(
            self, cl, mem_cloud):
        """A value that does not pickle is listed in ``skipped`` and sinks
        nothing else; a restored model's tensors land on the device the
        restorer names, and it predicts as the original did."""
        import numpy as np

        from h2o3_tpu_torch.core.dkv import DKV

        model, score = _gbm_and_frame(seed=9)
        DKV.put(str(score.key), score)
        DKV.put("unpicklable", threading.Lock())
        try:
            snap = DKV.snapshot_control_plane()
            assert "unpicklable" in snap["skipped"]
            assert str(model.key) in snap["objects"]
            want = model.predict(score)
            for k in (str(model.key), str(score.key)):
                DKV.remove(k)
            restored = DKV.restore_control_plane(snap, device="cpu")
            assert str(model.key) in restored and str(score.key) in restored
            m2, s2 = DKV.get(str(model.key)), DKV.get(str(score.key))
            assert m2 is not model
            assert all(c.data.device.type == "cpu"
                       for c in (s2.col(n) for n in s2.names))
            got = m2.predict(s2)
            for c in want.names:
                assert np.array_equal(got.col(c).to_numpy(),
                                      want.col(c).to_numpy()), c
        finally:
            for k in ("unpicklable", str(model.key), str(score.key)):
                DKV.remove(k)


# ---------------------------------------------------------------------------
# autonomous recovery watchdog: one recovery action per tick,
# zero operator intervention — plus the Job.fail() race fix and the
# checkpoint-dir GC
# ---------------------------------------------------------------------------

from h2o3_tpu_torch.parallel import watchdog  # noqa: E402


class _Killed(Exception):
    """Stands in for the coordinator process dying mid-train."""


class TestWatchdogTicks:
    def test_disabled_by_env_takes_no_action(self, mem_cloud):
        """mem_cloud pins H2O_TPU_AUTO_RECOVER=0 (manual drills): the
        watchdog must observe it and do nothing."""
        watchdog.reset()
        wd = watchdog.Watchdog(interval=3600, follow=False)
        assert wd.tick() == "disabled"
        st = watchdog.status()
        assert st["enabled"] is False and st["ticks"] == 0

    def test_follower_stands_by_while_leader_beats(self, standby_cloud,
                                                   monkeypatch):
        monkeypatch.setenv("H2O_TPU_AUTO_RECOVER", "1")
        monkeypatch.setenv("H2O_TPU_ELECTION_GRACE_S", "60")
        watchdog.reset()
        standby_cloud["h2o3/heartbeat/1"] = json.dumps({"ts": time.time(),
                                                        "proc": 1})
        failure.heartbeat()
        wd = watchdog.Watchdog(interval=3600, follow=False)
        assert wd.tick() == "follower (leader alive)"
        assert not D.is_coordinator()
        assert watchdog.status()["elections"] == 0

    def test_demoted_ex_coordinator_auto_rejoins(self, mem_cloud,
                                                 monkeypatch, tmp_path):
        """A demoted ex-coordinator no longer waits for an operator's
        rejoin(): the next watchdog tick readmits it as a follower."""
        monkeypatch.setenv("H2O_TPU_AUTO_RECOVER", "1")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        watchdog.reset()
        oplog._DEMOTED = True
        wd = watchdog.Watchdog(interval=3600, follow=False)
        tag = wd.tick()
        assert tag.startswith("rejoined (demoted")
        assert not oplog.demoted()
        assert failure.incarnation() == 1
        assert oplog.rejoin_records()[0]["phase"] == "caught_up"
        assert watchdog.status()["rejoins"] == 1

    def test_crashed_follower_auto_rejoins(self, standby_cloud,
                                           monkeypatch, tmp_path):
        """A follower whose replay loop crashed is nudged through the
        existing rejoin path instead of staying dead."""
        monkeypatch.setenv("H2O_TPU_AUTO_RECOVER", "1")
        monkeypatch.setenv("H2O_TPU_ELECTION_GRACE_S", "60")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        watchdog.reset()
        standby_cloud["h2o3/heartbeat/1"] = json.dumps({"ts": time.time(),
                                                        "proc": 1})
        failure.heartbeat()
        oplog._REPLAY_CRASHED = True
        wd = watchdog.Watchdog(interval=3600, follow=False)
        assert wd.tick() == "rejoined (crashed follower)"
        assert not oplog.replay_crashed()
        assert failure.incarnation() == 1

    def test_no_leader_heartbeat_is_not_silence_during_boot(
            self, standby_cloud, monkeypatch):
        """A follower's watchdog can start before the coordinator's first
        beat lands in the KV: the missing row must not count as
        grace-elapsed silence, or every cloud boot risks a spurious
        takeover."""
        monkeypatch.setenv("H2O_TPU_AUTO_RECOVER", "1")
        monkeypatch.setenv("H2O_TPU_ELECTION_GRACE_S", "60")
        watchdog.reset()
        failure.heartbeat()               # we beat; the leader has no row
        wd = watchdog.Watchdog(interval=3600, follow=False)
        assert wd.tick() == "follower (no leader evidence yet)"
        assert not D.is_coordinator()
        assert watchdog.status()["elections"] == 0

    def test_tick_never_raises(self, standby_cloud, monkeypatch):
        """A transient KV fault inside a tick must not kill recovery for
        good: the error is recorded and the next tick retries."""
        monkeypatch.setenv("H2O_TPU_AUTO_RECOVER", "1")
        watchdog.reset()
        monkeypatch.setattr(oplog, "maybe_demote", lambda: 1 / 0)
        wd = watchdog.Watchdog(interval=3600, follow=False)
        assert wd.tick() == "error"
        assert "ZeroDivisionError" in watchdog.status()["last_error"]

    def test_resume_skips_exhausted_and_non_external_jobs(
            self, mem_cloud, monkeypatch, tmp_path):
        """A job that keeps dying is parked after MAX_ATTEMPTS dispatches,
        and a job the WORKER crashed (not the cloud) is never resurrected
        — only externally-failed jobs with durable progress come back."""
        from h2o3_tpu_torch.core.dkv import DKV
        from h2o3_tpu_torch.core.job import Job

        monkeypatch.setenv("H2O_TPU_AUTO_RECOVER", "1")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        watchdog.reset()
        exhausted = Job(description="poisoned")
        exhausted.fail("cloud FAILED")
        exhausted.attempt = watchdog.MAX_ATTEMPTS
        exhausted.resume_spec = {"algo": "gbm", "params": {},
                                 "training_frame": "nope", "y": "y"}
        ckpt.save_job_progress(str(exhausted.key), 4,
                               exhausted.resume_spec, {"phase": "x"})
        local_crash = Job(description="worker bug")
        local_crash.begin()
        local_crash.fail_local("trainer raised")   # NOT failed_externally
        ckpt.save_job_progress(str(local_crash.key), 2,
                               {"algo": "gbm", "params": {},
                                "training_frame": "nope", "y": "y"},
                               {"phase": "x"})
        try:
            assert watchdog.resume_failed_jobs() == []
            assert exhausted.status == Job.FAILED
            assert local_crash.status == Job.FAILED
            # both records were GCd: the parked job is dead for good, the
            # worker-crashed one is the client's to resubmit — neither may
            # leak its (potentially huge) progress file forever
            assert ckpt.load_job_progress(str(exhausted.key)) is None
            assert ckpt.load_job_progress(str(local_crash.key)) is None
            assert ckpt.job_progress_records() == []
        finally:
            for j in (exhausted, local_crash):
                ckpt.delete_job_progress(str(j.key))
                DKV.remove(str(j.key))


class TestJobCheckpointSurvival:
    def test_unpickled_inflight_job_fails_externally(self):
        """A job restored from a control-plane checkpoint has no worker
        thread by construction: restoring it still-RUNNING would park it
        in that state forever (the watchdog rightly leaves RUNNING jobs
        alone). It must come back FAILED+failed_externally — i.e. a
        resume candidate."""
        import pickle as _pickle

        from h2o3_tpu_torch.core.dkv import DKV
        from h2o3_tpu_torch.core.job import Job

        jobs = []
        for st in (Job.CREATED, Job.RUNNING, Job.RESUMING):
            job = Job(description=f"inflight {st}")
            jobs.append(job)
            job.status = st
            back = _pickle.loads(_pickle.dumps(job))
            assert back.status == Job.FAILED and back.failed_externally, st
            assert "in flight" in back.exception
        done = Job(description="done")
        jobs.append(done)
        done.begin()
        done.complete()
        back = _pickle.loads(_pickle.dumps(done))
        assert back.status == Job.DONE and not back.failed_externally
        for j in jobs:
            DKV.remove(str(j.key))


class TestJobFailRace:
    """Satellite: fail() and the worker's own completion interleave — the
    status lock must make the verdict single-writer."""

    def _job(self):
        from h2o3_tpu_torch.core.job import Job

        return Job(description="race probe")

    def _drop(self, *jobs):
        from h2o3_tpu_torch.core.dkv import DKV

        for j in jobs:
            DKV.remove(str(j.key))

    def test_external_fail_beats_completion(self):
        from h2o3_tpu_torch.core.job import Job

        job = self._job()
        try:
            assert job.begin()
            job.fail("cloud FAILED under the build")
            assert not job.complete()           # verdict kept
            assert job.status == Job.FAILED and job.failed_externally
            assert "cloud FAILED" in job.exception
        finally:
            self._drop(job)

    def test_completion_beats_late_external_fail(self):
        from h2o3_tpu_torch.core.job import Job

        job = self._job()
        try:
            assert job.begin()
            assert job.complete()
            job.fail("too late")                # no-op once terminal
            assert job.status == Job.DONE
            assert not job.failed_externally and job.exception is None
        finally:
            self._drop(job)

    def test_begin_refused_after_external_fail(self):
        job = self._job()
        try:
            job.fail("dead before the worker started")
            assert not job.begin()              # don't run on a dead cloud
        finally:
            self._drop(job)

    def test_concurrent_fail_and_complete_single_verdict(self):
        """Race the two writers for real: whatever the interleaving, the
        final state is exactly one of the two consistent verdicts — never
        DONE-with-external-failure or FAILED-without-the-flag."""
        from h2o3_tpu_torch.core.job import Job

        jobs = []
        for _ in range(50):
            job = self._job()
            jobs.append(job)
            assert job.begin()
            barrier = threading.Barrier(2)

            def failer():
                barrier.wait()
                job.fail("external")

            def completer():
                barrier.wait()
                job.complete()

            ts = [threading.Thread(target=failer),
                  threading.Thread(target=completer)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            ok_done = job.status == Job.DONE and not job.failed_externally \
                and job.exception is None
            ok_failed = job.status == Job.FAILED and job.failed_externally \
                and job.exception == "external"
            assert ok_done or ok_failed, (job.status, job.failed_externally)
        self._drop(*jobs)

    def test_stale_dispatch_thread_cannot_clobber_resumed_job(self):
        """A worker wedged in a dead collective outlives the external
        FAILED and the watchdog's restart: when it finally unwinds, its
        late exception (or result) must not touch the resumed dispatch —
        the generation guard in Job.start keeps verdicts single-writer
        across dispatches too."""
        from h2o3_tpu_torch.core.job import Job

        job = self._job()
        try:
            wedge = threading.Event()

            def wedged(j):
                wedge.wait(10)               # "stuck in a dead collective"
                raise RuntimeError("late abort from the old dispatch")

            job.start(wedged, background=True)
            t1 = job._thread
            job.fail("cloud FAILED")         # supervisor's verdict
            assert job.restart(resumed_from_iteration=2)
            go = threading.Event()

            def fresh(j):
                go.wait(10)
                return "model"

            job.start(fresh, background=True)
            wedge.set()                      # stale thread unwinds NOW
            t1.join(timeout=5)
            assert job.status == Job.RUNNING  # untouched by the old thread
            go.set()
            deadline = time.time() + 5
            while job.status == Job.RUNNING and time.time() < deadline:
                time.sleep(0.01)
            assert job.status == Job.DONE and job.attempt == 2
            assert job.result == "model"
        finally:
            self._drop(job)

    def test_restart_has_a_single_winner(self):
        """Two recovery passes racing restart() on one job must produce
        exactly one RESUMING dispatch."""
        from h2o3_tpu_torch.core.job import Job

        job = self._job()
        try:
            job.begin()
            job.fail("cloud FAILED")
            barrier = threading.Barrier(2)
            wins = []

            def racer():
                barrier.wait()
                wins.append(job.restart(resumed_from_iteration=4))

            ts = [threading.Thread(target=racer) for _ in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert sorted(wins) == [False, True]
            assert job.status == Job.RESUMING
            assert job.attempt == 2
            assert job.resumed_from_iteration == 4
        finally:
            self._drop(job)


class TestCheckpointGC:
    def test_keep_knob_bounds_snapshots(self, mem_cloud, monkeypatch,
                                        tmp_path):
        """Only the newest H2O_TPU_OPLOG_CKPT_KEEP snapshots survive a
        newer fully-acked checkpoint — KV records AND files."""
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_KEEP", "3")
        for s in range(6):
            ckpt.write_checkpoint(s)
        assert [s for s, _ in ckpt.records()] == [3, 4, 5]
        names = sorted(p.name for p in tmp_path.glob("ckpt_*.pkl"))
        assert names == [f"ckpt_{s:012d}.pkl" for s in (3, 4, 5)]

    def test_keep_zero_disables_gc(self, mem_cloud, monkeypatch, tmp_path):
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_KEEP", "0")
        for s in range(4):
            ckpt.write_checkpoint(s)
        assert [s for s, _ in ckpt.records()] == [0, 1, 2, 3]

    def test_mid_restore_snapshot_is_pinned(self, mem_cloud, monkeypatch,
                                            tmp_path):
        """GC must not delete the snapshot a rejoining follower is
        mid-restore on: its standing rejoin record (phase 'replaying')
        names the restore cursor. Once the rejoin completes, the next
        checkpoint sweeps it."""
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_KEEP", "1")
        ckpt.write_checkpoint(0)
        # proc 1 starts restoring from ckpt 0 (cursor == its next_seq)
        mem_cloud["oplog/rejoin/1"] = json.dumps(
            {"proc": 1, "inc": 1, "phase": "replaying", "seq": 1,
             "ts": time.time()})
        for s in (1, 2):
            ckpt.write_checkpoint(s)
        assert [s for s, _ in ckpt.records()] == [0, 2]   # 0 pinned, 1 GCd
        assert (tmp_path / "ckpt_000000000000.pkl").exists()
        assert not (tmp_path / "ckpt_000000000001.pkl").exists()
        # the rejoin completes: the pin lifts at the next checkpoint
        mem_cloud["oplog/rejoin/1"] = json.dumps(
            {"proc": 1, "inc": 1, "phase": "caught_up", "seq": 1,
             "ts": time.time()})
        ckpt.write_checkpoint(3)
        assert [s for s, _ in ckpt.records()] == [3]
        assert sorted(tmp_path.glob("ckpt_0*.pkl"))[-1].name \
            == "ckpt_000000000003.pkl"


class TestAutonomousArc:
    def test_kill_elect_rejoin_resume_bitwise_over_rest(
            self, cl, standby_cloud, monkeypatch, tmp_path):
        """the coordinator is killed mid-GBM-train;
        with NO manual assume_coordination()/rejoin() calls the watchdog
        elects this standby (REST re-binds), the restarted ex-coordinator
        rejoins as a follower, the interrupted job resumes from its last
        durable iteration under its ORIGINAL key, and the resumed model's
        REST predictions are bitwise-identical to the uninterrupted
        baseline's."""
        import numpy as np

        from h2o3_tpu_torch import scoring
        from h2o3_tpu_torch.api import server as api_server
        from h2o3_tpu_torch.core.dkv import DKV
        from h2o3_tpu_torch.core.frame import Column, Frame
        from h2o3_tpu_torch.core.job import Job
        from h2o3_tpu_torch.models.model_builder import ModelBuilder
        from h2o3_tpu_torch.models.tree.gbm import GBM

        monkeypatch.setenv("H2O_TPU_AUTO_RECOVER", "1")
        monkeypatch.setenv("H2O_TPU_ELECTION_GRACE_S", "0.2")
        monkeypatch.setenv("H2O_TPU_HEARTBEAT_STALE_S", "60")
        monkeypatch.setenv("H2O_TPU_SUPERVISE_INTERVAL_S", "3600")
        monkeypatch.setenv("H2O_TPU_JOB_CKPT_ITERS", "2")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        monkeypatch.setenv("H2O_TPU_OP_ACK_TIMEOUT_S", "15")
        watchdog.reset()

        rng = np.random.default_rng(17)
        n = 320
        fr = Frame()
        x1, x2 = rng.standard_normal(n), rng.standard_normal(n)
        fr.add("x1", Column.from_numpy(x1))
        fr.add("x2", Column.from_numpy(x2))
        fr.add("y", Column.from_numpy(
            np.where(x1 - 0.5 * x2 > 0, "Y", "N"), ctype="enum"))
        score = Frame()
        score.add("x1", Column.from_numpy(rng.standard_normal(64)))
        score.add("x2", Column.from_numpy(rng.standard_normal(64)))
        DKV.put(str(fr.key), fr)
        DKV.put(str(score.key), score)
        params = dict(ntrees=8, max_depth=3, seed=11)
        baseline = GBM(**params).train(y="y", training_frame=fr)

        # -- the doomed coordinator's build: durable progress, then death
        job = Job(description="GBM Model Build")
        job.resume_spec = {"algo": "gbm", "params": dict(params),
                           "training_frame": str(fr.key), "y": "y",
                           "model_id": "resumed_model",
                           "description": job.description}
        doomed = GBM(**params)
        doomed._progress_job = job
        orig_tick = ModelBuilder._tick_job_progress

        def tick_boom(self, done, fn):
            orig_tick(self, done, fn)
            if done >= 4:
                raise _Killed()

        monkeypatch.setattr(ModelBuilder, "_tick_job_progress", tick_boom)
        with pytest.raises(_Killed):
            doomed.train(y="y", training_frame=fr)
        monkeypatch.setattr(ModelBuilder, "_tick_job_progress", orig_tick)
        assert ckpt.load_job_progress(str(job.key))["iteration"] == 4
        # the Job object lived on the dead coordinator: this standby has
        # only the durable progress record (+ file) to work from
        DKV.remove(str(job.key))
        if doomed.job is not None:
            DKV.remove(str(doomed.job.key))

        # the coordinator goes silent past the election grace
        standby_cloud["h2o3/heartbeat/1"] = json.dumps(
            {"ts": time.time() - 999, "proc": 1})
        failure.heartbeat()

        # stand in for the rejoined ex-coordinator's replay duty: ack every
        # broadcast op at its post-restart incarnation
        stop_acks = threading.Event()

        ack_thread = threading.Thread(
            target=_acker, args=(standby_cloud, stop_acks, 1, 1),
            daemon=True)
        ack_thread.start()

        srv_box = {}

        def elect():
            srv_box["srv"] = api_server.assume_coordination(port=0)

        wd = watchdog.Watchdog(interval=0.05, elect=elect, follow=False)
        t0 = time.monotonic()
        wd.start()
        try:
            deadline = time.monotonic() + 15
            while not D.is_coordinator() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert D.is_coordinator() and D.epoch() == 1
            assert time.monotonic() - t0 < 10     # election fired promptly
            assert watchdog.status()["elections"] >= 1
            assert "srv" in srv_box               # REST re-bound by the wd
            # the ex-coordinator restarts and rejoins as a follower:
            # fresh beat + readmission record at incarnation 1
            standby_cloud["h2o3/heartbeat/1"] = json.dumps(
                {"ts": time.time(), "proc": 1, "inc": 1})
            standby_cloud["oplog/rejoin/1"] = json.dumps(
                {"proc": 1, "inc": 1, "phase": "caught_up", "seq": 0,
                 "ts": time.time()})
            base = f"http://127.0.0.1:{srv_box['srv'].port}"
            jk = urllib.request.quote(str(job.key), safe="")
            j = None
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                failure.heartbeat()
                try:
                    got = _get(base, f"/3/Jobs/{jk}")["jobs"]
                except urllib.error.HTTPError:
                    got = []                      # not recreated yet
                j = got[0] if got else None
                if j is not None and j["status"] == "DONE":
                    break
                time.sleep(0.05)
            assert j is not None and j["status"] == "DONE", j
            assert j["attempt"] == 2              # original + one resume
            assert j["resumed_from_iteration"] == 4
            st = _get(base, "/3/CloudStatus")
            assert st["state"] == supervisor.HEALTHY
            assert st["watchdog"]["jobs_resumed"] >= 1
            assert st["epoch"] == 1 and st["leader"] == 0
            # bitwise: score baseline and resumed model through the SAME
            # REST path and compare the prediction frames
            for mid, dest in ((str(baseline.key), "pred_base"),
                              ("resumed_model", "pred_resumed")):
                _post(base, f"/3/Predictions/models/"
                      f"{urllib.request.quote(mid, safe='')}/frames/"
                      f"{urllib.request.quote(str(score.key), safe='')}",
                      {"predictions_frame": dest})
            pb, pr = DKV.get("pred_base"), DKV.get("pred_resumed")
            assert pb is not None and pr is not None
            assert pb.names == pr.names
            for c in pb.names:
                assert np.array_equal(np.asarray(pb.col(c).data),
                                      np.asarray(pr.col(c).data)), c
        finally:
            wd.stop()
            stop_acks.set()
            ack_thread.join(timeout=5)
            srv = srv_box.get("srv")
            if srv is not None:
                srv.stop()
            scoring.purge()
            for k in ("pred_base", "pred_resumed", "resumed_model",
                      str(job.key), str(fr.key), str(score.key),
                      str(baseline.key)):
                DKV.remove(k)


    def test_kill_mid_automl_watchdog_resumes_leaderboard_over_rest(
            self, cl, standby_cloud, monkeypatch, tmp_path):
        """the coordinator dies mid-AutoML with two
        members durably done (trained TWO-WIDE — the overlap gauge is the
        concurrency evidence); with zero manual recovery calls the
        watchdog elects this standby, re-dispatches the search under the
        ORIGINAL AutoML job key, and the leaderboard completes over REST
        with the attempt counter carried."""
        import numpy as np

        from h2o3_tpu_torch.api import server as api_server
        from h2o3_tpu_torch.automl import search
        from h2o3_tpu_torch.automl.automl import H2OAutoML
        from h2o3_tpu_torch.core.dkv import DKV
        from h2o3_tpu_torch.core.frame import Column, Frame
        from h2o3_tpu_torch.core.job import Job

        monkeypatch.setenv("H2O_TPU_AUTO_RECOVER", "1")
        monkeypatch.setenv("H2O_TPU_ELECTION_GRACE_S", "0.2")
        monkeypatch.setenv("H2O_TPU_HEARTBEAT_STALE_S", "60")
        monkeypatch.setenv("H2O_TPU_SUPERVISE_INTERVAL_S", "3600")
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
        monkeypatch.setenv("H2O_TPU_OP_ACK_TIMEOUT_S", "15")
        monkeypatch.setenv("H2O_TPU_SEARCH_CONCURRENCY", "2")
        watchdog.reset()
        search.reset_stats()

        rng = np.random.default_rng(5)
        n = 400
        fr = Frame()
        x1, x2 = rng.standard_normal(n), rng.standard_normal(n)
        fr.add("x1", Column.from_numpy(x1))
        fr.add("x2", Column.from_numpy(x2))
        fr.add("y", Column.from_numpy(
            np.where(x1 - 0.5 * x2 > 0, "Y", "N"), ctype="enum"))
        DKV.put(str(fr.key), fr)

        project = "arc_automl"
        aml = H2OAutoML(max_models=3, nfolds=0, seed=42,
                        include_algos=["glm", "gbm"],
                        project_name=project)
        job = Job(description="AutoML", dest=project)
        aml._search_job = job

        # -- the doomed coordinator's search. It ran its members two-wide
        # while it was the cloud's only process (admission-sized width is
        # a single-process feature; mirrored clouds walk serial by
        # design); the standby attached just before the crash.
        monkeypatch.setattr(D, "process_count", lambda: 1)
        settled = {"n": 0}
        orig = search.SearchEngine._build_one

        def dying(self, m, build_fn, score_fn=None):
            if settled["n"] >= 2:
                raise _Killed()
            settled["n"] += 1
            return orig(self, m, build_fn, score_fn)

        monkeypatch.setattr(search.SearchEngine, "_build_one", dying)
        with pytest.raises(_Killed):
            aml.train(y="y", training_frame=fr)
        monkeypatch.setattr(search.SearchEngine, "_build_one", orig)
        monkeypatch.setattr(D, "process_count", lambda: 2)
        data = ckpt.load_search_state(str(job.key))
        assert data is not None
        done0 = sum(1 for m in data["state"]["members"].values()
                    if m["status"] == "done")
        assert done0 == 2
        assert search.stats()["overlap"] >= 2     # trainings overlapped
        # the Job object (and the doomed process's models) died with the
        # coordinator: durable search state is all that survives
        DKV.remove(str(job.key))

        # the coordinator goes silent past the election grace
        standby_cloud["h2o3/heartbeat/1"] = json.dumps(
            {"ts": time.time() - 999, "proc": 1})
        failure.heartbeat()

        # stand in for the rejoined ex-coordinator's replay duty
        stop_acks = threading.Event()

        ack_thread = threading.Thread(
            target=_acker, args=(standby_cloud, stop_acks, 1, 1),
            daemon=True)
        ack_thread.start()

        srv_box = {}

        def elect():
            srv_box["srv"] = api_server.assume_coordination(port=0)

        wd = watchdog.Watchdog(interval=0.05, elect=elect, follow=False)
        wd.start()
        try:
            deadline = time.monotonic() + 15
            while not D.is_coordinator() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert D.is_coordinator()
            assert "srv" in srv_box
            standby_cloud["h2o3/heartbeat/1"] = json.dumps(
                {"ts": time.time(), "proc": 1, "inc": 1})
            standby_cloud["oplog/rejoin/1"] = json.dumps(
                {"proc": 1, "inc": 1, "phase": "caught_up", "seq": 0,
                 "ts": time.time()})
            base = f"http://127.0.0.1:{srv_box['srv'].port}"
            jk = urllib.request.quote(str(job.key), safe="")
            j = None
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                failure.heartbeat()
                try:
                    got = _get(base, f"/3/Jobs/{jk}")["jobs"]
                except urllib.error.HTTPError:
                    got = []                      # not recreated yet
                j = got[0] if got else None
                if j is not None and j["status"] == "DONE":
                    break
                time.sleep(0.05)
            assert j is not None and j["status"] == "DONE", j
            assert j["attempt"] == 2              # original + one resume
            assert j["resumed_from_iteration"] == done0
            # the finished leaderboard under the ORIGINAL project key
            automl = _get(base, f"/99/AutoML/{project}")
            assert len(automl["leaderboard"]["models"]) >= 3
            st = _get(base, "/3/CloudStatus")
            assert st["state"] == supervisor.HEALTHY
            assert st["watchdog"]["searches_resumed"] >= 1
            assert st["search"]["stats"]["searches_resumed"] >= 1
            assert st["search"]["stats"]["members_done"] >= 3
            assert st["search"]["states"] == []   # superseded on finish
            # overlap + resume counters over the metrics surface
            with urllib.request.urlopen(base + "/3/Metrics",
                                        timeout=30) as r:
                text = r.read().decode()
            series = {}
            for ln in text.splitlines():
                if ln.startswith("h2o3_search_"):
                    parts = ln.split()
                    name = parts[0].split("{")[0]
                    series[name] = max(series.get(name, 0.0),
                                       float(parts[-1]))
            assert series.get("h2o3_search_members_overlap", 0) >= 2
            assert series.get("h2o3_search_resumed_total", 0) >= 1
        finally:
            wd.stop()
            stop_acks.set()
            ack_thread.join(timeout=5)
            srv = srv_box.get("srv")
            if srv is not None:
                srv.stop()
            aml2 = DKV.get(project)
            for m in list(getattr(aml2, "models", [])) + \
                    list(getattr(aml, "models", [])):
                DKV.remove(str(m.key))
            for k in (project, str(job.key), str(fr.key)):
                DKV.remove(k)


# ---------------------------------------------------------------------------
# chaos soak: sustained injected loss under a streaming op sequence
# ---------------------------------------------------------------------------

@pytest.mark.slow
class TestChaosSoak:
    def test_streaming_ops_survive_periodic_kv_loss(self, mem_cloud):
        """200 broadcast/replay/ack rounds with a lost KV put injected
        every 5th publish: the retry budget absorbs every loss, the
        follower sees a gapless sequence, and the cloud stays HEALTHY."""
        applied = []
        t = threading.Thread(
            target=lambda: oplog.follower_loop(
                idle_timeout_s=30, on_op=lambda k, p: applied.append(p["i"])),
            daemon=True)
        t.start()
        for i in range(200):
            if i % 5 == 0:
                failure._FAULTS["oplog.kv_put"] = 1
            # hard put losses roll the slot back; the caller-level retry
            # (the micro-batcher pattern) re-claims the SAME slot
            seq = retry.retry_call(oplog.broadcast, "noop", {"i": i},
                                   retry_on=(oplog.OplogPublishError,),
                                   base_s=0.001)
            assert seq == i
            with oplog.turn(seq, timeout_s=30):
                pass
        oplog.publish("shutdown", {})
        t.join(timeout=30)
        assert not t.is_alive()
        assert applied == list(range(200))
        assert supervisor.evaluate() != supervisor.FAILED


# ---------------------------------------------------------------------------
# the port's own fault points, and parity of the KV records with the
# reference's control plane
# ---------------------------------------------------------------------------

class TestPortFaultpoints:
    def test_injected_election_fault_leaves_leadership_untouched(
            self, standby_cloud):
        with failure.inject("oplog.election", times=1):
            with pytest.raises(failure.InjectedFault):
                oplog.assume_coordination(force=True)
        assert D.epoch() == 0 and D.leader() == 1
        assert D.epoch_record()["leader"] == 1
        assert not any(k.startswith("oplog/sealed/") for k in standby_cloud)

    def test_supervisor_thread_survives_a_failing_evaluate(self, mem_cloud):
        now = time.time()
        for p in (0, 1):
            mem_cloud[f"h2o3/heartbeat/{p}"] = json.dumps({"ts": now,
                                                           "proc": p})
        with failure.inject("supervisor.evaluate", times=3):
            sup = supervisor.Supervisor(interval=0.01).start()
            try:
                _until_true(lambda: "supervisor.evaluate"
                            not in failure._FAULTS)
                supervisor.degrade("after the faults")
                mem_cloud["h2o3/heartbeat/1"] = json.dumps(
                    {"ts": time.time() - 1000, "proc": 1})
                _until_true(lambda: "stale heartbeat"
                            in supervisor.status()["reason"])
            finally:
                sup.stop()


def _until_true(cond, deadline_s=10.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < deadline_s
        time.sleep(0.005)


def _normalized(kv):
    """The KV's control-plane records, each JSON record without its
    timestamps, op-id tokens and tracebacks (package-specific text)."""
    def strip(v):
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items()
                    if k not in ("ts", "op_id", "trace")}
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v

    out = {}
    for k, v in kv.items():
        if k.startswith("obs/"):
            # the reference's follower also publishes its metrics and
            # runtime snapshots for a cloud-wide /3/Metrics, which the
            # port does not merge yet: observability, not control plane
            continue
        try:
            out[k] = strip(json.loads(v))
        except ValueError:
            out[k] = v
    return out


def _scripted(pkg, monkeypatch, ckdir):
    """publish, replay and ack; a checkpoint op and its truncation; an
    injected replay error failing the cloud; a rejoin from the checkpoint;
    a forced election. -> the normalized KV after each step."""
    D_, O, C, S, F = pkg
    steps = []
    with D_.memory_kv() as kv:
        monkeypatch.setattr(D_, "process_count", lambda: 2)
        monkeypatch.setattr(D_, "is_coordinator", lambda: True)
        monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(ckdir))
        monkeypatch.setenv("H2O_TPU_OPLOG_CHECKPOINT_OPS", "0")
        monkeypatch.setenv("H2O_TPU_OP_ACK_TIMEOUT_S", "5")
        monkeypatch.setenv("H2O_TPU_AUTO_RECOVER", "0")
        F.set_incarnation(0)
        D_.reset_leadership()
        O._DEMOTED = False
        O.reset()
        S.reset()
        try:
            F.heartbeat()
            O.publish("noop", {})
            with pytest.raises(TimeoutError):
                O.follower_loop(idle_timeout_s=0.2)
            steps.append(_normalized(kv))
            seq = O.publish("checkpoint", {})
            with pytest.raises(TimeoutError):
                O.follower_loop(idle_timeout_s=0.2, start_seq=seq)
            C.write_checkpoint(seq)
            C.truncate_through(seq)
            steps.append(_normalized(kv))
            bad = O.publish("noop", {})
            with F.inject("oplog.replay", times=1):
                with pytest.raises(F.InjectedFault):
                    O.follower_loop(idle_timeout_s=0.2, start_seq=bad)
            assert S.evaluate() == S.FAILED
            steps.append(_normalized(kv))
            assert O.rejoin() == bad + 1
            steps.append(_normalized(kv))
            O.assume_coordination(force=True)
            steps.append(_normalized(kv))
        finally:
            F.set_incarnation(0)
            D_.reset_leadership()
            O._DEMOTED = False
            O.reset()
            S.reset()
    return steps


def test_kv_records_match_the_reference_control_plane(cl, monkeypatch,
                                                      tmp_path):
    """The same scripted sequence through both packages' memory KV leaves
    the same keys, each record equal once timestamps, op-id tokens and
    tracebacks are dropped."""
    from h2o3_tpu.core import failure as RF
    from h2o3_tpu.parallel import ckpt as RC
    from h2o3_tpu.parallel import distributed as RD
    from h2o3_tpu.parallel import oplog as RO
    from h2o3_tpu.parallel import supervisor as RS

    ref = _scripted((RD, RO, RC, RS, RF), monkeypatch, tmp_path)
    port = _scripted((D, oplog, ckpt, supervisor, failure), monkeypatch,
                     tmp_path)
    assert [sorted(s) for s in port] == [sorted(s) for s in ref]
    for i, (p, r) in enumerate(zip(port, ref)):
        for k in r:
            rec_p, rec_r = p[k], r[k]
            if k.startswith("oplog/ckpt/"):
                # each package's DKV holds its own objects
                rec_p, rec_r = (dict(x, skipped=None)
                                for x in (rec_p, rec_r))
            assert rec_p == rec_r, (i, k)
