"""The port's admission controller against the JAX package's
(h2o3_tpu/admission.py): fed the same latency sequence and the same
arrivals, both derive equal inflight limits, shed the same requests with
the same status and report equal Retry-After values; memory pressure
sheds with 503 in both; search_concurrency()'s `auto` follows the
admission snapshot as the reference's does."""

import contextlib

import numpy as np
import pytest

from h2o3_tpu_torch import admission
from h2o3_tpu_torch.automl import search
from h2o3_tpu_torch.memory import budget


@pytest.fixture()
def both(monkeypatch):
    from h2o3_tpu import admission as jadmission

    for k in ("H2O_TPU_SCORE_MAX_INFLIGHT", "H2O_TPU_SCORE_SLO_MS",
              "H2O_TPU_SCORE_SLO_MAX_INFLIGHT", "H2O_TPU_SCORE_QUEUE_CAP",
              "H2O_TPU_SEARCH_CONCURRENCY"):
        monkeypatch.delenv(k, raising=False)
    return admission.AdmissionController(), jadmission.AdmissionController()


def _lat_seq(seed, n, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, n).tolist()


@pytest.mark.parametrize("slo,static,lo,hi", [
    ("50", "0", 1.0, 30.0),        # under target: no pressure, no growth
    ("50", "0", 40.0, 200.0),      # over target: multiplicative decrease
    ("50", "6", 60.0, 90.0),       # static knob seeds and caps
    ("200", "0", 1.0, 5.0)])
def test_slo_limits_follow_the_reference(monkeypatch, both, slo, static, lo,
                                         hi):
    port, ref = both
    monkeypatch.setenv("H2O_TPU_SCORE_SLO_MS", slo)
    monkeypatch.setenv("H2O_TPU_SCORE_MAX_INFLIGHT", static)
    for i, ms in enumerate(_lat_seq(int(float(slo)) + int(lo), 80, lo, hi)):
        port.note_latency("m", ms)
        ref.note_latency("m", ms)
        assert port.derived_limits() == ref.derived_limits(), i
    assert port.snapshot()["models"] == ref.snapshot()["models"]


def test_additive_increase_under_demand_follows_the_reference(monkeypatch,
                                                              both):
    """p99 comfortably under target while requests are in flight at the
    limit: both grow the limit by one, once (then the demand is met)."""
    port, ref = both
    monkeypatch.setenv("H2O_TPU_SCORE_SLO_MS", "100")
    monkeypatch.setenv("H2O_TPU_SCORE_SLO_MAX_INFLIGHT", "12")
    with contextlib.ExitStack() as st:
        for ctrl in (port, ref):
            for _ in range(8):                  # the seeded limit of 8
                st.enter_context(ctrl.slot("m"))
        for ms in _lat_seq(3, 64, 1.0, 10.0):
            port.note_latency("m", ms)
            ref.note_latency("m", ms)
        assert port.derived_limits() == ref.derived_limits() == {"m": 9}


def _reject(ctrl):
    try:
        with ctrl.slot("m"):
            return None
    except Exception as e:   # noqa: BLE001 — compared below
        return (type(e).__name__, e.status, round(e.retry_after_s, 9))


def test_overflow_sheds_the_same_requests_with_the_same_retry_after(
        monkeypatch, both):
    port, ref = both
    monkeypatch.setenv("H2O_TPU_SCORE_MAX_INFLIGHT", "2")
    monkeypatch.setenv("H2O_TPU_SCORE_QUEUE_CAP", "0")
    for ms in (12.0, 30.0, 18.0):
        port.note_latency("m", ms)
        ref.note_latency("m", ms)
    with contextlib.ExitStack() as st:
        got = []
        for ctrl in (port, ref):
            for _ in range(2):
                st.enter_context(ctrl.slot("m"))
            got.append([_reject(ctrl) for _ in range(3)])
        assert got[0] == got[1]
        assert got[0][0][:2] == ("AdmissionRejected", 429)
    for k in ("admitted", "queued", "rejected", "timed_out", "shed_slo",
              "shed_mem", "max_inflight", "queue_cap"):
        assert port.snapshot()[k] == ref.snapshot()[k], k


def test_slo_queue_time_gate_sheds_like_the_reference(monkeypatch, both):
    port, ref = both
    monkeypatch.setenv("H2O_TPU_SCORE_SLO_MS", "20")
    monkeypatch.setenv("H2O_TPU_SCORE_MAX_INFLIGHT", "1")
    for ms in (50.0, 70.0):
        port.note_latency("m", ms)
        ref.note_latency("m", ms)
    with contextlib.ExitStack() as st:
        outs = []
        for ctrl in (port, ref):
            st.enter_context(ctrl.slot("m"))
            outs.append(_reject(ctrl))
        assert outs[0] == outs[1] and outs[0][1] == 429
    assert port.shed_slo == ref.shed_slo == 1


def test_memory_pressure_sheds_503_in_both(both):
    from h2o3_tpu.memory import budget as jbudget

    port, ref = both
    budget.note_pressure()
    jbudget.note_pressure()
    try:
        p, r = _reject(port), _reject(ref)
        assert p[:2] == r[:2] == ("AdmissionRejected", 503)
        assert abs(p[2] - r[2]) < 1.0
        assert port.shed_mem == ref.shed_mem == 1
    finally:
        budget.reset_pressure()
        jbudget.reset_pressure()


@pytest.mark.parametrize("cap,held", [(0, 0), (3, 0), (3, 1), (8, 2),
                                      (2, 5)])
def test_search_concurrency_follows_the_admission_snapshot(monkeypatch, cap,
                                                           held):
    from h2o3_tpu import admission as jadmission
    from h2o3_tpu.automl import search as jsearch

    monkeypatch.delenv("H2O_TPU_SEARCH_CONCURRENCY", raising=False)
    monkeypatch.setenv("H2O_TPU_SCORE_MAX_INFLIGHT", str(cap))
    monkeypatch.setenv("H2O_TPU_SCORE_QUEUE_CAP", "0")
    admission.CONTROLLER.reset()
    jadmission.CONTROLLER.reset()
    with contextlib.ExitStack() as st:
        for ctrl in (admission.CONTROLLER, jadmission.CONTROLLER):
            for _ in range(min(held, cap) if cap else held):
                st.enter_context(ctrl.slot(f"held_{cap}_{held}"))
        assert search.search_concurrency() == jsearch.search_concurrency()
    admission.CONTROLLER.reset()
    jadmission.CONTROLLER.reset()
