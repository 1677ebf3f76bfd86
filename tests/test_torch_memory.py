"""The port's memory plane against the JAX package: the budget planner
gives the reference's windows for the same budget, hint and residency;
chunk-streamed, injected-OOM and ladder-recovered scoring is bitwise
equal to one dispatch; an exhausted ladder raises MemoryPressureError
with its flight record and admission sheds; the cleaner evicts coldest
first and faults columns back in bitwise; spilled columns reload through
the sha256 gate."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch.core import cleaner, failure
from h2o3_tpu_torch.memory import MemoryPressureError, budget, stream
from h2o3_tpu_torch.persist import spill

from torch_port_support import assert_bitwise, frames_bitwise


@pytest.fixture(autouse=True)
def _clean_pressure(monkeypatch):
    from h2o3_tpu.memory import budget as jbudget

    monkeypatch.setenv("H2O_TPU_RETRY_BASE_MS", "1")
    th.init(device="cpu")
    budget.reset_pressure()
    jbudget.reset_pressure()
    yield
    budget.reset_pressure()
    jbudget.reset_pressure()


def _force_chunk(monkeypatch, family, chunk):
    orig = budget.plan

    def fake(fam, rows, row_bytes=None):
        if fam == family and rows > chunk:
            return budget.Plan("chunked", chunk, rows, 4.0, 1 << 20)
        return orig(fam, rows, row_bytes)

    monkeypatch.setattr(budget, "plan", fake)


# -- the planner, against the reference --------------------------------------

@pytest.mark.parametrize("mb,headroom,live,rows,hint", [
    ("1", "0", 0, 1_000_000, 64.0), ("1", "0", 0, 100, 64.0),
    ("1", "0.15", 300_000, 50_000, 92.0), ("2", "0.15", 0, 10, 4e6),
    ("0.25", "0.5", 1 << 16, 4096, 12.0), ("64", "0.15", 1 << 20,
                                            16384, 300.0)])
def test_plan_gives_the_reference_windows(monkeypatch, mb, headroom, live,
                                          rows, hint):
    from h2o3_tpu.memory import budget as jbudget

    monkeypatch.setenv("H2O_TPU_MEM_BUDGET_MB", mb)
    monkeypatch.setenv("H2O_TPU_MEM_HEADROOM", headroom)
    monkeypatch.setattr(budget, "live_bytes", lambda: live)
    monkeypatch.setattr(jbudget, "live_bytes", lambda: live)
    fam = f"plan_case_{mb}_{rows}"
    p, j = budget.plan(fam, rows, hint), jbudget.plan(fam, rows, hint)
    assert (p.mode, p.chunk_rows, p.rows, p.row_bytes, p.free_bytes) == \
        (j.mode, j.chunk_rows, j.rows, j.row_bytes, j.free_bytes)
    assert budget.free_bytes() == jbudget.free_bytes()


def test_unbudgeted_cpu_plans_full(monkeypatch):
    monkeypatch.delenv("H2O_TPU_MEM_BUDGET_MB", raising=False)
    assert budget.budget_bytes() is None
    p = budget.plan("scoring", 10_000_000)
    assert p.mode == "full" and p.chunk_rows == 10_000_000


def test_headroom_clamped_and_measured_row_bytes(monkeypatch):
    monkeypatch.setenv("H2O_TPU_MEM_HEADROOM", "2.5")
    assert budget.headroom() == 0.9
    monkeypatch.setenv("H2O_TPU_MEM_HEADROOM", "-1")
    assert budget.headroom() == 0.0
    budget.note_compiled("unit_fam_c", 100, 1000)
    assert budget.row_bytes_estimate("unit_fam_c") == 10.0
    budget.note_compiled("unit_fam_c", 1000, 1000)     # a max, never less
    budget.note_compiled("unit_fam_c", 100, None)      # the CPU: no-op
    assert budget.row_bytes_estimate("unit_fam_c") == 10.0
    assert budget.row_bytes_estimate("unit_fam_c", 50.0) == 50.0
    assert budget.row_bytes_estimate("never_measured") == 4.0


def test_live_bytes_is_the_cleaners_residency():
    fr = th.Frame(key="mem_live_fr")
    fr.add("a", th.Column.from_numpy(np.arange(1000.0)))
    fr.add("c", th.Column.from_numpy(np.array(["x", "y"] * 500),
                                     ctype="enum"))
    fr.install()
    try:
        assert budget.live_bytes() == cleaner.device_bytes_in_use()
        assert budget.live_bytes() >= 1000 * 4 + 1000
        snap = budget.snapshot()
        assert set(snap["stream"]) == set(stream.counters())
    finally:
        fr.delete()


# -- run_windows ----------------------------------------------------------

def test_chunked_windows_in_row_order(monkeypatch):
    _force_chunk(monkeypatch, "unit_fam_d", 7)
    c0 = stream.counters()
    fetched = []
    out = stream.run_windows(
        "unit_fam_d", 30, lambda pos, m: np.arange(pos, pos + m),
        max_window=30, fetch=lambda o, m: fetched.append(len(o)) or o)
    c1 = stream.counters()
    assert np.array_equal(np.concatenate(out), np.arange(30))
    assert fetched == [7, 7, 7, 7, 2]
    assert c1["chunked_runs"] - c0["chunked_runs"] == 1
    assert c1["windows"] - c0["windows"] == 5


@pytest.mark.parametrize("where", ["dispatch", "fetch"])
def test_oom_walks_the_ladder_and_recovers(monkeypatch, where):
    """An injected mem.exhausted fault (at dispatch) or a real
    torch.cuda.OutOfMemoryError class (at the double-buffered fetch):
    the ladder sweeps, halves and completes with no row lost."""
    monkeypatch.delenv("H2O_TPU_MEM_BUDGET_MB", raising=False)
    _force_chunk(monkeypatch, "unit_fam_e", 8)
    boom = {"left": 1}

    def fetch(o, m):
        if where == "fetch" and boom["left"]:
            boom["left"] -= 1
            raise torch.cuda.OutOfMemoryError("synthetic out of memory")
        return o

    c0 = stream.counters()
    with failure.inject("mem.exhausted", times=2 if where == "dispatch"
                        else 0):
        out = stream.run_windows("unit_fam_e", 64,
                                 lambda pos, m: np.arange(pos, pos + m),
                                 max_window=64, fetch=fetch)
    c1 = stream.counters()
    assert np.array_equal(np.concatenate(out), np.arange(64))
    assert c1["ladder_halvings"] > c0["ladder_halvings"]
    assert c1["ladder_recoveries"] - c0["ladder_recoveries"] == 1
    assert not budget.pressure_active()


def test_exhausted_ladder_raises_pressure_and_sheds():
    from h2o3_tpu_torch import admission

    c0 = stream.counters()
    with failure.inject("mem.exhausted", times=100):
        with pytest.raises(MemoryPressureError) as ei:
            stream.run_windows("unit_fam_f", 64,
                               lambda pos, m: np.arange(pos, pos + m),
                               max_window=64)
    assert ei.value.status == 503 and ei.value.family == "unit_fam_f"
    assert len(ei.value.attempts) == 3           # H2O_TPU_RETRY_MAX default
    assert stream.counters()["pressure_failures"] == \
        c0["pressure_failures"] + 1
    rec = stream.flight_records()[-1]
    assert rec["family"] == "unit_fam_f" and rec["chunk_attempts"]
    assert budget.pressure_active()
    with pytest.raises(admission.AdmissionRejected) as rej:
        with admission.CONTROLLER.slot("any_model"):
            pass
    assert rej.value.status == 503 and rej.value.retry_after_s >= 1.0


def test_other_errors_propagate_and_is_oom():
    with pytest.raises(ValueError):
        stream.run_windows("unit_fam_g", 10,
                           lambda pos, m: (_ for _ in ()).throw(
                               ValueError("not memory")), max_window=10)
    assert stream.is_oom(torch.cuda.OutOfMemoryError("x"))
    assert stream.is_oom(failure.InjectedFault("injected fault: "
                                               "mem.exhausted"))
    assert not stream.is_oom(RuntimeError("RESOURCE_EXHAUSTED"))
    assert not stream.is_oom(failure.InjectedFault("injected fault: x"))


def test_host_stager_on_the_cpu_gives_the_rows():
    X = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    st = stream.HostStager(X, "cpu", 16)
    assert torch.equal(st.stage(10, 16), torch.from_numpy(X[10:26]))


# -- scoring under the planner -------------------------------------------

@pytest.fixture(scope="module")
def gbm():
    """A JAX-trained binomial GBM carried into the port."""
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    from h2o3_tpu_torch import convert
    from torch_port_support import both_frames, carry_forest, flagship_cols

    jf, tf = both_frames(flagship_cols(640, seed=5))
    jm = JGBM(ntrees=6, max_depth=4, seed=3).train(y="y", training_frame=jf)
    return convert.gbm_model_from_numpy(carry_forest(jm)), tf


def test_budgeted_scoring_streams_bitwise(monkeypatch, gbm):
    from h2o3_tpu_torch import scoring

    m, fr = gbm
    sess = scoring.ScoringSession(m)
    ref = sess._margin_x(sess._features(m.adapt_test(fr)))
    monkeypatch.setenv("H2O_TPU_MEM_BUDGET_MB", "0.01")
    monkeypatch.setenv("H2O_TPU_SCORE_BUCKETS", "64,256")
    sess2 = scoring.ScoringSession(m)
    disp = []
    got = sess2._margin_x(sess2._features(m.adapt_test(fr)).numpy(),
                          dispatched=disp)
    assert len(disp) > 1 and set(disp) <= {64, 256}
    assert_bitwise(got.numpy(), ref.numpy())


def test_injected_oom_scoring_recovers_bitwise(monkeypatch, gbm):
    from h2o3_tpu_torch import scoring

    m, fr = gbm
    monkeypatch.setenv("H2O_TPU_SCORE_BUCKETS", "64,256,1024")
    sess = scoring.ScoringSession(m)
    X = sess._features(m.adapt_test(fr))
    ref = m._margin(m.adapt_test(fr))
    c0 = stream.counters()
    with failure.inject("mem.exhausted", times=2):
        got = sess._margin_x(X)
    c1 = stream.counters()
    assert c1["ladder_halvings"] - c0["ladder_halvings"] == 2
    assert c1["ladder_recoveries"] - c0["ladder_recoveries"] == 1
    assert_bitwise(got.numpy(), ref.numpy())


# -- cleaner and spill ----------------------------------------------------

def test_evict_then_fault_in_is_bitwise(gbm):
    from h2o3_tpu_torch import scoring

    m, fr0 = gbm
    fr = th.Frame(key="mem_evict_fr")
    for nm in fr0.names:
        fr.add(nm, fr0.col(nm))
    fr.install()
    try:
        before = scoring.session_for(m).predict(fr)
        freed = cleaner.sweep(1 << 40)
        assert freed > 0 and cleaner.evicted_count() >= len(fr.names)
        assert all(fr._cols[nm].is_evicted for nm in fr.names)
        after = scoring.session_for(m).predict(fr)
        frames_bitwise(before, after)
        assert not any(fr._cols[nm].is_evicted for nm in m._output.names)
    finally:
        fr.delete()


def test_sweep_goes_coldest_first():
    fr = th.Frame(key="mem_lru_fr")
    for nm in ("a", "b", "c"):
        fr.add(nm, th.Column.from_numpy(np.arange(256.0)))
    fr.install()
    try:
        for nm in ("c", "a", "b"):          # b hottest, c coldest
            _ = fr.col(nm).data
        others = cleaner.device_bytes_in_use() - 3 * 1024
        freed = cleaner.sweep(others + 1)   # everything else, then one
        assert freed >= others + 1024
        assert fr._cols["c"].is_evicted
        assert not fr._cols["a"].is_evicted and not fr._cols["b"].is_evicted
    finally:
        fr.delete()


def test_spill_round_trip_and_checksum_gate():
    fr = th.Frame(key="mem_spill_fr")
    vals = np.random.default_rng(2).standard_normal(300)
    fr.add("x", th.Column.from_numpy(vals))
    fr.add("y", th.Column.from_numpy(vals * 2))
    fr.install()
    try:
        want = fr.col("x").data.clone()
        col = fr._cols["x"]
        assert spill.spill_column(col, "x") == 300 * 4
        assert col.is_evicted and callable(col._evicted)
        assert_bitwise(fr.col("x").data.numpy(), want.numpy())
        # tamper with a second column's spill file: its reload refuses
        coly = fr._cols["y"]
        spill.spill_column(coly, "y")
        path = [p for p in __import__("os").listdir(spill.spill_dir())
                if p.startswith("y_")][0]
        full = __import__("os").path.join(spill.spill_dir(), path)
        arr = np.load(full)
        arr[0] += 1.0
        np.save(full, arr)
        with pytest.raises(spill.SpillCorrupt, match="checksum"):
            _ = fr.col("y").data
    finally:
        fr.delete()


def test_missing_spill_file_raises_after_bounded_retries(tmp_path):
    c0 = stream.counters()
    load = spill.loader_for(str(tmp_path / "gone.npy"), "0" * 64, "gone")
    with pytest.raises(spill.SpillCorrupt, match="missing"):
        load()
    assert stream.counters()["spill_retries"] - c0["spill_retries"] == 2
