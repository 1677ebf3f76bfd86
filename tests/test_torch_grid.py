"""Grid search and the search engine in the port (h2o3_tpu_torch/grid.py,
automl/search.py, on the CPU) against the JAX package's on the same
numpy fixtures.

Tolerances:
- exact: the walkers' combo sequences (Cartesian, and RandomDiscrete's
  shuffle from seed 42), and the combos each grid built, in order;
- C2's bars: each member's AUC abs 1e-6; the sorted metric table in the
  same order wherever neighbours differ by more than that;
- bitwise: a grid built with parallelism 3 against the sequential walk,
  both in the port (the same builders on the same frame).
The JAX side trains its GBMs through its Pallas histogram kernel in
interpret mode (H2O_TPU_PALLAS_HIST=1). Fixtures have 640 rows, a
multiple of the JAX mesh's 64-row padding."""

import threading
import time

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch.automl import search

from torch_port_support import both_frames, train_cols

AUC_ATOL = 1e-6

HYPER = {
    "cartesian": ({"max_depth": [2, 3, 5], "learn_rate": [0.05, 0.3],
                   "sample_rate": [0.8, 1.0]}, {"strategy": "Cartesian"}),
    "random": ({"alpha": [0.0, 0.5, 1.0],
                "lambda_": [0.0, 0.001, 0.01, 0.1]},
               {"strategy": "RandomDiscrete", "max_models": 5, "seed": 42}),
}


@pytest.mark.parametrize("kind", sorted(HYPER))
def test_walkers_match_reference(cl, kind):
    from h2o3_tpu.grid import H2OGridSearch as JGrid

    hp, crit = HYPER[kind]
    j = JGrid("gbm", hp, search_criteria=crit)._candidates()
    t = th.H2OGridSearch("gbm", hp, search_criteria=crit)._candidates()
    assert t == j


def _combos(g):
    return [sorted(m._grid_params.items()) for m in g.models]


def _assert_tables_match(jg, tg):
    jt, tt = jg.sorted_metric_table("auc"), tg.sorted_metric_table("auc")

    def combo(r):
        return str(sorted((k, v) for k, v in r.items()
                          if k not in ("model_id", "auc")))

    jv = {combo(r): r["auc"] for r in jt}
    tv = {combo(r): r["auc"] for r in tt}
    assert sorted(jv) == sorted(tv)
    for c in jv:
        assert tv[c] == pytest.approx(jv[c], abs=AUC_ATOL), c
    pos = {combo(r): i for i, r in enumerate(tt)}
    for a, b in zip(jt, jt[1:]):
        if abs(a["auc"] - b["auc"]) > AUC_ATOL:
            assert pos[combo(a)] < pos[combo(b)]
    assert [r["auc"] for r in tt] == sorted((r["auc"] for r in tt),
                                            reverse=True)


def test_gbm_cartesian_grid_matches_reference(cl):
    """A 2x2 Cartesian GBM grid, given as a builder class."""
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    hp = {"max_depth": [2, 4], "learn_rate": [0.05, 0.3]}
    jf, tf = both_frames(train_cols(n=640, seed=5))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("H2O_TPU_PALLAS_HIST", "1")
        from h2o3_tpu.grid import H2OGridSearch as JGrid

        jg = JGrid(JGBM, hp).train(y="y", training_frame=jf, ntrees=5,
                                   seed=1)
    tg = th.H2OGridSearch(th.GBM, hp).train(y="y", training_frame=tf,
                                            ntrees=5, seed=1)
    assert len(tg) == 4 and _combos(tg) == _combos(jg)
    _assert_tables_match(jg, tg)
    best = tg.best_model("auc")
    assert best is tg.get_grid("auc").models[0]
    assert tg.model_ids == [str(m.key) for m in tg.models]
    assert tg[0] is tg.models[0] and not tg.failed


def test_glm_random_grid_matches_reference(cl):
    """RandomDiscrete over alpha x lambda_, max_models 5, seed 42, given
    as an instance whose non-default parameters are the base."""
    from h2o3_tpu.grid import H2OGridSearch as JGrid
    from h2o3_tpu.models.glm import GLM as JGLM

    hp, crit = HYPER["random"]
    jf, tf = both_frames(train_cols(n=640, seed=6))
    jg = JGrid(JGLM(family="binomial"), hp, search_criteria=crit).train(
        y="y", training_frame=jf)
    tg = th.H2OGridSearch(th.GLM(family="binomial"), hp,
                          search_criteria=crit).train(y="y",
                                                      training_frame=tf)
    assert tg.base_params == {"family": "binomial"}
    assert len(tg) == 5 and _combos(tg) == _combos(jg)
    _assert_tables_match(jg, tg)


def _coefs(g):
    return {str(sorted(m._grid_params.items())):
            np.array(list(m.coef().values())) for m in g.models}


def test_parallel_grid_equals_the_sequential_walk():
    """parallelism=3 builds the sequential walk's models, bit for bit,
    and never two members' device work at once (ROADMAP C27): every
    member holds the device lane while it trains."""
    from h2o3_tpu_torch.models.glm import GLM

    _, tf = both_frames(train_cols(n=384, seed=2))
    hp = {"alpha": [0.0, 0.5, 1.0], "lambda_": [0.0, 0.01]}
    seq = th.H2OGridSearch("glm", hp).train(y="y", training_frame=tf,
                                            seed=1)
    inside = {"now": 0, "most": 0}
    lock = threading.Lock()
    real = GLM._fit

    def watched(self, train):
        with lock:
            inside["now"] += 1
            inside["most"] = max(inside["most"], inside["now"])
        try:
            time.sleep(0.02)
            return real(self, train)
        finally:
            with lock:
                inside["now"] -= 1

    search.reset_stats()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GLM, "_fit", watched)
        par = th.H2OGridSearch("glm", hp).train(y="y", training_frame=tf,
                                                seed=1, parallelism=3)
    st = search.stats()
    assert inside["most"] == 1
    assert st["overlap"] >= 2 and st["members_done"] == 6
    a, b = _coefs(seq), _coefs(par)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_parallel_grid_never_overshoots_max_models():
    _, tf = both_frames(train_cols(n=192, seed=4))
    g = th.H2OGridSearch("glm", {"alpha": [0.0, 0.25, 0.5, 1.0]},
                         search_criteria={"max_models": 1})
    g.train(y="y", training_frame=tf, seed=1, parallelism=4)
    assert len(g) == 1
    g = th.H2OGridSearch("glm", {"alpha": [0.0, 0.25, 0.5, 1.0]},
                         search_criteria={"max_models": 3})
    g.train(y="y", training_frame=tf, seed=1, parallelism=2)
    assert len(g) == 3


def test_a_failing_member_is_parked_and_named():
    """A configuration error parks its member on the first attempt; any
    other error retries it to MAX_ATTEMPTS, then parks it; the grid goes
    on and lists both in `failed`."""
    from h2o3_tpu_torch.models.glm import GLM

    class Crashy(GLM):
        calls = 0

        def _fit(self, train):
            if self.params["alpha"] == 1.0 \
                    and self.params["family"] == "binomial":
                Crashy.calls += 1
                raise RuntimeError("device went away")
            return super()._fit(train)

    _, tf = both_frames(train_cols(n=192, seed=2))
    search.reset_stats()
    g = th.H2OGridSearch(Crashy, {"alpha": [0.0, 1.0],
                                  "family": ["binomial", "nosuchfamily"]})
    g.train(y="y", training_frame=tf)
    assert len(g) == 1
    failed = {f["combo_key"]: f for f in g.failed}
    assert len(failed) == 3
    assert Crashy.calls == 1 * search.MAX_ATTEMPTS == 5
    runtime_err = [f for f in g.failed if f["params"] == {
        "alpha": 1.0, "family": "binomial"}]
    assert runtime_err and "RuntimeError" in runtime_err[0]["error"]
    members = g._search_engine.members.values()
    assert sorted(m["attempts"] for m in members) == [1, 1, 1, 5]
    assert g._search_engine.counts() == {"done": 1, "parked": 3}
    st = search.stats()
    assert (st["members_done"], st["members_parked"], st["attempts"]) == \
        (1, 3, 8)
    with pytest.raises(RuntimeError, match="no models"):
        th.H2OGridSearch("glm", {"family": ["nosuchfamily"]}).train(
            y="y", training_frame=tf)


def test_a_member_past_its_deadline_is_failed_from_outside(monkeypatch):
    """A member still building 0.2 s after it took the device lane is
    failed from outside and parked; the next member waits for the lane
    (its deadline runs from when it takes it) and is built."""
    from h2o3_tpu_torch.core import job as job_mod

    monkeypatch.setenv("H2O_TPU_SEARCH_MEMBER_DEADLINE_S", "0.2")
    jobs = []
    real_start = job_mod.Job.start

    def start(self, fn, background=True):
        jobs.append(self)
        return real_start(self, fn, background)

    monkeypatch.setattr(job_mod.Job, "start", start)
    eng = search.SearchEngine("deadline", "grid")
    members = [eng.member("slow", "glm", {}), eng.member("quick", "glm", {})]

    def build(m):
        if m["name"] == "slow":
            time.sleep(0.6)
        return m["name"]

    assert eng.run(members, build, concurrency=1)
    slow, quick = members
    assert slow["status"] == "parked" and slow["attempts"] == 1
    assert "deadline" in slow["error"]
    assert jobs[0].status == th.Job.FAILED and jobs[0].failed_externally
    assert quick["status"] == "done" and jobs[1].status == th.Job.DONE
    assert eng.counts() == {"parked": 1, "done": 1}
    assert eng.state()["order"] == ["slow", "quick"]


@pytest.mark.parametrize("raw,want", [(None, 1), ("auto", 1), ("3", 3),
                                      ("0", 1), ("lots", 1)])
def test_search_concurrency_knob(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("H2O_TPU_SEARCH_CONCURRENCY", raising=False)
    else:
        monkeypatch.setenv("H2O_TPU_SEARCH_CONCURRENCY", raw)
    assert search.search_concurrency() == want


def test_grid_recovery_waits_for_the_durable_search_state(tmp_path):
    """The durable search state has landed: recovery_dir keeps the
    snapshot and the model, and load(dir) reads them back (the kill and
    resume itself is in test_torch_search_resume.py)."""
    import os

    _, tf = both_frames(train_cols(n=128, seed=2))
    g = th.H2OGridSearch("glm", {"alpha": [0.0]}).train(
        y="y", training_frame=tf, recovery_dir=str(tmp_path))
    assert any(n.startswith("searchckpt_") for n in os.listdir(tmp_path))
    assert os.listdir(tmp_path / "models") == [f"{g.model_ids[0]}.bin"]
    assert th.H2OGridSearch.load(str(tmp_path)).model_ids == g.model_ids
