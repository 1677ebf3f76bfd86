"""Durable search state in the port (parallel/ckpt.py's search store,
automl/search.SearchEngine's snapshot, grid recovery_dir) on the CPU,
against the JAX package's grid kill-and-resume (tests/test_grid.py:76)
on the same numpy fixture.

Tolerances: the set of combos each grid built, exact; each member's AUC
abs 1e-6 to the reference's (ROADMAP C2's bar, as
test_torch_grid.py); a resumed port grid's members bitwise with an
uninterrupted port grid's, by combo. The JAX side trains its GBMs
through its Pallas kernel in interpret mode (H2O_TPU_PALLAS_HIST=1).
Fixtures have 640 rows, a multiple of the JAX mesh's 64-row padding."""

import os

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch.automl import search
from h2o3_tpu_torch.automl.search import SearchEngine
from h2o3_tpu_torch.parallel import ckpt

from torch_port_support import assert_bitwise, both_frames, train_cols

AUC_ATOL = 1e-6
HYPER = {"max_depth": [2, 3], "learn_rate": [0.1, 0.3]}


@pytest.fixture()
def ckdir(monkeypatch, tmp_path):
    d = tmp_path / "ckpt"
    monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(d))
    return d


def _state(done):
    return {"kind": "grid", "dest": "g",
            "members": {"a": {"name": "a", "status": "done",
                              "attempts": 1},
                        "b": {"name": "b",
                              "status": "done" if done else "pending",
                              "attempts": int(done)}},
            "order": ["a", "b"]}


def test_search_store_round_trip(ckdir):
    path = ckpt.save_search_state("S1", _state(False))
    assert os.path.exists(path) and os.path.exists(path + ".json")
    rec = ckpt.load_search_state("S1")
    assert rec["search"] == "S1" and rec["state"] == _state(False)
    recs = ckpt.search_state_records()
    assert [r["search"] for r in recs] == ["S1"]
    assert recs[0]["members"] == {"done": 1, "pending": 1}
    ckpt.save_search_state("S1", _state(True))
    assert os.path.exists(path + ".prev")
    assert ckpt.load_search_state("S1")["state"] == _state(True)
    ckpt.delete_search_state("S1")
    assert ckpt.load_search_state("S1") is None
    assert ckpt.search_state_records() == []


def test_torn_current_snapshot_gives_way_to_previous(ckdir):
    path = ckpt.save_search_state("S2", _state(False))
    ckpt.save_search_state("S2", _state(True))
    with open(path, "r+b") as f:
        f.truncate(17)
    assert ckpt.load_search_state("S2")["state"] == _state(False)
    with open(path + ".prev", "wb") as f:
        f.write(b"\x80\x04garbage")
    assert ckpt.load_search_state("S2") is None


def test_caller_directory_keeps_its_files(tmp_path):
    sdir = str(tmp_path / "rec")
    path = ckpt.save_search_state("S3", _state(True), sdir=sdir)
    assert path.startswith(sdir)
    ckpt.delete_search_state("S3", sdir=sdir, keep_files=True)
    assert ckpt.load_search_state("S3", sdir=sdir) is not None
    ckpt.delete_search_state("S3", sdir=sdir)
    assert ckpt.load_search_state("S3", sdir=sdir) is None


def test_restored_running_member_spends_an_attempt():
    state = {"members": {"a": {"name": "a", "status": "running",
                               "attempts": 2},
                         "b": {"name": "b", "status": "done",
                               "attempts": 1}},
             "order": ["b", "a"], "saves": 7}
    eng = SearchEngine("S4", "grid", state=state)
    assert eng.resumed and eng.order == ["b", "a"] and eng.saves == 7
    assert eng.members["a"]["status"] == "failed"
    assert eng.members["a"]["attempts"] == 3
    assert eng.members["b"]["status"] == "done"
    assert state["members"]["a"]["status"] == "running"   # not mutated


def test_persistence_follows_directory_job_and_knob(monkeypatch):
    from h2o3_tpu_torch.core.job import Job

    assert not SearchEngine("k", "grid").persist
    assert SearchEngine("k", "grid", sdir="/nowhere").persist
    job = Job(description="search")
    assert SearchEngine("k", "automl", job=job).persist
    monkeypatch.setenv("H2O_TPU_SEARCH_CKPT", "0")
    assert not SearchEngine("k", "automl", job=job).persist
    assert search.search_ckpt_enabled() is False


def test_failing_state_save_never_fails_the_search(tmp_path, monkeypatch):
    search.reset_stats()
    monkeypatch.setattr(ckpt, "save_search_state",
                        lambda *a, **k: 1 / 0)
    eng = SearchEngine("S5", "grid", sdir=str(tmp_path))
    mems = [eng.member(n, "gbm", {}) for n in ("a", "b")]
    assert eng.run(mems, lambda m: object(), concurrency=1)
    assert [m["status"] for m in mems] == ["done", "done"]
    st = search.stats()
    assert st["state_save_errors"] == 3 and st["state_saves"] == 0


def test_engine_saves_after_every_member(tmp_path):
    search.reset_stats()
    eng = SearchEngine("S6", "grid", sdir=str(tmp_path))
    mems = [eng.member(n, "gbm", {"n": n}) for n in ("a", "b", "c")]
    seen = []

    def build(m):
        rec = ckpt.load_search_state("S6", sdir=str(tmp_path))
        seen.append(None if rec is None else
                    sorted(k for k, v in rec["state"]["members"].items()
                           if v["status"] == "done"))
        return object()

    eng.run(mems, build, concurrency=1)
    assert seen == [None, ["a"], ["a", "b"]]
    assert search.stats()["state_saves"] == 4
    eng.finish()                      # a caller's directory keeps its files
    assert ckpt.load_search_state("S6", sdir=str(tmp_path)) is not None


def _count_trains(monkeypatch, cls):
    calls = []
    orig = cls.train

    def counted(self, *a, **k):
        calls.append(dict(self.params))
        return orig(self, *a, **k)

    monkeypatch.setattr(cls, "train", counted)
    return calls


def _aucs(g):
    return {str(sorted(m._grid_params.items())):
            float(m._output.training_metrics.auc) for m in g.models}


def test_grid_kill_and_resume_matches_reference(cl, monkeypatch, tmp_path):
    """The reference's test_grid_kill_and_resume in both packages: two
    members, the process dies (grid and models gone from the DKV),
    `load(recovery_dir)`, the cap lifted, the walk finished."""
    from h2o3_tpu.core.dkv import DKV as JDKV
    from h2o3_tpu.grid import H2OGridSearch as JGrid
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    jf, tf = both_frames(train_cols(n=640, seed=3))
    kw = dict(y="y", ntrees=3, seed=1)

    def kill_and_resume(Grid, GBM, DKV, fr, rec, gid):
        g = Grid(GBM, HYPER, grid_id=gid,
                 search_criteria={"max_models": 2})
        g.train(training_frame=fr, recovery_dir=rec, **kw)
        assert len(g) == 2
        first = {str(m.key) for m in g.models}
        for m in g.models:
            DKV.remove(str(m.key))
        DKV.remove(gid)
        g2 = Grid.load(rec)
        assert {str(m.key) for m in g2.models} == first
        g2.search_criteria["max_models"] = 0
        return g2, first

    j2, _ = kill_and_resume(JGrid, JGBM, JDKV, jf, str(tmp_path / "j"), "jg")
    j2.train(training_frame=jf, recovery_dir=str(tmp_path / "j"), **kw)
    t2, first = kill_and_resume(th.H2OGridSearch, th.GBM, th.DKV, tf,
                                str(tmp_path / "t"), "tg")
    calls = _count_trains(monkeypatch, th.GBM)
    t2.train(training_frame=tf, recovery_dir=str(tmp_path / "t"), **kw)
    assert len(t2) == len(j2) == 4
    assert len(calls) == 2                       # no done member again
    assert {str(m.key) for m in t2.models} >= first
    ja, ta = _aucs(j2), _aucs(t2)
    assert sorted(ja) == sorted(ta) and len(ta) == 4
    for c in ja:
        assert ta[c] == pytest.approx(ja[c], abs=AUC_ATOL), c
    # the directory keeps the snapshot and every model
    assert len(os.listdir(tmp_path / "t" / "models")) == 4
    best = t2.best_model("auc")
    assert best.predict(tf).nrows == tf.nrows
    # bitwise with an uninterrupted port grid, by combo
    full = th.H2OGridSearch(th.GBM, HYPER, grid_id="tg_full").train(
        training_frame=tf, **kw)
    want = {str(sorted(m._grid_params.items())): m for m in full.models}
    for m in t2.models:
        w = want[str(sorted(m._grid_params.items()))]
        assert_bitwise(m.predict(tf).col("Y").data.numpy(),
                       w.predict(tf).col("Y").data.numpy())


def test_load_takes_a_directory_or_a_file(tmp_path):
    tf = both_frames(train_cols(n=256, seed=4))[1]
    rec = str(tmp_path / "rec")
    g = th.H2OGridSearch(th.GBM(ntrees=2, seed=1), {"max_depth": [2, 3]},
                         grid_id="lg")
    g.train(y="y", training_frame=tf, recovery_dir=rec)
    path = g.save(str(tmp_path / "saved"))
    keys = sorted(g.model_ids)
    for k in keys:
        th.DKV.remove(k)
    th.DKV.remove("lg")
    from_dir = th.H2OGridSearch.load(rec)
    assert sorted(from_dir.model_ids) == keys
    assert from_dir.recovery_dir == rec
    from_file = th.H2OGridSearch.load(path)
    assert sorted(from_file.model_ids) == keys
    assert from_file.recovery_dir == rec          # saved with the grid
    assert not hasattr(from_file, "_resume_search_state")
    assert all(th.DKV.get(k) is not None for k in keys)
    with pytest.raises(FileNotFoundError):
        th.H2OGridSearch.load(str(tmp_path / "empty" / "x"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no grid search snapshot"):
        th.H2OGridSearch.load(str(tmp_path / "empty"))


def test_concurrent_member_saves_keep_a_loadable_snapshot(tmp_path):
    """Members built two at a time each save the snapshot from their own
    thread: no save fails, the current snapshot loads and holds every
    member done, and no temp file is left behind."""
    search.reset_stats()
    tf = both_frames(train_cols(n=256, seed=4))[1]
    rec = tmp_path / "rec"
    g = th.H2OGridSearch(th.GBM(ntrees=2, seed=1), HYPER, grid_id="cg")
    g.train(y="y", training_frame=tf, recovery_dir=str(rec), parallelism=2)
    assert len(g) == 4
    st = search.stats()
    assert st["state_save_errors"] == 0 and st["state_saves"] == 5
    sk = g._search_engine.key
    data = ckpt.load_search_state(sk, sdir=str(rec))
    assert [m["status"] for m in data["state"]["members"].values()] \
        == ["done"] * 4
    assert not [n for n in os.listdir(rec) if n.endswith(".part")]


def test_concurrent_saves_of_one_search(tmp_path):
    """Four threads saving one search's snapshot at once: every save
    lands, both generations load, no temp file is left behind."""
    import threading

    errors = []

    def saver(i):
        for j in range(40):
            try:
                ckpt.save_search_state("S7", _state(bool((i + j) % 2)),
                                       sdir=str(tmp_path))
            except Exception as e:   # noqa: BLE001 — collected below
                errors.append(e)

    threads = [threading.Thread(target=saver, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    path = ckpt._search_path("S7", str(tmp_path))
    both = (_state(True), _state(False))
    assert ckpt.load_search_state("S7", sdir=str(tmp_path))["state"] in both
    os.unlink(path)                 # the previous generation stands in
    assert ckpt.load_search_state("S7", sdir=str(tmp_path))["state"] in both
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".part")]


def test_load_retrains_a_done_member_whose_model_is_lost(monkeypatch,
                                                         tmp_path):
    tf = both_frames(train_cols(n=256, seed=4))[1]
    rec = tmp_path / "rec"
    g = th.H2OGridSearch(th.GBM(ntrees=2, seed=1), {"max_depth": [2, 3]},
                         grid_id="lost")
    g.train(y="y", training_frame=tf, recovery_dir=str(rec))
    lost = str(g.models[0].key)
    for k in g.model_ids:
        th.DKV.remove(k)
    th.DKV.remove("lost")
    os.unlink(rec / "models" / f"{lost}.bin")
    g2 = th.H2OGridSearch.load(str(rec))
    assert len(g2) == 1 and lost not in g2.model_ids
    calls = _count_trains(monkeypatch, th.GBM)
    g2.train(y="y", training_frame=tf, recovery_dir=str(rec))
    assert len(calls) == 1 and len(g2) == 2
    assert calls[0]["max_depth"] == g.models[0]._grid_params["max_depth"]


def test_load_of_a_directory_without_readable_state(tmp_path):
    tf = both_frames(train_cols(n=256, seed=4))[1]
    rec = tmp_path / "rec"
    g = th.H2OGridSearch(th.GBM(ntrees=2, seed=1), {"max_depth": [2]})
    g.train(y="y", training_frame=tf, recovery_dir=str(rec))
    for p in rec.glob("searchckpt_*.pkl*"):
        if not p.name.endswith(".json"):
            p.write_bytes(b"torn")
    with pytest.raises(RuntimeError, match="unreadable"):
        th.H2OGridSearch.load(str(rec))


def test_rest_grid_with_recovery_dir(tmp_path):
    from torch_rest_support import Rest, write_api_csv

    th.init(device="cpu")
    srv = th.start_server(port=0)
    try:
        T = Rest(srv.port)
        _setup, key = T.import_parse(write_api_csv(tmp_path / "a.csv"))
        rec = str(tmp_path / "rec")
        out = T.json("POST", "/99/Grid/gbm", data={
            "training_frame": key, "response_column": "y", "ntrees": 3,
            "seed": 1, "grid_id": "rest_rec",
            "hyper_parameters": {"max_depth": [2, 3]},
            "recovery_dir": rec})
        job = T.done_job(out)
        assert job["dest"]["name"] == "rest_rec"
        grid = th.DKV.get("rest_rec")
        assert len(grid.models) == 2 and grid.recovery_dir == rec
        names = os.listdir(rec)
        assert any(n.startswith("searchckpt_") for n in names)
        assert len(os.listdir(os.path.join(rec, "models"))) == 2
        st = T.json("GET", "/3/CloudStatus")
        assert st["search"]["stats"]["state_saves"] >= 3
        loaded = th.H2OGridSearch.load(rec)
        assert sorted(loaded.model_ids) == sorted(grid.model_ids)
    finally:
        srv.stop()
