"""Durable job progress in the port (parallel/ckpt.py, the fit loops'
`_tick_job_progress` / `_take_resume_state`) on the CPU, against an
uninterrupted run of the port and against the JAX package's own resume
(tests/test_job_resume.py) on the same numpy fixtures.

A train is interrupted by an exception raised right after the durable
save at iteration `at` (the process dying); a fresh builder given the
saved state trains on.

Tolerances:
- resumed against uninterrupted, both in the port: bitwise for the tree
  builders (forest, predictions, OOB metrics); rtol 1e-6 / atol 1e-7
  for GLM, KMeans and DeepLearning (the reference's own bar,
  tests/test_job_resume.py:96), each held against a run with the same
  H2O_TPU_JOB_CKPT_ITERS, since the knob shapes the GLM and KMeans
  loops;
- the port's resumed model against the reference's resumed model: each
  builder's existing parity bar (ROADMAP C2: tree predictions atol
  1e-5; GLM beta rtol/atol 1e-5; KMeans centers atol 1e-5;
  DeepLearning predictions atol 1e-4).
The JAX side trains its trees through its Pallas kernel in interpret
mode (H2O_TPU_PALLAS_HIST=1). Fixtures have 640 rows, a multiple of the
JAX mesh's 64-row padding."""

import io
import pickle

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch.core.job import Job
from h2o3_tpu_torch.models.model_builder import ModelBuilder
from h2o3_tpu_torch.parallel import ckpt

from torch_port_support import assert_bitwise, both_frames, dl_cols, train_cols


class _Interrupted(Exception):
    """Stands in for the process dying mid-train."""


@pytest.fixture()
def jobckpt(monkeypatch, tmp_path):
    """Durable progress every 2 iterations into a temp directory (both
    packages read the same knobs)."""
    monkeypatch.setenv("H2O_TPU_JOB_CKPT_ITERS", "2")
    monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    return tmp_path


class _Pkg:
    """One package's builder base, Job class and ckpt module."""

    def __init__(self, ref: bool):
        if ref:
            from h2o3_tpu.core.job import Job as J
            from h2o3_tpu.models.model_builder import ModelBuilder as MB
            from h2o3_tpu.parallel import ckpt as C
        else:
            J, MB, C = Job, ModelBuilder, ckpt
        self.Job, self.MB, self.ckpt = J, MB, C


def _attach(pkg, builder, fr):
    job = pkg.Job(description=f"{builder.algo_name} train")
    job.resume_spec = {"algo": builder.algo_name, "params": {},
                       "training_frame": str(fr.key), "y": "y"}
    builder._progress_job = job
    return job


def _train(b, fr, y):
    return b.train(y=y, training_frame=fr)


def _interrupt_resume(pkg, cls, params, fr, at, y="y"):
    """Train with progress until the save at `at`, die, resume a fresh
    builder from the saved state. -> the resumed model."""
    b1 = cls(**params)
    job = _attach(pkg, b1, fr)
    orig = pkg.MB._tick_job_progress

    def tick_boom(self, done, fn):
        orig(self, done, fn)
        if done >= at:
            raise _Interrupted()

    pkg.MB._tick_job_progress = tick_boom
    try:
        with pytest.raises(_Interrupted):
            _train(b1, fr, y)
    finally:
        pkg.MB._tick_job_progress = orig
    assert b1.job.status == pkg.Job.FAILED
    data = pkg.ckpt.load_job_progress(str(job.key))
    assert data is not None and data["iteration"] == at
    assert data["spec"]["algo"] == cls.algo_name
    b2 = cls(**params)
    b2._resume_state = data["state"]
    return _train(b2, fr, y)


def _host_preds(m, fr):
    p = m.predict(fr)
    return {c: p.col(c).to_numpy() for c in p.names
            if p.col(c).domain is None}


def _multi_cols():
    """test_torch_gbm_surface's 3-class fixture: its class indicators
    give no exactly tied gains, which the packages may break
    differently (ROADMAP C6)."""
    from test_torch_gbm_surface import class_cols

    return class_cols()


TREE_CASES = {
    "gbm_binomial": ("gbm", lambda: train_cols(n=640, seed=5),
                     dict(ntrees=8, max_depth=3, seed=11), 4),
    "gbm_multinomial": ("gbm", _multi_cols,
                        dict(ntrees=6, max_depth=3, seed=12), 2),
    "gbm_sampled_validation": ("gbm", lambda: train_cols(n=640, seed=6),
                               dict(ntrees=8, max_depth=3, seed=4,
                                    sample_rate=0.7, col_sample_rate=0.6,
                                    score_each_iteration=True), 4),
    "drf_binomial": ("drf", lambda: train_cols(n=640, seed=9),
                     dict(ntrees=8, max_depth=4, seed=13), 4),
    "drf_multinomial": ("drf", _multi_cols,
                        dict(ntrees=6, max_depth=4, seed=3), 2),
    "xgboost": ("xgboost", lambda: train_cols(n=640, seed=8),
                dict(ntrees=6, max_depth=3, seed=15, max_bins=32,
                     col_sample_rate=0.7), 4),
}


def _builders(algo):
    from h2o3_tpu.models.model_builder import BUILDERS as JB

    return th.BUILDERS[algo], JB[algo]


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_tree_resume_bitwise_and_matches_reference(cl, jobckpt, case):
    algo, make, params, at = TREE_CASES[case]
    tcls, jcls = _builders(algo)
    jf, tf = both_frames(make())
    base = _train(tcls(**params), tf, "y")
    tm = _interrupt_resume(_Pkg(False), tcls, params, tf, at)
    # (a) bitwise with the uninterrupted port run
    for k in ("feat", "thresh_bin", "left", "right", "leaf_val",
              "cat_split", "na_left"):
        assert_bitwise(np.asarray(getattr(tm.forest, k)),
                       np.asarray(getattr(base.forest, k)), k)
    pb, pt = _host_preds(base, tf), _host_preds(tm, tf)
    assert sorted(pb) == sorted(pt)
    for c in pb:
        assert_bitwise(pt[c], pb[c], c)
    assert tm._output.scoring_history == base._output.scoring_history
    bm, rm = base._output.training_metrics, tm._output.training_metrics
    assert_bitwise(np.array([rm.logloss, rm.rmse, rm.nobs]),
                   np.array([bm.logloss, bm.rmse, bm.nobs]), "metrics")
    # (b) the reference's own resume on the same fixture
    jm = _interrupt_resume(_Pkg(True), jcls, params, jf, at)
    n = tf.nrows
    jp = jm.predict(jf)
    for c in pt:
        np.testing.assert_allclose(pt[c], jp.col(c).to_numpy()[:n],
                                   atol=1e-5, err_msg=c)
    assert tm.forest.n_trees == jm.forest.n_trees


def test_glm_chunked_irls_resume(cl, jobckpt):
    from h2o3_tpu.models.glm import GLM as JGLM

    jf, tf = both_frames(train_cols(n=640, seed=3))
    params = dict(family="binomial", max_iterations=8, beta_epsilon=1e-12,
                  seed=3)
    b0 = th.GLM(**params)
    _attach(_Pkg(False), b0, tf)
    m0 = b0.train(y="y", training_frame=tf)
    assert m0.iterations > 4              # the interrupt lands mid-fit
    tm = _interrupt_resume(_Pkg(False), th.GLM, params, tf, 4)
    np.testing.assert_allclose(tm.beta.numpy(), m0.beta.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert tm.iterations == m0.iterations
    jm = _interrupt_resume(_Pkg(True), JGLM, params, jf, 4)
    np.testing.assert_allclose(tm.beta.numpy(), np.asarray(jm.beta),
                               rtol=1e-5, atol=1e-5)
    assert tm.iterations == jm.iterations


def test_glm_lambda_path_resume(cl, jobckpt):
    from h2o3_tpu.models.glm import GLM as JGLM

    jf, tf = both_frames(train_cols(n=640, seed=4, gaussian=True))
    params = dict(family="gaussian", lambda_search=True, nlambdas=10,
                  alpha=0.5, seed=3)
    m0 = th.GLM(**params).train(y="y", training_frame=tf)
    assert m0.iterations > 4
    tm = _interrupt_resume(_Pkg(False), th.GLM, params, tf, 4)
    np.testing.assert_allclose(tm.beta.numpy(), m0.beta.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert tm.iterations == m0.iterations
    assert tm._parms["lambda_"] == m0._parms["lambda_"]
    jm = _interrupt_resume(_Pkg(True), JGLM, params, jf, 4)
    np.testing.assert_allclose(tm.beta.numpy(), np.asarray(jm.beta),
                               rtol=1e-5, atol=1e-5)
    assert tm.iterations == jm.iterations


def test_kmeans_chunked_lloyd_resume(cl, jobckpt):
    from h2o3_tpu.models.kmeans import KMeans as JKM

    cols = train_cols(n=640, seed=2, gaussian=True)
    jf, tf = both_frames(cols)
    params = dict(k=3, max_iterations=8, seed=5, ignored_columns=["y"])
    b0 = th.KMeans(**params)
    _attach(_Pkg(False), b0, tf)
    m0 = b0.train(training_frame=tf)
    tm = _interrupt_resume(_Pkg(False), th.KMeans, params, tf, 2, y=None)
    np.testing.assert_allclose(tm.centers, m0.centers, rtol=1e-6, atol=1e-7)
    jm = _interrupt_resume(_Pkg(True), JKM, params, jf, 2, y=None)
    np.testing.assert_allclose(np.sort(tm.centers, axis=0),
                               np.sort(np.asarray(jm.centers), axis=0),
                               atol=1e-5)


def test_deeplearning_epoch_resume(cl, jobckpt):
    from h2o3_tpu.models.deeplearning import DeepLearning as JDL

    jf, tf = both_frames(dl_cols("binomial", n=640))
    params = dict(hidden=[8], epochs=4, seed=21, mini_batch_size=32,
                  variable_importances=False)
    m0 = th.DeepLearning(**params).train(y="y", training_frame=tf)
    tm = _interrupt_resume(_Pkg(False), th.DeepLearning, params, tf, 2)
    assert tm.epochs_trained == 4
    p0, pt = _host_preds(m0, tf), _host_preds(tm, tf)
    for c in p0:
        np.testing.assert_allclose(pt[c], p0[c], rtol=1e-6, atol=1e-7,
                                   err_msg=c)
    assert [h["epoch"] for h in tm._output.scoring_history] == [1, 2, 3, 4]
    jm = _interrupt_resume(_Pkg(True), JDL, params, jf, 2)
    n = tf.nrows
    jp = jm.predict(jf)
    for c in pt:
        np.testing.assert_allclose(pt[c], jp.col(c).to_numpy()[:n],
                                   atol=1e-4, err_msg=c)


# --- the store's rules --------------------------------------------------------

def _frame():
    return both_frames(train_cols(n=256, seed=7))[1]


def test_capability_flags_match_reference():
    from h2o3_tpu.models.model_builder import BUILDERS as JB

    for algo in ("gbm", "drf", "xgboost", "glm", "kmeans", "deeplearning",
                 "isolationforest", "extendedisolationforest", "pca"):
        assert th.BUILDERS[algo].supports_iteration_resume \
            == JB[algo].supports_iteration_resume, algo
    assert th.GBM.supports_iteration_resume
    assert not th.IsolationForest.supports_iteration_resume


def test_no_progress_without_resume_spec_or_knob(monkeypatch, tmp_path):
    monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("H2O_TPU_JOB_CKPT_ITERS", "2")
    fr = _frame()
    th.GBM(ntrees=4, max_depth=2, seed=1).train(y="y", training_frame=fr)
    assert not list(tmp_path.glob("jobckpt_*"))
    monkeypatch.setenv("H2O_TPU_JOB_CKPT_ITERS", "0")
    b = th.GBM(ntrees=4, max_depth=2, seed=1)
    _attach(_Pkg(False), b, fr)
    b.train(y="y", training_frame=fr)
    assert not list(tmp_path.glob("jobckpt_*"))


def test_completed_build_deletes_its_progress(jobckpt):
    fr = _frame()
    b = th.GBM(ntrees=4, max_depth=2, seed=1)
    job = _attach(_Pkg(False), b, fr)
    saved = []
    orig = ckpt.save_job_progress

    def spy(*a, **k):
        saved.append(a[1])
        return orig(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ckpt, "save_job_progress", spy)
        b.train(y="y", training_frame=fr)
    assert saved == [2, 4]
    assert ckpt.load_job_progress(str(job.key)) is None
    assert not ckpt.has_job_progress(str(job.key))
    assert not list(jobckpt.glob("jobckpt_*"))


def test_external_fail_racing_completion_keeps_progress(jobckpt):
    fr = _frame()
    b = th.GBM(ntrees=4, max_depth=2, seed=1)
    job = _attach(_Pkg(False), b, fr)
    orig = ModelBuilder._tick_job_progress

    def tick_then_external_fail(self, done, fn):
        orig(self, done, fn)
        if done >= 4:
            self.job.fail("cloud failed while the build was finishing")
            job.fail("cloud failed while the build was finishing")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ModelBuilder, "_tick_job_progress",
                   tick_then_external_fail)
        b.train(y="y", training_frame=fr)
    assert b.job.status == Job.FAILED and b.job.failed_externally
    data = ckpt.load_job_progress(str(job.key))
    assert data is not None and data["iteration"] == 4
    assert [r["job"] for r in ckpt.job_progress_records()] == [str(job.key)]
    assert ckpt.job_progress_records()[0]["algo"] == "gbm"


def test_failing_save_does_not_fail_the_build(jobckpt, monkeypatch):
    fr = _frame()
    b = th.GBM(ntrees=4, max_depth=2, seed=1)
    _attach(_Pkg(False), b, fr)
    monkeypatch.setattr(ckpt, "save_job_progress", lambda *a, **k: 1 / 0)
    m = b.train(y="y", training_frame=fr)
    assert m.forest.n_trees == 4 and b.job.status == Job.DONE


def _saved_gbm_state(fr, at=2):
    b = th.GBM(ntrees=6, max_depth=2, seed=1)
    job = _attach(_Pkg(False), b, fr)
    orig = ModelBuilder._tick_job_progress

    def tick_boom(self, done, fn):
        orig(self, done, fn)
        if done >= at:
            raise _Interrupted()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ModelBuilder, "_tick_job_progress", tick_boom)
        with pytest.raises(_Interrupted):
            b.train(y="y", training_frame=fr)
    return ckpt.load_job_progress(str(job.key))["state"]


@pytest.mark.parametrize("damage", ["missing", "torn"])
def test_missing_or_torn_tree_chunk_fails_the_resume(jobckpt, damage):
    fr = _frame()
    state = _saved_gbm_state(fr)
    chunk = state["tree_chunks"][0]
    if damage == "missing":
        import os

        os.unlink(chunk)
    else:
        with open(chunk, "r+b") as f:
            f.truncate(64)
    b = th.GBM(ntrees=6, max_depth=2, seed=1)
    b._resume_state = state
    with pytest.raises(Exception):
        b.train(y="y", training_frame=fr)


def test_chunk_count_disagreeing_with_state_fails_the_resume(jobckpt):
    fr = _frame()
    state = dict(_saved_gbm_state(fr), n_tree_entries=3)
    b = th.GBM(ntrees=6, max_depth=2, seed=1)
    b._resume_state = state
    with pytest.raises(RuntimeError, match="torn"):
        b.train(y="y", training_frame=fr)


class _Evil:
    def __reduce__(self):
        import os

        return (os.system, ("echo pwned",))


def test_malicious_progress_pickle_is_refused(jobckpt):
    key = "Job_evil"
    path = ckpt._job_path(key)
    with open(path, "wb") as f:
        pickle.dump({"job": key, "iteration": 2, "spec": {},
                     "state": {"x": _Evil()}}, f)
    assert ckpt.load_job_progress(key) is None
    with open(path, "rb") as f, pytest.raises(pickle.UnpicklingError):
        ckpt._CkptUnpickler(io.BytesIO(f.read())).load()


def test_resume_state_is_taken_once():
    b = th.GBM()
    b._resume_state = {"phase": "tree_single", "t_done": 2}
    assert b._take_resume_state("tree_multi") is None
    assert b._take_resume_state("tree_single")["t_done"] == 2
    assert b._take_resume_state("tree_single") is None


def test_tree_chunk_codec_keeps_dtypes():
    from h2o3_tpu_torch.artifact import packer

    packs = [np.full((3, 2, 4), i, np.float32) for i in range(3)]
    vals = [np.arange(5, dtype=np.float32) + i for i in range(3)]
    wys = [np.ones((5, 2), np.float64) * i for i in range(3)]
    pk, lv, lw = packer.unpack_tree_chunk(packer.pack_tree_chunk(packs, vals,
                                                                 wys))
    for a, b in zip(pk + lv + lw, packs + vals + wys):
        assert_bitwise(a, b)
    with pytest.raises(ValueError):
        packer.pack_tree_chunk(packs, vals[:2], wys)


# --- REST, and the card -------------------------------------------------------

def test_rest_train_with_progress(jobckpt, tmp_path, monkeypatch):
    """POST /3/ModelBuilders/gbm with the knob on: the job carries a
    resume spec and reads auto_recoverable, /3/CloudStatus lists its
    progress after the first save, and DONE deletes the files."""
    import threading

    from torch_rest_support import Rest, write_api_csv

    th.init(device="cpu")
    saved, release = threading.Event(), threading.Event()
    orig = ModelBuilder._tick_job_progress

    def tick_and_wait(self, done, fn):
        orig(self, done, fn)
        if done == 2 and self._progress_job is not None:
            saved.set()
            release.wait(60)

    monkeypatch.setattr(ModelBuilder, "_tick_job_progress", tick_and_wait)
    srv = th.start_server(port=0)
    try:
        T = Rest(srv.port)
        _setup, key = T.import_parse(write_api_csv(tmp_path / "a.csv"))
        out = T.json("POST", "/3/ModelBuilders/gbm", data={
            "training_frame": key, "response_column": "y", "ntrees": 4,
            "max_depth": 2, "seed": 1})
        jid = out["job"]["key"]["name"]
        assert saved.wait(60)
        job = T.json("GET", f"/3/Jobs/{jid}")["jobs"][0]
        assert job["status"] == "RUNNING" and job["auto_recoverable"]
        recs = T.json("GET", "/3/CloudStatus")["job_progress"]
        assert [(r["job"], r["iteration"], r["algo"]) for r in recs] == \
            [(jid, 2, "gbm")]
        data = ckpt.load_job_progress(jid)
        assert data["spec"]["training_frame"] == key
        assert data["spec"]["params"]["seed"] == 1
        # the saved chunks go with the completed job: keep a copy to
        # resume from as a user would after a crash
        state = dict(data["state"],
                     tree_chunks=[_copy(p, tmp_path / "kept")
                                  for p in data["state"]["tree_chunks"]])
        release.set()
        job = T.done_job(out)
        assert not job["auto_recoverable"]
        assert T.json("GET", "/3/CloudStatus")["job_progress"] == []
        assert not list(jobckpt.glob("jobckpt_*"))
        b = th.GBM(**data["spec"]["params"])
        b._resume_state = state
        m = b.train(y=data["spec"]["y"], training_frame=th.DKV.get(key))
        want = th.DKV.get(job["dest"]["name"])
        fr = th.DKV.get(key)
        assert_bitwise(m.predict(fr).col("YES").to_numpy(),
                       want.predict(fr).col("YES").to_numpy())
    finally:
        release.set()
        srv.stop()


def _copy(path, d):
    import shutil

    d.mkdir(exist_ok=True)
    return shutil.copy(path, d)


@pytest.mark.gpu
def test_resumed_gbm_on_the_card_is_bitwise(jobckpt):
    """On the card: a GBM resumed from its progress file equals the
    uninterrupted train bit for bit, its resumed levels grown by the
    histogram kernel."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from torch_port_support import flagship_cols

    th.init(device="cuda")
    try:
        fr = th.Frame()
        for name, (arr, ctype) in flagship_cols(50_000, seed=5).items():
            fr.add(name, th.Column.from_numpy(arr, ctype=ctype,
                                              device="cuda"))
        params = dict(ntrees=8, max_depth=5, seed=1)
        base = th.GBM(**params).train(y="y", training_frame=fr)
        hg.launches = 0
        tm = _interrupt_resume(_Pkg(False), th.GBM, params, fr, 4)
        assert hg.launches == (4 + 4) * 5      # the run to 4, the resume
        for k in ("feat", "thresh_bin", "left", "right", "leaf_val"):
            a, b = getattr(tm.forest, k), getattr(base.forest, k)
            assert_bitwise(*(x.cpu().numpy() if torch.is_tensor(x)
                             else np.asarray(x) for x in (a, b)), k)
        assert_bitwise(tm.predict(fr).col("Y").data.cpu().numpy(),
                       base.predict(fr).col("Y").data.cpu().numpy())
    finally:
        th.init(device="cpu")
