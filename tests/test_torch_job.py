"""Jobs in the port (h2o3_tpu_torch/core/job.py), every builder train
under one, the full-float32 pin of the train and predict entry points
(ROADMAP C26), and the kernel loader's build lock.

Job.to_dict()'s keys equal the JAX package's exactly. The progress
ticks are host-only: each hands Job.update plain Python numbers and
strings, never a tensor. The card test (gpu) holds KMeans and a
DeepLearning train with TF32 turned on, card against CPU, to the bars
chip_smoke.py phase 4 holds them to with TF32 off: KMeans centers abs
1e-5 and total within-SS rel 1e-5, DeepLearning weights and predictions
abs 1e-5."""

import pickle
import threading
import time

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch.core import runtime
from h2o3_tpu_torch.core.job import Job, JobCancelled

from torch_port_support import both_frames, dl_cols, flagship_cols


def _frame(cols):
    return both_frames(cols)[1]


def test_to_dict_keys_match_reference(cl):
    from h2o3_tpu.core.job import Job as JJob

    assert list(Job("x").to_dict()) == list(JJob("x").to_dict())


def test_lifecycle_done_failed_cancelled():
    th.init(device="cpu")
    j = Job("ok", dest="job_result_key").start(lambda j: 41 + 1)
    j.join(5)
    assert (j.status, j.progress, j.result) == (Job.DONE, 1.0, 42)
    assert th.DKV.get("job_result_key") == 42
    assert th.DKV.get(j.key) is j

    def boom(j):
        raise RuntimeError("broken")

    bad = Job("bad").start(boom)
    with pytest.raises(RuntimeError, match="broken"):
        bad.join(5)
    assert bad.status == Job.FAILED and "RuntimeError" in bad.exception

    go = threading.Event()

    def loop(j):
        for i in range(1000):
            go.wait(5)
            j.update(i / 1000, f"step {i}")

    c = Job("cancel").start(loop)
    c.cancel()
    go.set()
    c.join(5)
    assert c.status == Job.CANCELLED and not c._thread.is_alive()


def test_external_fail_keeps_its_verdict():
    release = threading.Event()
    j = Job("wedged").start(lambda j: release.wait(5) and "late result")
    j.fail("supervisor says no")
    release.set()
    j._thread.join(5)
    assert j.status == Job.FAILED and j.failed_externally
    assert j.result is None and j.exception == "supervisor says no"
    assert j.restart(resumed_from_iteration=3)
    assert (j.status, j.attempt, j.resumed_from_iteration) == (
        Job.RESUMING, 2, 3)
    assert not j.restart()          # only an externally failed job
    s = Job("sync")
    assert s.begin() and s.complete() and s.status == Job.DONE
    f = Job("sync-fail")
    f.fail("external")
    assert not f.begin() and not f.complete()
    f.fail_local("worker")          # the external verdict stays
    assert f.exception == "external"


def test_pickling_drops_the_thread_and_fails_in_flight_jobs():
    release = threading.Event()
    j = Job("in flight").start(lambda j: release.wait(5))
    restored = pickle.loads(pickle.dumps(j))
    release.set()
    j._thread.join(5)
    assert restored._thread is None and restored.result is None
    assert restored.status == Job.FAILED and restored.failed_externally
    done = pickle.loads(pickle.dumps(Job("done").start(lambda j: 1,
                                                       background=False)))
    assert done.status == Job.DONE


class _Recorder:
    """Job.update wrapped: records each tick's arguments and their
    types (a tensor passed here would mean a device read)."""

    def __init__(self, monkeypatch):
        self.ticks = []
        real = Job.update

        def update(job, progress, msg=""):
            self.ticks.append((progress, msg))
            return real(job, progress, msg)

        monkeypatch.setattr(Job, "update", update)

    def host_only(self):
        return all(type(p) in (float, int) and type(m) is str
                   for p, m in self.ticks)


@pytest.mark.parametrize("algo,kw,response,ticks", [
    ("gbm", dict(ntrees=4, max_depth=2), "binomial",
     ["tree 1", "tree 2", "tree 3", "tree 4"]),
    ("gbm", dict(ntrees=2, max_depth=2), "multinomial",
     ["iter 1", "iter 2"]),
    ("drf", dict(ntrees=3, max_depth=3), "binomial",
     ["tree 1", "tree 2", "tree 3"]),
    ("drf", dict(ntrees=2, max_depth=3), "multinomial",
     ["iter 1", "iter 2"]),
    ("xgboost", dict(ntrees=2, max_depth=2), "binomial",
     ["tree 1", "tree 2"]),
    ("isolationforest", dict(ntrees=3, sample_size=32), None,
     ["tree 1", "tree 2", "tree 3"]),
    ("extendedisolationforest", dict(ntrees=2, sample_size=32), None,
     ["tree 1", "tree 2"]),
    ("deeplearning", dict(hidden=[4], epochs=2), "binomial",
     ["epoch 1/2", "epoch 2/2"]),
    ("gbm", dict(ntrees=1, max_depth=2, nfolds=2, seed=1), "binomial",
     ["CV fold 1/2", "CV fold 2/2", "tree 1"]),
])
def test_every_train_runs_under_a_job_with_host_ticks(monkeypatch, algo,
                                                      kw, response, ticks):
    rec = _Recorder(monkeypatch)
    cols = dl_cols("autoencoder" if response is None else response, n=192)
    b = th.BUILDERS[algo](seed=1, **{k: v for k, v in kw.items()
                                     if k != "seed"})
    b.train(**({} if response is None else {"y": "y"}),
            training_frame=_frame(cols))
    assert b.job.status == Job.DONE and b.job.progress == 1.0
    assert [m.split(" loss=")[0] for _, m in rec.ticks] == ticks
    assert rec.host_only(), rec.ticks
    assert th.DKV.get(b.job.key) is b.job


def test_word2vec_and_coxph_tick(monkeypatch):
    rec = _Recorder(monkeypatch)
    th.init(device="cpu")
    words = np.array((["a", "b", "c", "d", None] * 40), dtype=object)
    fr = th.Frame({"w": th.Column.from_numpy(words)})
    th.Word2Vec(vec_size=4, epochs=2, min_word_freq=1, seed=1).train(
        training_frame=fr)
    assert [m for _, m in rec.ticks] == ["epoch 1", "epoch 2"]
    rec.ticks.clear()
    rng = np.random.default_rng(0)
    n = 128
    x = rng.standard_normal(n)
    t = rng.exponential(np.exp(-0.5 * x))
    cox = th.Frame()
    cox.add("x", th.Column.from_numpy(x))
    cox.add("t", th.Column.from_numpy(t))
    cox.add("event", th.Column.from_numpy((rng.random(n) < 0.8) * 1.0))
    b = th.CoxPH(stop_column="t")
    m = b.train(y="event", training_frame=cox)
    # one tick per Newton step that did not converge
    msgs = [msg for _, msg in rec.ticks]
    assert msgs == [f"newton {i}" for i in range(1, len(msgs) + 1)]
    assert m.iterations - 1 <= len(msgs) <= m.iterations and msgs
    assert rec.host_only() and b.job.status == Job.DONE


def test_cancel_stops_a_train_at_the_next_tick(monkeypatch):
    """cancel() after tree 2: the tick after tree 3 raises JobCancelled
    and the train's job ends CANCELLED at progress 2/ntrees."""
    from h2o3_tpu_torch.models import model_builder

    class CancelAfterTwo(Job):
        def update(self, progress, msg=""):
            super().update(progress, msg)
            if msg == "tree 2":
                self.cancel()

    monkeypatch.setattr(model_builder, "Job", CancelAfterTwo)
    b = th.GBM(ntrees=10, max_depth=2)
    with pytest.raises(JobCancelled):
        b.train(y="y", training_frame=_frame(flagship_cols(128)))
    assert b.job.status == Job.CANCELLED and b.job.progress == 0.2
    assert b.model is None


def test_a_failing_train_fails_its_job():
    b = th.GLM(family="nosuchfamily")
    with pytest.raises(ValueError):
        b.train(y="y", training_frame=_frame(flagship_cols(128)))
    assert b.job.status == Job.FAILED and "ValueError" in b.job.exception


# -- C26: full float32 in every train and predict ---------------------------

def test_every_train_and_predict_is_pinned():
    from h2o3_tpu_torch.models.model import Model

    def subclasses(c):
        return [c] + [s for d in c.__subclasses__() for s in subclasses(d)]

    for cls in th.BUILDERS.values():
        assert getattr(cls.train, "_full_float32", False), cls
    for cls in subclasses(Model):
        assert getattr(cls.predict, "_full_float32", False), cls
        assert getattr(cls.model_performance, "_full_float32", False), cls


@pytest.fixture()
def tf32_on():
    """The caller's setting: TF32 matmuls on, restored after the test."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cudnn.allow_tf32 = saved[1]


def _record_inside(monkeypatch, barrier=None):
    """Wrap KMeans' distance helper: record the matmul flags it runs
    under (and wait at `barrier`, so two trains overlap)."""
    from h2o3_tpu_torch.models import kmeans

    seen = []
    real = kmeans._dist2

    def spy(*a, **k):
        seen.append((torch.get_float32_matmul_precision(),
                     torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        if barrier is not None and len(seen) <= 2:
            barrier.wait(10)
        return real(*a, **k)

    monkeypatch.setattr(kmeans, "_dist2", spy)
    return seen


def _blobs(n=256, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-8, 8, (3, 2))
    X = centers[rng.integers(0, 3, n)] + 0.5 * rng.standard_normal((n, 2))
    th.init(device="cpu")
    return th.Frame.from_numpy(X, names=["x0", "x1"])


def test_train_and_predict_run_in_full_float32(monkeypatch, tf32_on):
    seen = _record_inside(monkeypatch)
    fr = _blobs()
    m = th.KMeans(k=3, seed=1).train(training_frame=fr)
    assert seen and set(seen) == {("highest", False, False)}
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "high"
    assert torch.backends.cudnn.allow_tf32
    seen.clear()
    m.predict(fr)
    assert seen and set(seen) == {("highest", False, False)}
    assert torch.backends.cuda.matmul.allow_tf32
    assert runtime._F32_DEPTH == 0


def test_concurrent_trains_restore_the_callers_setting(monkeypatch,
                                                       tf32_on):
    """Two trains overlap (both wait at a barrier inside their first
    distance pass): each runs pinned, and neither restores the caller's
    flag under the other; the last one out restores it."""
    seen = _record_inside(monkeypatch, threading.Barrier(2))
    fr = _blobs()
    errors = []

    def train(seed):
        try:
            th.KMeans(k=3, seed=seed).train(training_frame=fr)
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=train, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(seen) > 2 and set(seen) == {("highest", False, False)}
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    assert runtime._F32_DEPTH == 0


@pytest.mark.gpu
def test_c26_tf32_on_leaves_card_and_cpu_in_agreement(tf32_on):
    """ROADMAP C26 on the card: with the caller's TF32 switch on, KMeans
    and a DeepLearning train agree card vs CPU to their phase 4 bars,
    and the caller's switch is on again afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    centers = rng.uniform(-8, 8, (5, 4))
    X = centers[rng.integers(0, 5, 100_000)] \
        + 0.5 * rng.standard_normal((100_000, 4))
    cols = flagship_cols(8192, seed=3)
    km, dl = [], []
    for dev in ("cuda", "cpu"):
        th.init(device=dev)
        fr = th.Frame.from_numpy(X, names=[f"x{j}" for j in range(4)])
        km.append(th.KMeans(k=5, seed=1).train(training_frame=fr))
        dfr = th.Frame()
        for k, (a, ct) in cols.items():
            dfr.add(k, th.Column.from_numpy(a, ctype=ct))
        m = th.DeepLearning(
            hidden=[32, 32], epochs=2, seed=1, mini_batch_size=32,
            activation="RectifierWithDropout", input_dropout_ratio=0.1,
            hidden_dropout_ratios=[0.2, 0.2]).train(y="y",
                                                    training_frame=dfr)
        dl.append(([t.cpu().numpy() for W, b in m.params_tree
                    for t in (W, b)],
                   m.predict(dfr).col("Y").data.cpu().numpy()))
    assert torch.backends.cuda.matmul.allow_tf32
    cdiff = float(np.abs(km[0].centers - km[1].centers).max())
    ss = [k._output.training_metrics.tot_withinss for k in km]
    wdiff = max(float(np.abs(a - b).max()) for a, b in zip(dl[0][0],
                                                           dl[1][0]))
    pdiff = float(np.abs(dl[0][1] - dl[1][1]).max())
    print(f"TF32 on: KMeans centers {cdiff:.3e}, SS rel "
          f"{abs(ss[0] - ss[1]) / ss[1]:.3e}; DL weights {wdiff:.3e}, "
          f"predictions {pdiff:.3e}")
    assert cdiff <= 1e-5 and ss[0] == pytest.approx(ss[1], rel=1e-5)
    assert wdiff <= 1e-5 and pdiff <= 1e-5


# -- the kernel loader -------------------------------------------------------

def test_kernel_load_builds_once_from_many_threads(monkeypatch):
    """Eight threads ask for a cold kernel at once: one build runs (the
    compile step is replaced by a 50 ms stand-in that counts overlapping
    builds), and every thread gets the same library."""
    import types

    from h2o3_tpu_torch import kernels

    state = {"starts": 0, "inside": 0, "most": 0}
    lock = threading.Lock()

    def start(name):
        with lock:
            state["starts"] += 1
            state["inside"] += 1
            state["most"] = max(state["most"], state["inside"])
        time.sleep(0.05)
        return ("job", name)

    def finish(name, job):
        with lock:
            state["inside"] -= 1

    def cdll(path):
        return types.SimpleNamespace(**{
            fn: types.SimpleNamespace()
            for fn in kernels.SIGNATURES["hist_gather"]})

    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "_start", start)
    monkeypatch.setattr(kernels, "_finish", finish)
    monkeypatch.setattr(kernels.ctypes, "CDLL", cdll)
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        kernels.load("hist_gather"))) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is got[0] for g in got)
    assert state["starts"] == 1 and state["most"] == 1
