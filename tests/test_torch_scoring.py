"""The port's scoring sessions and micro-batcher against the JAX
package (h2o3_tpu/scoring.py): on carried-across binomial and
multinomial forests, session margins are bitwise equal to the model's
eager margins and to the reference's ScoringSession, NAs included;
distinct request sizes use at most len(buckets) programs and padded
rows never leak; leaf walks, leaf assignment and staged probabilities
through the session are bitwise equal to the eager walk; a coalesced
flush gives each request its exact slice at the reference's dispatch
counts. The `gpu` tests hold CUDA-graph replay against the eager walk
and concurrent requests against single ones on the card."""

import threading

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert, scoring

from torch_port_support import (assert_bitwise, both_frames, carry_forest,
                                frames_bitwise)


def _train_cols(n=1536, seed=0, classes=2):
    """The reference's scoring fixture (tests/test_scoring_session.py)."""
    rng = np.random.default_rng(seed)
    x1, x2 = rng.standard_normal(n), rng.standard_normal(n)
    g = np.array(["a", "b", "c"])[rng.integers(0, 3, n)]
    logit = 1.2 * x1 - x2 + (g == "a") * 0.5
    if classes == 2:
        y = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "Y", "N")
    else:
        y = np.array(["r", "s", "t"])[
            np.clip((logit + rng.normal(0, 0.5, n) + 1.5).astype(int), 0,
                    classes - 1)]
    return {"x1": (x1, None), "x2": (x2, None), "g": (g, "enum"),
            "y": (y, "enum")}


def _score_cols(n, seed, with_nas=True):
    rng = np.random.default_rng(seed)
    x1, x2 = rng.standard_normal(n), rng.standard_normal(n)
    if with_nas:
        x1[::7] = np.nan
    g = np.array(["a", "b", "c", "zz"], object)[rng.integers(0, 4, n)]
    if with_nas:
        g[::11] = None
    return {"x1": (x1, None), "x2": (x2, None), "g": (g, "enum")}


@pytest.fixture(scope="module")
def models(cl):
    """{kind: (JAX model, port model)}: binomial and multinomial GBMs
    trained by the JAX package and carried into the port."""
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    out = {}
    for kind, classes, kw in (("binomial", 2, dict(ntrees=8, max_depth=3)),
                              ("multinomial", 3, dict(ntrees=4,
                                                      max_depth=3))):
        jf, _tf = both_frames(_train_cols(classes=classes, seed=classes))
        jm = JGBM(seed=1, **kw).train(y="y", training_frame=jf)
        out[kind] = (jm, convert.gbm_model_from_numpy(carry_forest(jm)))
    return out


@pytest.mark.parametrize("kind", ["binomial", "multinomial"])
@pytest.mark.parametrize("n", [17, 300, 1000, 4100])
def test_session_margins_bitwise_vs_margin_and_reference(models, kind, n):
    from h2o3_tpu import scoring as jscoring

    jm, tm = models[kind]
    jf, tf = both_frames(_score_cols(n, seed=n))
    sess = scoring.ScoringSession(tm)
    adapted = tm.adapt_test(tf)
    got = sess._margin_x(sess._features(adapted))
    assert_bitwise(got.numpy(), tm._margin(adapted).numpy(), (kind, n))
    jsess = jscoring.ScoringSession(jm)
    ref = jsess._margin_x(jsess._features(jm.adapt_test(jf), n))
    assert_bitwise(got.numpy(), np.asarray(ref)[:n], (kind, n, "ref"))
    # host input (the double-buffered stager) gives the same bits
    host = sess._margin_x(sess._features(adapted).numpy())
    assert_bitwise(host.numpy(), got.numpy())


def test_distinct_sizes_use_at_most_len_buckets_programs(monkeypatch,
                                                         models):
    _jm, tm = models["binomial"]
    monkeypatch.setenv("H2O_TPU_SCORE_BUCKETS", "64,256")
    sess = scoring.ScoringSession(tm)
    assert sess.buckets == (64, 256)
    for n in (17, 60, 200, 700, 999):
        _jf, tf = both_frames(_score_cols(n, seed=3 * n))
        disp = []
        frames_bitwise(tm.predict(tf), sess.predict(tf))
        sess._margin_x(sess._features(tm.adapt_test(tf)), dispatched=disp)
        assert disp == [256] * (n // 256) + (
            [sess._bucket_for(n % 256)] if n % 256 else []), (n, disp)
    assert sess.traversal_compiles <= len(sess.buckets)
    assert sess.fused_compiles == 0          # the CPU captures nothing


def test_env_buckets_and_supports(monkeypatch, models):
    monkeypatch.setenv("H2O_TPU_SCORE_BUCKETS", "nope")
    assert scoring._env_buckets() == scoring._DEFAULT_BUCKETS
    monkeypatch.setenv("H2O_TPU_SCORE_BUCKETS", "300;20,20")
    assert scoring._env_buckets() == (20, 300)
    _jm, tm = models["binomial"]
    assert scoring.supports(tm)
    monkeypatch.setenv("H2O_TPU_SCORE_FAST", "0")
    assert not scoring.supports(tm)
    monkeypatch.delenv("H2O_TPU_SCORE_FAST")
    _jf, tf = both_frames(_train_cols(n=256))
    iso = th.IsolationForest(ntrees=3, seed=1).train(training_frame=tf)
    assert not scoring.supports(iso)


@pytest.mark.parametrize("kind", ["binomial", "multinomial"])
def test_leaf_matrix_bitwise_vs_eager_walk_and_reference(models, kind):
    jm, tm = models[kind]
    n = 700
    jf, tf = both_frames(_score_cols(n, seed=41))
    adapted = tm.adapt_test(tf)
    got = scoring.session_for(tm).leaf_matrix(adapted, n)
    eager = tm.forest.leaf_index(tm.spec.bin_columns(adapted)).numpy()
    assert_bitwise(got, eager)
    ref = np.asarray(jm.forest.leaf_index(
        jm.spec.bin_columns(jm.adapt_test(jf))))[:n]
    assert_bitwise(got, ref.astype(np.int64))


@pytest.mark.parametrize("kind", ["binomial", "multinomial"])
def test_leaf_assignment_and_staged_through_the_session(monkeypatch, models,
                                                        kind):
    """The two in-process users of leaf_matrix give the eager pass's
    frames bit for bit (H2O_TPU_SCORE_FAST=0 takes the eager pass)."""
    _jm, tm = models[kind]
    _jf, tf = both_frames(_score_cols(333, seed=5))
    fast = {t: tm.predict_leaf_node_assignment(tf, type=t)
            for t in ("Path", "Node_ID")}
    staged = tm.staged_predict_proba(tf)
    monkeypatch.setenv("H2O_TPU_SCORE_FAST", "0")
    for t, fr in fast.items():
        frames_bitwise(fr, tm.predict_leaf_node_assignment(tf, type=t), t)
    frames_bitwise(staged, tm.staged_predict_proba(tf), "staged")


def _entries(seed, sizes):
    return [(both_frames(_score_cols(n, seed=seed + i))[1], None, False)
            for i, n in enumerate(sizes)]


def test_coalesced_flush_gives_exact_slices_at_reference_counts(
        monkeypatch, models):
    from h2o3_tpu import scoring as jscoring

    jm, tm = models["binomial"]
    monkeypatch.setenv("H2O_TPU_SCORE_BUCKETS", "64,256")
    sizes = [128] * 16 + [300, 5]
    cols = [_score_cols(n, seed=70 + i) for i, n in enumerate(sizes)]
    pairs = [both_frames(c) for c in cols]
    sess = scoring.ScoringSession(tm)
    res = sess.predict_batch([(tf, None, False) for _jf, tf in pairs])
    for (_jf, tf), (pred, mm) in zip(pairs, res):
        frames_bitwise(pred, tm.predict(tf))
        assert mm is None and th.DKV.get(pred.key) is pred
        pred.delete()
    jsess = jscoring.ScoringSession(jm)
    # the reference's host-packed flush (its shard_map twin, which this
    # JAX build refuses, waits for ROADMAP A14 in the port)
    monkeypatch.setattr(jsess, "_sharded_view", lambda adapted: None)
    jsess.predict_batch([(jf, None, False) for jf, _tf in pairs])
    snap, jsnap = sess.stats.snapshot(), jsess.stats.snapshot()
    for k in ("requests", "batches", "rows", "dispatches",
              "max_batch_requests", "dispatches_per_flush"):
        assert snap[k] == jsnap[k], (k, snap[k], jsnap[k])
    assert snap["dispatches"] == -(-sum(sizes) // 256)


def test_flush_with_metrics_and_destination(models):
    _jm, tm = models["binomial"]
    _jf, tf = both_frames(_train_cols(n=512, seed=9))
    (pred, mm), = scoring.session_for(tm).predict_batch(
        [(tf, "flush_dest_key", True)])
    assert pred.key == "flush_dest_key" and th.DKV.get("flush_dest_key")
    ref = tm.model_performance(tf)
    assert mm.auc == ref.auc and mm.logloss == ref.logloss
    pred.delete()


def _concurrent(model, frames, via=None):
    out, errors = [None] * len(frames), []
    barrier = threading.Barrier(len(frames))

    def worker(i):
        try:
            barrier.wait(timeout=30)
            out[i] = (via or scoring.score_request)(model, frames[i])[0]
        except BaseException as e:   # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out, errors


def test_concurrent_requests_coalesce_and_get_their_own_rows(monkeypatch,
                                                             models):
    _jm, tm = models["binomial"]
    monkeypatch.setenv("H2O_TPU_SCORE_BATCH_WINDOW_MS", "50")
    scoring.purge(str(tm.key))
    frames = [e[0] for e in _entries(200, [128] * 12 + [40, 1000])]
    preds, errors = _concurrent(tm, frames)
    assert not errors, errors
    for fr, pred in zip(frames, preds):
        frames_bitwise(pred, tm.predict(fr))
        pred.delete()
    st = scoring.session_for(tm).stats.snapshot()
    assert st["requests"] == len(frames) and st["max_batch_requests"] > 1
    assert st["dispatches_per_flush"] <= 4.0
    assert scoring.metrics_snapshot()


def test_admission_rejects_overflow_and_serves_the_rest(monkeypatch,
                                                        models):
    from h2o3_tpu_torch import admission

    _jm, tm = models["binomial"]
    monkeypatch.setenv("H2O_TPU_SCORE_MAX_INFLIGHT", "1")
    monkeypatch.setenv("H2O_TPU_SCORE_QUEUE_CAP", "2")
    monkeypatch.setenv("H2O_TPU_SCORE_BATCH_WINDOW_MS", "30")
    admission.CONTROLLER.reset()
    frames = [e[0] for e in _entries(300, [64] * 12)]
    preds, errors = _concurrent(tm, frames)
    assert errors and all(isinstance(e, admission.AdmissionRejected)
                          and e.status == 429 for e in errors)
    served = [(fr, p) for fr, p in zip(frames, preds) if p is not None]
    assert served and len(served) + len(errors) == len(frames)
    for fr, pred in served:
        frames_bitwise(pred, tm.predict(fr))
        pred.delete()
    snap = admission.CONTROLLER.snapshot()
    assert snap["rejected"] == len(errors) and snap["admitted"] == len(served)
    admission.CONTROLLER.reset()


# -- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")


def _on_card(n, seed):
    """A score frame's columns moved to the card (built on the CPU)."""
    _jf, tf = both_frames(_score_cols(n, seed=seed))
    fr = th.Frame()
    for nm in tf.names:
        c = tf.col(nm)
        fr.add(nm, c.with_data(c.data.cuda()))
    return fr


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["binomial", "multinomial"])
def test_graph_replay_equals_eager_walk_on_the_card(models, kind):
    _card()
    _jm, tm = models[kind]
    frames = {n: _on_card(n, n) for n in (17, 300, 1000, 4100, 20000)}
    th.init(device="cuda")
    try:
        sess = scoring.ScoringSession(tm)
        for n, fr in frames.items():
            adapted = tm.adapt_test(fr)
            eager = tm._margin(adapted).cpu().numpy()
            for _ in range(2):              # first run eager, then replays
                got = sess._margin_x(sess._features(adapted))
                assert_bitwise(got.cpu().numpy(), eager, (kind, n))
            leaves = sess.leaf_matrix(adapted, n)
            assert_bitwise(leaves, tm.forest.leaf_index(
                tm.spec.bin_columns(adapted)).cpu().numpy())
        assert 0 < sess.fused_compiles <= 2 * len(sess.buckets)
    finally:
        th.init(device="cpu")


@pytest.mark.gpu
def test_concurrent_requests_equal_single_ones_on_the_card(monkeypatch,
                                                           models):
    _card()
    _jm, tm = models["binomial"]
    frames = [_on_card(128, 500 + i) for i in range(16)]
    th.init(device="cuda")
    monkeypatch.setenv("H2O_TPU_SCORE_BATCH_WINDOW_MS", "5")
    scoring.purge(str(tm.key))
    try:
        assert scoring.session_for(tm).device.type == "cuda"
        single = [scoring.session_for(tm).predict(fr) for fr in frames]
        for _ in range(3):
            preds, errors = _concurrent(tm, frames)
            assert not errors, errors
            for a, b in zip(preds, single):
                frames_bitwise(a, b)
    finally:
        scoring.purge(str(tm.key))
        th.init(device="cpu")
