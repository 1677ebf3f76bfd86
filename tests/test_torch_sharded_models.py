"""Training on row-sharded frames (h2o3_tpu_torch/models/model_builder.py's
CV folds, models/{xgboost,glm,deeplearning,ensemble}.py, automl/): ranks
run as threads of this process (`run_ranks`), R = 2, 3 and 4.

Tolerances: bit for bit against one process of the port for fold
assignments (their digests; a fold column's, read from each rank's own
block, is its fingerprint, ROADMAP C49), CV fold forests, CV metrics and
holdout
predictions (each rank holding its `mesh.row_block`), XGBoost forests
(gbtree, dart, the int16 bins of 257) and DeepLearning's synchronous-path
weights; within ROADMAP C46's bar (1e-6) for the GLM lambda path, the
p-values and the ensemble's metalearner; the AutoML leaderboard's
models and order one process's, its tree members' metrics bitwise and
its GLM and ensembles' within C46. Against the JAX package
at the one-process parity tests' tolerances: CV metrics and holdout
predictions 1e-5 (tests/test_torch_cv.py), GLM coefficients 1e-5
(tests/test_torch_glm.py; standard errors 1e-5 and p-values 1e-3
there too), and DeepLearning's model-averaging path, on
8 ranks as the reference's 8 devices and n = 640 (a multiple of its
padding, so ROADMAP C13 does not apply): weights atol 1e-5 against the
reference's averaging epoch run as its code reads (ROADMAP C48), under
tests/test_torch_deeplearning.py's 1e-4 on predictions."""

import json

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch.core import sharded_frame as SF
from h2o3_tpu_torch.models.model_builder import fold_fingerprint
from h2o3_tpu_torch.parallel import mesh as M

from test_torch_sharded import _forest, _train_frame, run_ranks
from torch_port_support import both_frames, dl_cols, train_cols

FOREST_KEYS = ("feat", "thresh_bin", "na_left", "left", "right",
               "leaf_val")


@pytest.fixture(autouse=True)
def _port_cpu():
    """The port on the CPU; what a test leaves in the DKV (Rapids
    results, models, their ranks' frames) is removed after it."""
    th.init(device="cpu")
    before = set(th.DKV.keys())
    yield
    for k in set(th.DKV.keys()) - before:
        th.DKV.remove(k)


def _bitwise(a, b, ctx=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (ctx, a.shape, b.shape)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (ctx, a, b)


def _metric_fields(m):
    return {k: v for k, v in vars(m).items() if isinstance(v, float)}


def _cv(builder, make):
    m = builder().train(y="y", training_frame=make())
    o = m._output
    preds = o.cross_validation_holdout_predictions
    return {"forest": _forest(m) if getattr(m, "forest", None) is not None
            else None,
            "beta": None if getattr(m, "beta", None) is None
            else m.beta.numpy(),
            "digest": o.fold_assignment_digest,
            "cv": _metric_fields(o.cross_validation_metrics),
            "folds": [_metric_fields(f) for f in o.cv_fold_metrics],
            "fold_forests": [_forest(f) for f in
                             (o.cross_validation_models or [])
                             if getattr(f, "forest", None) is not None],
            "preds": None if preds is None else np.asarray(
                preds if isinstance(preds, np.ndarray) else preds.numpy())}


CV_CASES = {
    "gbm_auto": lambda: th.GBM(ntrees=3, max_depth=3, seed=1, nfolds=3,
                               keep_cross_validation_predictions=True),
    "drf_modulo": lambda: th.DRF(ntrees=2, max_depth=3, seed=1, nfolds=2,
                                 fold_assignment="Modulo"),
    "gbm_stratified": lambda: th.GBM(ntrees=2, max_depth=2, seed=4,
                                     nfolds=2,
                                     fold_assignment="Stratified"),
    "glm_fold_column": lambda: th.GLM(family="binomial", lambda_=0.0,
                                      fold_column="fc",
                                      keep_cross_validation_predictions=True),
}


def _cv_frame(n=256, seed=2):
    make = _train_frame(n=n, seed=seed)
    fc = (np.arange(n) * 7 % 3).astype(np.float32)

    def frame():
        fr = make()
        fr.add("fc", th.Column.from_numpy(fc))
        return fr
    return frame


@pytest.mark.parametrize("R", [2, 3, 4])
@pytest.mark.parametrize("case", sorted(CV_CASES))
def test_cv_folds_forests_and_metrics_are_one_process(R, case):
    make = _cv_frame()
    one = _cv(CV_CASES[case], make)

    def rank(r, m):
        before = SF.counters()["gathered_rows"]
        got = _cv(CV_CASES[case], make)
        return got, SF.counters()["gathered_rows"] - before

    for r, (got, gathered) in enumerate(run_ranks(R, rank)):
        assert gathered == 0
        if case.endswith("fold_column"):
            # read from each rank's block: the digest is the fingerprint,
            # whatever the number of ranks (ROADMAP C49)
            assert got["digest"] == fold_fingerprint(
                (np.arange(256) * 7 % 3).astype(int))
        else:
            assert got["digest"] == one["digest"]
        if case.startswith("glm"):                     # ROADMAP C46
            np.testing.assert_allclose(got["beta"], one["beta"], rtol=1e-6,
                                       atol=1e-6)
            for k, v in one["cv"].items():
                assert got["cv"][k] == pytest.approx(v, rel=1e-6,
                                                     abs=1e-9), k
        else:
            assert got["cv"] == one["cv"] and got["folds"] == one["folds"]
            for k in FOREST_KEYS:
                _bitwise(got["forest"][k], one["forest"][k], k)
        for f1, f2 in zip(one["fold_forests"], got["fold_forests"]):
            for k in FOREST_KEYS:
                _bitwise(f2[k], f1[k], k)
        if one["preds"] is not None:
            lo, hi = M.row_block(256, r, R)
            if case.startswith("glm"):
                np.testing.assert_allclose(got["preds"], one["preds"][lo:hi],
                                           atol=1e-6)
            else:
                _bitwise(got["preds"], one["preds"][lo:hi], "holdout")


JAX_CV = {
    "gbm_auto": ("gbm", dict(ntrees=2, max_depth=3, seed=11, nfolds=3,
                             keep_cross_validation_predictions=True)),
    "glm_fold_column": ("glm", dict(family="binomial", lambda_=0.0,
                                    fold_column="fc",
                                    keep_cross_validation_predictions=True)),
}


@pytest.mark.parametrize("case", sorted(JAX_CV))
def test_cv_across_ranks_against_the_jax_package(cl, monkeypatch, case):
    from h2o3_tpu.models.glm import GLM as JGLM
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    algo, kw = JAX_CV[case]
    cols = dict(train_cols(n=384, seed=5),
                fc=((np.arange(384) * 7 % 3).astype(np.float64), None))
    jf, _tf = both_frames(cols)
    jm = {"gbm": JGBM, "glm": JGLM}[algo](**kw).train(y="y",
                                                       training_frame=jf)
    jo = jm._output
    want = np.asarray(jo.cross_validation_holdout_predictions)[:384]

    def rank(r, m):
        tm = {"gbm": th.GBM, "glm": th.GLM}[algo](**kw).train(
            y="y", training_frame=_port_frame(cols))
        return tm._output, m.rows(384)

    for to, (lo, hi) in run_ranks(2, rank):
        assert to.fold_assignment_digest == (
            fold_fingerprint(cols["fc"][0].astype(int))
            if case.endswith("fold_column") else jo.fold_assignment_digest)
        for k, v in _metric_fields(jo.cross_validation_metrics).items():
            got = getattr(to.cross_validation_metrics, k)
            assert got == pytest.approx(v, rel=1e-5, abs=1e-7), k
        np.testing.assert_allclose(
            to.cross_validation_holdout_predictions.numpy(), want[lo:hi],
            atol=1e-5)


def _port_frame(cols):
    fr = th.Frame()
    for nm, (a, ct) in cols.items():
        fr.add(nm, th.Column.from_numpy(a, ctype=ct))
    return fr


def test_cv_fold_progress_is_published_across_processes(monkeypatch):
    from h2o3_tpu_torch.parallel import distributed as D

    make = _train_frame(n=128, seed=3)
    with D.memory_kv():
        monkeypatch.setattr(D, "process_count", lambda: 2)
        monkeypatch.setattr(D, "process_index", lambda: 0)

        def rank(r, m):
            th.GBM(ntrees=1, max_depth=2, seed=1, nfolds=2).train(
                y="y", training_frame=make())
            return True

        assert run_ranks(2, rank) == [True, True]
        recs = [json.loads(v) for _k, v in D.kv_dir("jobs/progress/")]
    assert [r["proc"] for r in recs] == [0]
    assert recs[0]["msg"] == "CV fold 2/2"
    assert recs[0]["progress"] == 0.5


# -- XGBoost ---------------------------------------------------------------------

XGB_CASES = {
    "gbtree": dict(ntrees=3, max_depth=3, seed=1, nbins=16),
    "dart": dict(ntrees=3, max_depth=3, seed=1, nbins=16, booster="dart",
                 rate_drop=0.5),
    "int16_bins": dict(ntrees=2, max_depth=3, seed=1),     # 257 bins
}


@pytest.mark.parametrize("R", [2, 3, 4])
@pytest.mark.parametrize("case", sorted(XGB_CASES))
def test_xgboost_forest_is_the_one_process_forest(R, case):
    make = _train_frame(n=320, seed=2)

    def train():
        return th.XGBoost(**XGB_CASES[case]).train(y="y",
                                                   training_frame=make())

    one = train()
    for m in run_ranks(R, lambda r, mesh: train()):
        for k in FOREST_KEYS:
            _bitwise(_forest(m)[k], _forest(one)[k], k)
        assert m._output.training_metrics.auc == \
            one._output.training_metrics.auc


def test_xgboost_gblinear_across_ranks_within_c46():
    """gblinear trains the port's GLM, row-sharded as any GLM."""
    make = _train_frame(n=320, seed=4)

    def train():
        return th.XGBoost(booster="gblinear", ntrees=5, seed=1).train(
            y="y", training_frame=make())

    one = train()
    for m in run_ranks(2, lambda r, mesh: train()):
        np.testing.assert_allclose(m.beta.numpy(), one.beta.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_xgboost_across_ranks_against_the_jax_package(cl, monkeypatch):
    from h2o3_tpu.models.xgboost import XGBoost as JXGB

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    cols = train_cols(n=384, seed=8)
    jf, _tf = both_frames(cols)
    kw = dict(ntrees=3, max_depth=3, seed=2, nbins=16)
    jm = JXGB(**kw).train(y="y", training_frame=jf)
    for m in run_ranks(2, lambda r, mesh: th.XGBoost(**kw).train(
            y="y", training_frame=_port_frame(cols))):
        np.testing.assert_array_equal(np.asarray(m.forest.feat),
                                      np.asarray(jm.forest.feat))
        np.testing.assert_allclose(np.asarray(m.forest.leaf_val),
                                   np.asarray(jm.forest.leaf_val),
                                   atol=1e-5)


# -- GLM ---------------------------------------------------------------------------

GLM_CASES = {"lambda_search": dict(family="binomial", lambda_search=True,
                                   nlambdas=8),
             "p_values": dict(family="binomial", lambda_=0.0,
                              compute_p_values=True)}


@pytest.mark.parametrize("R", [2, 3])
@pytest.mark.parametrize("case", sorted(GLM_CASES))
def test_glm_lambda_search_and_p_values_within_c46(R, case):
    make = _train_frame(n=320, seed=5)

    def train():
        m = th.GLM(**GLM_CASES[case]).train(y="y", training_frame=make())
        return m.beta.numpy(), m.p_values, m.iterations, \
            m._parms.get("lambda_")

    one = train()
    for got in run_ranks(R, lambda r, mesh: train()):
        np.testing.assert_allclose(got[0], one[0], rtol=1e-6, atol=1e-6)
        if one[1] is not None:
            np.testing.assert_allclose(got[1], one[1], rtol=1e-6, atol=1e-9)
        assert got[2] == one[2] and got[3] == one[3]


@pytest.mark.parametrize("case", sorted(GLM_CASES))
def test_glm_lambda_search_and_p_values_against_the_jax_package(cl, case):
    from h2o3_tpu.models.glm import GLM as JGLM

    cols = train_cols(n=384, seed=4)
    jf, _tf = both_frames(cols)
    kw = dict(GLM_CASES[case], nlambdas=6) if case == "lambda_search" \
        else GLM_CASES[case]
    jm = JGLM(**kw).train(y="y", training_frame=jf)
    jb = np.asarray(jm.beta, np.float64).ravel()
    for m in run_ranks(2, lambda r, mesh: th.GLM(**kw).train(
            y="y", training_frame=_port_frame(cols))):
        np.testing.assert_allclose(m.beta.numpy(), jb, rtol=1e-5, atol=1e-5)
        if case == "p_values":               # test_torch_glm.py's bars
            np.testing.assert_allclose(m.std_errors, jm.std_errors,
                                       rtol=1e-5)
            np.testing.assert_allclose(m.p_values, jm.p_values, rtol=1e-3,
                                       atol=1e-12)


# -- DeepLearning --------------------------------------------------------------------

DL_CASES = {"plain": {},
            "dropout": {"activation": "RectifierWithDropout",
                        "hidden_dropout_ratios": [0.2, 0.1]},
            "sgd_momentum": {"adaptive_rate": False, "momentum_start": 0.5}}


@pytest.mark.parametrize("R", [2, 3, 4])
@pytest.mark.parametrize("case", sorted(DL_CASES))
def test_deeplearning_synchronous_weights_are_one_process(R, case):
    make = _train_frame(n=256, seed=2)

    def train():
        m = th.DeepLearning(hidden=[8, 8], epochs=2, seed=3,
                            mini_batch_size=16, **DL_CASES[case]).train(
            y="y", training_frame=make())
        return ([t.numpy() for W, b in m.params_tree for t in (W, b)],
                m._output.scoring_history)

    one = train()
    SF.reset_counters()
    for w, hist in run_ranks(R, lambda r, mesh: train()):
        for a, b in zip(one[0], w):
            _bitwise(b, a, case)
        assert hist == one[1]
    assert SF.counters()["dl_batch_rows"] > 0
    assert SF.counters()["gathered_rows"] == 0


def _averaged(cols, kw):
    def rank(r, mesh):
        fr = _port_frame(cols)
        m = th.DeepLearning(**kw).train(y="y", training_frame=fr)
        return ([t.numpy() for W, b in m.params_tree for t in (W, b)],
                m._output.training_metrics.auc)

    return run_ranks(8, rank, timeout_s=60.0)


# avg_period = 512 // (16 * 8) = 4 local steps between averages
AVG_KW = dict(hidden=[16, 16], epochs=2, seed=5, mini_batch_size=16,
              train_samples_per_iteration=512)


def test_deeplearning_model_averaging_across_eight_ranks():
    cols = dl_cols("binomial", n=640)
    outs = _averaged(cols, AVG_KW)
    for w, auc in outs[1:]:
        for a, b in zip(outs[0][0], w):
            _bitwise(b, a, "averaged weights on every rank")
        assert auc == outs[0][1]
    sync = _averaged(cols, dict(AVG_KW, train_samples_per_iteration=0))
    # the averaging path ran: its weights are not the synchronous ones
    assert not np.array_equal(sync[0][0][0], outs[0][0][0])
    assert outs[0][1] > 0.5


def test_deeplearning_model_averaging_against_the_jax_package(cl,
                                                             monkeypatch):
    """The reference's averaging epoch (`epoch_avg_body`, its 8 devices'
    shards) run under ``jax.vmap(axis_name="rows")`` on the inputs its
    own train hands it, against the port's epoch on 8 ranks: weights
    atol 1e-5. Its ``shard_map`` execution of the same body on this JAX
    build gives other weights (ROADMAP C48), so the body is run as the
    code reads."""
    import jax
    import jax.numpy as jnp

    import h2o3_tpu.models.deeplearning as JD

    rec = {}
    shard_map, jit = JD._compat_shard_map, jax.jit

    def recording_shard_map(f=None, **kw):
        rec["body"] = f
        sm = shard_map(f, **kw)
        sm._epoch_avg = True
        return sm

    def recording_jit(fn, *a, **k):
        j = jit(fn, *a, **k)
        if not getattr(fn, "_epoch_avg", False):
            return j

        def call(*args):
            rec.setdefault("args", args)
            return j(*args)
        return call

    monkeypatch.setattr(JD, "_compat_shard_map", recording_shard_map)
    monkeypatch.setattr(jax, "jit", recording_jit)
    cols = dl_cols("binomial", n=640)
    jf, _tf = both_frames(cols)
    kw = dict(AVG_KW, epochs=1)
    JD.DeepLearning(**kw).train(y="y", training_frame=jf)
    monkeypatch.undo()
    params, opt_state, sub, X, y, w = rec["args"]
    shard = lambda a: jnp.asarray(a).reshape(  # noqa: E731
        (8, a.shape[0] // 8) + a.shape[1:])
    want, _ = jax.vmap(rec["body"], in_axes=(None, None, None, 0, 0, 0),
                       axis_name="rows")(params, opt_state, sub, shard(X),
                                         shard(y), shard(w))
    outs = _averaged(cols, kw)
    ref = [np.asarray(a)[0] for W, b in want for a in (W, b)]
    for got, exp in zip(outs[0][0], ref):
        np.testing.assert_allclose(got, exp, atol=1e-5)


@pytest.mark.parametrize("vary", [False, True])
def test_c48_shard_map_sums_the_gradient_of_replicated_params(cl, vary):
    """ROADMAP C48's cause, on the reference's 8-device mesh through its
    own `_compat_shard_map`: inside the body, the gradient with respect
    to replicated parameters (in_specs P()) is the sum of every device's
    gradient, not the device's own (this JAX build transposes the
    implicit broadcast of an unvarying value into a psum); made varying
    first, it is the device's own. So each local step of
    `epoch_avg_body` moves by the 8 shards' summed gradient, where
    ``jax.vmap`` and the port move each shard by its own."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from h2o3_tpu.models.deeplearning import _compat_shard_map

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((64, 3)), jnp.float32)
    w0 = jnp.asarray(rng.standard_normal(3), jnp.float32)

    def loss(w, xs):
        return jnp.sum(jnp.tanh(xs @ w))

    def body(w, xs):
        if vary:
            cast = getattr(jax.lax, "pcast", None)
            w = (cast(w, ("rows",), to="varying") if cast is not None
                 else jax.lax.pvary(w, ("rows",)))
        return jax.grad(loss)(w, xs)[None]

    own = np.stack([np.asarray(jax.grad(loss)(w0, X[8 * i:8 * i + 8]))
                    for i in range(8)])
    got = jax.jit(_compat_shard_map(
        body, mesh=cl.mesh, in_specs=(P(), P("rows", None)),
        out_specs=P("rows")))(w0, X)
    want = own if vary else np.broadcast_to(own.sum(0), own.shape)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-6)


# -- StackedEnsemble and AutoML ----------------------------------------------------

def test_stacked_ensemble_across_ranks_within_c46():
    make = _train_frame(n=256, seed=6)

    def train():
        fr = make()
        kw = dict(nfolds=2, seed=3, keep_cross_validation_predictions=True)
        a = th.GBM(ntrees=2, max_depth=3, **kw).train(y="y",
                                                      training_frame=fr)
        b = th.GLM(family="binomial", **kw).train(y="y", training_frame=fr)
        se = th.StackedEnsemble(base_models=[a, b], seed=3).train(
            y="y", training_frame=fr)
        return se.metalearner.beta.numpy(), \
            se._output.training_metrics.auc

    one = train()
    for beta, auc in run_ranks(2, lambda r, mesh: train()):
        np.testing.assert_allclose(beta, one[0], rtol=1e-6, atol=1e-6)
        assert auc == pytest.approx(one[1], rel=1e-6)


def test_stacked_ensemble_across_ranks_against_the_jax_package(cl,
                                                              monkeypatch):
    """tests/test_torch_ensemble.py's bars: the AUTO metalearner's
    coefficients atol 1e-4, predictions atol 1e-5."""
    from h2o3_tpu.models.ensemble import StackedEnsemble as JSE
    from h2o3_tpu.models.glm import GLM as JGLM
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    cols = train_cols(n=384, seed=5)
    jf, _tf = both_frames(cols)
    common = dict(nfolds=3, seed=11, keep_cross_validation_predictions=True)
    specs = ((JGBM, th.GBM, dict(ntrees=2, max_depth=2)),
             (JGLM, th.GLM, dict(lambda_=0.0)))
    jbases = [j(**common, **kw).train(y="y", training_frame=jf)
              for j, _t, kw in specs]
    jm = JSE(base_models=jbases, seed=3).train(y="y", training_frame=jf)
    jp = np.asarray(jm.predict(jf).col("Y").data)[:384]

    def rank(r, m):
        fr = _port_frame(cols)
        bases = [t(**common, **kw).train(y="y", training_frame=fr)
                 for _j, t, kw in specs]
        se = th.StackedEnsemble(base_models=bases, seed=3).train(
            y="y", training_frame=fr)
        return (list(se.metalearner.coef().values()),
                se.predict(fr).col("Y").to_numpy())

    for coef, pred in run_ranks(2, rank):
        np.testing.assert_allclose(coef, list(jm.metalearner.coef().values()),
                                   atol=1e-4)
        np.testing.assert_allclose(pred, jp, atol=1e-5)


def test_automl_across_ranks_against_the_jax_package(cl):
    """tests/test_torch_automl.py's bars: the same steps built, each
    model's CV AUC abs 1e-6, the leaderboard's order where neighbours
    differ by more."""
    from h2o3_tpu.automl.automl import H2OAutoML as JAutoML

    from test_torch_automl import _assert_leaderboards_match, _built
    from torch_port_support import flagship_cols

    cols = flagship_cols(640, seed=3)
    kw = dict(max_models=2, nfolds=2, seed=1,
              include_algos=["glm", "gbm", "stackedensemble"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("H2O_TPU_PALLAS_HIST", "1")
        jf, _tf = both_frames(cols)
        ja = JAutoML(**kw).train(y="y", training_frame=jf)

    def rank(r, m):
        return th.H2OAutoML(project_name=f"shaml_jx_{r}", **kw).train(
            y="y", training_frame=_port_frame(cols))

    for ta in run_ranks(2, rank, timeout_s=120.0):
        assert _built(ta) == _built(ja)
        _assert_leaderboards_match(ja, ta)


def _automl(tag, make, **kw):
    a = th.H2OAutoML(max_models=2, nfolds=2, seed=7,
                     include_algos=["glm", "gbm", "stackedensemble"],
                     project_name=f"shaml_{tag}", **kw).train(
        y="y", training_frame=make())
    return [(r["algo"], r["auc"], r.get("logloss")) for r in a.leaderboard]


def test_automl_leaderboard_across_ranks_is_one_process():
    make = _train_frame(n=192, seed=2)
    one = _automl("one", make)
    assert len(one) >= 3            # two members and their ensembles
    for got in run_ranks(2, lambda r, m: _automl(f"r{r}", make),
                         timeout_s=120.0):
        assert [g[0] for g in got] == [o[0] for o in one]
        for (algo, auc, _ll), (_a, want, _wl) in zip(got, one):
            if algo in ("glm", "stackedensemble"):        # ROADMAP C46
                assert auc == pytest.approx(want, rel=1e-6)
            else:
                assert auc == want


def test_automl_refuses_a_plan_it_cannot_run_across_ranks(monkeypatch):
    """A plan with a stage that cannot run across ranks (target encoding,
    ROADMAP A14.6c part 4) is refused before any member runs; a
    multiclass plan runs (its GLM member fails on the response, as in one
    process), here with the GBM step cut to 2 trees."""
    from h2o3_tpu_torch.automl import steps as tsteps

    def defaults(self, ctx):
        return [tsteps.step("def_gbm_1", "gbm", 10, tsteps.GROUP_DEFAULTS,
                            ntrees=2, max_depth=3)]

    monkeypatch.setattr(tsteps.GBMSteps, "defaults", defaults)
    rng = np.random.default_rng(0)
    n = 96
    X = rng.standard_normal((n, 3)).astype(np.float32)
    y3 = np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)]

    def rank(r, m):
        fr = th.Frame.from_numpy(X, names=["a", "b", "c"])
        fr.add("y", th.Column.from_numpy(y3, ctype="enum"))
        refused = th.H2OAutoML(max_models=2, nfolds=2, seed=1,
                               include_algos=["glm", "gbm"],
                               preprocessing=["target_encoding"],
                               project_name=f"refuse_{r}")
        with pytest.raises(NotImplementedError, match="A14.6c"):
            refused.train(y="y", training_frame=fr)
        aml = th.H2OAutoML(max_models=1, nfolds=0, seed=1,
                           include_algos=["glm", "gbm"],
                           project_name=f"multiclass_{r}").train(
            y="y", training_frame=fr)
        return refused.models, [(x["algo"], x["logloss"])
                                for x in aml.leaderboard]

    (r0, lb0), (r1, lb1) = run_ranks(2, rank, timeout_s=60.0)
    # refused before any member ran; the multiclass plan's GBM one
    # process's on both ranks
    assert r0 == r1 == [] and lb0 == lb1
    assert [a for a, _ll in lb0] == ["gbm"]
