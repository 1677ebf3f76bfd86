"""StackedEnsemble, TargetEncoder, IsotonicRegression and segment models
in the port (on the CPU) against the JAX package on the same numpy
fixtures, and the Rapids prim segment_models_as_frame.

Tolerances:
- StackedEnsemble: the base models' holdout predictions to 1e-5 (as
  test_torch_cv holds them: forests of the same structure, leaf values
  and GLM coefficients to float32 rounding); the non-negative GLM
  metalearner's coefficients atol 1e-4 and the ensemble's probabilities
  atol 1e-5; AUTO's coefficients all >= 0;
- TargetEncoder: the per-level sums rtol 1e-5 (ROADMAP C14: the port's
  order-free fixed-point sums against the reference's float32
  scatter-add), so the encodings atol 1e-6; the noise columns are the
  same numpy draws;
- IsotonicRegression: the knots bitwise (host PAVA on equal inputs),
  predictions atol 1e-6;
- segments: one model per segment, in the same order, with the same
  status; each GLM's coefficients atol 1e-5.
Row counts are multiples of 64, so the JAX package pads no rows."""

import numpy as np
import pytest

import h2o3_tpu_torch as th

from torch_port_support import Both, both_frames, flagship_cols, train_cols


@pytest.fixture(scope="module")
def bases(cl):
    """A cross-validated GBM and GLM trained in both packages on one
    fixture, their holdout predictions held to each other."""
    from h2o3_tpu.models.glm import GLM as JGLM
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("H2O_TPU_PALLAS_HIST", "1")
        jf, tf = both_frames(train_cols(n=384, seed=5))
        common = dict(nfolds=3, seed=11,
                      keep_cross_validation_predictions=True)
        out = []
        for jcls, tcls, kw in ((JGBM, th.GBM, dict(ntrees=2, max_depth=2)),
                               (JGLM, th.GLM, dict(lambda_=0.0))):
            jm = jcls(**common, **kw).train(y="y", training_frame=jf)
            tm = tcls(**common, **kw).train(y="y", training_frame=tf)
            np.testing.assert_allclose(
                tm._output.cross_validation_holdout_predictions,
                jm._output.cross_validation_holdout_predictions, atol=1e-5)
            out.append((jm, tm))
    return out, jf, tf


@pytest.mark.parametrize("algo", ["AUTO", "gbm"])
def test_stacked_ensemble_matches_jax(bases, monkeypatch, algo):
    from h2o3_tpu.models.ensemble import StackedEnsemble as JSE

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    bases, jf, tf = bases
    mp = {"ntrees": 3, "max_depth": 2} if algo == "gbm" else {}
    kw = dict(metalearner_algorithm=algo, metalearner_params=mp, seed=3)
    jm = JSE(base_models=[b[0] for b in bases], **kw).train(
        y="y", training_frame=jf)
    tm = th.StackedEnsemble(base_models=[b[1].key for b in bases],
                            **kw).train(y="y", training_frame=tf)
    assert tm.base_keys == [str(b[1].key) for b in bases]
    if algo == "AUTO":
        # the level-one columns are named by each package's model keys
        jc, tc = jm.metalearner.coef(), tm.metalearner.coef()
        assert list(tc) == tm.base_keys + ["Intercept"]
        np.testing.assert_allclose(list(tc.values()), list(jc.values()),
                                   atol=1e-4)
        assert min(v for k, v in tc.items() if k != "Intercept") >= 0
    jp, tp = jm.predict(jf), tm.predict(tf)
    assert tp.names == jp.names
    np.testing.assert_allclose(tp.col("Y").data.numpy(),
                               np.asarray(jp.col("Y").data)[:jf.nrows],
                               atol=1e-5)
    jt, tt = jm._output.training_metrics, tm._output.training_metrics
    assert tt.auc == pytest.approx(jt.auc, abs=1e-5)
    best = max(b[1]._output.training_metrics.auc for b in bases)
    assert tt.auc > 0.5 and tt.auc >= best - 0.05


def test_stacked_ensemble_refusals(cl):
    cols = train_cols(n=192, seed=2)
    _, tf = both_frames(cols)
    a = th.GLM(nfolds=3, seed=1, keep_cross_validation_predictions=True
               ).train(y="y", training_frame=tf)
    b = th.GLM(nfolds=3, seed=2, keep_cross_validation_predictions=True
               ).train(y="y", training_frame=tf)
    c = th.GLM(seed=1).train(y="y", training_frame=tf)
    with pytest.raises(ValueError, match="different fold"):
        th.StackedEnsemble(base_models=[a, b]).train(y="y",
                                                     training_frame=tf)
    with pytest.raises(ValueError, match="lacks cross-validation"):
        th.StackedEnsemble(base_models=[a, c]).train(y="y",
                                                     training_frame=tf)
    with pytest.raises(ValueError, match="not found"):
        th.StackedEnsemble(base_models=["no_such_model"]).train(
            y="y", training_frame=tf)


def te_cols(n=640, seed=3, numeric=False):
    cols = flagship_cols(n, seed=seed)
    rng = np.random.default_rng(seed)
    cols["fold"] = (rng.integers(0, 4, n).astype(float), None)
    if numeric:
        cols["y"] = (cols["n0"][0] + rng.standard_normal(n), None)
    return cols


@pytest.mark.parametrize("kw,as_training", [
    (dict(), False),
    (dict(blending=True, inflection_point=5, smoothing=10), False),
    (dict(data_leakage_handling="KFold", fold_column="fold", noise=0.0),
     True),
    (dict(data_leakage_handling="LeaveOneOut", blending=True, noise=0.05),
     True),
    (dict(keep_original_categorical_columns=False,
          columns_to_encode=["c1"]), False),
])
def test_target_encoder_matches_jax(cl, kw, as_training):
    from h2o3_tpu.models.target_encoder import TargetEncoder as JTE

    jf, tf = both_frames(te_cols())
    kw = dict(kw, seed=7)
    jm = JTE(**kw).train(y="y", training_frame=jf)
    tm = th.TargetEncoder(**kw).train(y="y", training_frame=tf)
    assert tm.prior == pytest.approx(jm.prior, rel=1e-6)
    assert list(tm.encodings) == list(jm.encodings)
    for c, je in jm.encodings.items():
        te = tm.encodings[c]
        assert te["domain"] == je["domain"]
        for k in ("num", "den", "fold_num", "fold_den"):
            if je[k] is None:
                assert te[k] is None, k
            else:
                np.testing.assert_allclose(te[k], je[k], rtol=1e-5,
                                           atol=1e-6)
    ja = jm.transform(jf, as_training=as_training)
    ta = tm.transform(tf, as_training=as_training)
    assert ta.names == ja.names
    for nm in ta.names:
        if nm.endswith("_te"):
            np.testing.assert_allclose(
                ta.col(nm).data.numpy(),
                np.asarray(ja.col(nm).data)[:jf.nrows], atol=1e-6)


def test_target_encoder_numeric_response_matches_jax(cl):
    from h2o3_tpu.models.target_encoder import TargetEncoder as JTE

    jf, tf = both_frames(te_cols(numeric=True))
    jm = JTE(seed=1).train(y="y", training_frame=jf)
    tm = th.TargetEncoder(seed=1).train(y="y", training_frame=tf)
    for nm in ("c0_te", "c1_te"):
        np.testing.assert_allclose(
            tm.transform(tf).col(nm).data.numpy(),
            np.asarray(jm.transform(jf).col(nm).data)[:jf.nrows],
            atol=1e-5)
    with pytest.raises(ValueError, match="fold_column"):
        th.TargetEncoder(data_leakage_handling="KFold").train(
            y="y", training_frame=tf)


@pytest.mark.parametrize("oob", ["clip", "NA"])
def test_isotonic_regression_matches_jax(cl, oob):
    from h2o3_tpu.models.isotonic import IsotonicRegression as JIR

    rng = np.random.default_rng(4)
    x = np.round(rng.uniform(0, 10, 640), 1)
    y = np.log1p(x) + 0.3 * rng.standard_normal(640)
    w = rng.integers(0, 3, 640).astype(float)
    cols = {"x": (x, None), "y": (y, None), "w": (w, None)}
    jf, tf = both_frames(cols)
    kw = dict(out_of_bounds=oob, weights_column="w")
    jm = JIR(**kw).train(x=["x"], y="y", training_frame=jf)
    tm = th.IsotonicRegression(**kw).train(x=["x"], y="y",
                                           training_frame=tf)
    np.testing.assert_array_equal(tm.thresholds_x, jm.thresholds_x)
    np.testing.assert_array_equal(tm.thresholds_y, jm.thresholds_y)
    assert (np.diff(tm.thresholds_y) >= 0).all()
    q = {"x": (np.array([-1.0, 0.05, 3.33, 9.99, 12.0] + [5.0] * 59),
               None)}
    jq, tq = both_frames(q)
    a = np.asarray(jm.predict(jq).col("predict").data)[:64]
    b = tm.predict(tq).col("predict").data.numpy()
    np.testing.assert_allclose(b, a, atol=1e-6)
    assert np.isnan(b[0]) == (oob == "NA")


def test_segments_match_jax_and_the_prim_reads_them(cl):
    from h2o3_tpu.core.dkv import DKV as JDKV
    from h2o3_tpu.models.glm import GLM as JGLM
    from h2o3_tpu.models.segments import train_segments as jtrain

    cols = flagship_cols(640, seed=9)
    jf, tf = both_frames(cols)
    params = dict(family="binomial", lambda_=0.0)
    js = jtrain(JGLM, params, jf, ["c1"], y="y")
    ts = th.train_segments(th.GLM, params, tf, ["c1"], y="y")
    assert len(ts) == len(js) == 3
    for jr, tr in zip(js.rows, ts.rows):
        assert tr["segment"] == jr["segment"] and tr["status"] == \
            jr["status"] == "SUCCEEDED"
        jc = JDKV.get(jr["model_id"]).coef()
        tc = th.DKV.get(tr["model_id"]).coef()
        assert list(tc) == list(jc)
        assert "c1.y" not in tc and "c1.z" not in tc
        np.testing.assert_allclose(list(tc.values()), list(jc.values()),
                                   atol=1e-5)
    tbl = ts.as_frame()
    assert tbl.col_names == ["c1", "model", "status", "errors"]
    # the prim: the same table in both packages but for the model keys
    from h2o3_tpu.rapids import exec_rapids as jexec

    both = Both("seg")
    try:
        j = jexec(f"(segment_models_as_frame '{js.key}')", both.j)
        t = th.exec_rapids(f"(segment_models_as_frame '{ts.key}')", both.t)
    finally:
        both.end()
    assert t.names == j.names == ["c1", "model", "status", "errors"]
    assert t.nrows == j.nrows == 3
    for nm in ("c1", "status"):
        assert list(t.col(nm).values()) == list(j.col(nm).values()), nm
    assert list(t.col("model").values()) == [r["model_id"] for r in ts.rows]


def test_failed_segment_is_recorded(cl):
    _, tf = both_frames(flagship_cols(192, seed=1))
    ts = th.train_segments(th.CoxPH, {}, tf, ["c1"], y="y")
    assert [r["status"] for r in ts.rows] == ["FAILED"] * 3
    assert all("stop_column" in r["errors"] for r in ts.rows)
    assert ts.as_frame().col("model") == [None] * 3
    with pytest.raises(ValueError, match="not in frame"):
        th.train_segments(th.GLM, {}, tf, ["nope"], y="y")
    with pytest.raises(ValueError, match="exceed max_segments"):
        th.train_segments(th.GLM, {}, tf, ["c0", "c1"], y="y",
                          max_segments=5)
