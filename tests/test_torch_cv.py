"""Cross-validation and calibration in the port (models/model_builder.py)
against the JAX package's, on the CPU.

Tolerances: fold assignments bitwise (their sha1 digests equal, every
scheme); CV metrics, each fold's metrics and the holdout predictions to
1e-5 (GBM: forests of the same structure, leaf values to float32
rounding; GLM: IRLS to float32 rounding); Platt's (a, b) and the
calibrated probabilities (Platt and isotonic) to 1e-5. The same
ValueErrors, raised before anything trains."""

import numpy as np
import pytest

import h2o3_tpu_torch as th

from torch_port_support import both_frames, flagship_cols, train_cols


def _gbm():
    from h2o3_tpu.models.tree.gbm import GBM

    return GBM


def _glm():
    from h2o3_tpu.models.glm import GLM

    return GLM


def _cv_pair(monkeypatch, jcls, tcls, cols, **kw):
    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    jf, tf = both_frames(cols)
    jm = jcls(**kw).train(y="y", training_frame=jf)
    tm = tcls(**kw).train(y="y", training_frame=tf)
    return jm, tm


def _metric_fields(m):
    return {k: v for k, v in vars(m).items()
            if isinstance(v, float) and k != "nobs"}


def _assert_metrics_close(a, b, rtol=1e-5):
    fa, fb = _metric_fields(a), _metric_fields(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if np.isnan(fa[k]):
            assert np.isnan(fb[k]), k
        else:
            assert fb[k] == pytest.approx(fa[k], rel=rtol, abs=1e-7), k


@pytest.mark.parametrize("scheme", ["AUTO", "Random", "Modulo",
                                    "Stratified"])
def test_gbm_cv_matches_jax(cl, monkeypatch, scheme):
    jm, tm = _cv_pair(monkeypatch, _gbm(), th.GBM, train_cols(n=384, seed=5),
                      ntrees=2, max_depth=3, seed=11, nfolds=3,
                      fold_assignment=scheme,
                      keep_cross_validation_predictions=True)
    jo, to = jm._output, tm._output
    assert to.fold_assignment_digest == jo.fold_assignment_digest
    assert len(to.cv_fold_metrics) == len(jo.cv_fold_metrics) == 3
    for a, b in zip(jo.cv_fold_metrics, to.cv_fold_metrics):
        _assert_metrics_close(a, b)
    _assert_metrics_close(jo.cross_validation_metrics,
                          to.cross_validation_metrics)
    assert to.cross_validation_metrics.description == \
        jo.cross_validation_metrics.description
    np.testing.assert_allclose(to.cross_validation_holdout_predictions,
                               np.asarray(
                                   jo.cross_validation_holdout_predictions),
                               atol=1e-5)
    assert len(to.cross_validation_models) == 3
    # the main model is the full-data model, as without CV
    np.testing.assert_allclose(tm.forest.leaf_val,
                               np.asarray(jm.forest.leaf_val), atol=1e-5)


def test_fold_column_and_regression_cv_match_jax(cl, monkeypatch):
    cols = train_cols(n=320, seed=8, gaussian=True)
    cols["fold"] = (np.arange(320) % 4, None)
    jm, tm = _cv_pair(monkeypatch, _gbm(), th.GBM, cols, ntrees=2,
                      max_depth=3, fold_column="fold",
                      keep_cross_validation_predictions=True)
    jo, to = jm._output, tm._output
    assert to.fold_assignment_digest == jo.fold_assignment_digest
    assert "fold" not in to.names and to.names == jo.names
    _assert_metrics_close(jo.cross_validation_metrics,
                          to.cross_validation_metrics)
    np.testing.assert_allclose(to.cross_validation_holdout_predictions,
                               np.asarray(
                                   jo.cross_validation_holdout_predictions),
                               atol=1e-5)


@pytest.mark.parametrize("family", ["binomial", "gaussian"])
def test_glm_cv_matches_jax(cl, family):
    cols = flagship_cols(448, seed=2)
    if family == "gaussian":
        noise = np.random.default_rng(9).standard_normal(448)
        cols["y"] = (cols["n0"][0] * 2 - cols["n3"][0] + 0.5 * noise, None)
    jf, tf = both_frames(cols)
    kw = dict(family=family, lambda_=0.0, nfolds=4, seed=3,
              keep_cross_validation_predictions=True,
              keep_cross_validation_models=False)
    jm = _glm()(**kw).train(y="y", training_frame=jf)
    tm = th.GLM(**kw).train(y="y", training_frame=tf)
    jo, to = jm._output, tm._output
    assert to.fold_assignment_digest == jo.fold_assignment_digest
    for a, b in zip(jo.cv_fold_metrics, to.cv_fold_metrics):
        _assert_metrics_close(a, b)
    _assert_metrics_close(jo.cross_validation_metrics,
                          to.cross_validation_metrics)
    np.testing.assert_allclose(to.cross_validation_holdout_predictions,
                               np.asarray(
                                   jo.cross_validation_holdout_predictions),
                               atol=1e-5)
    assert to.cross_validation_models is None


def test_cv_guards_match_jax(cl):
    jf, tf = both_frames(train_cols(n=128, gaussian=True))
    m0 = th.GBM(ntrees=1).train(y="y", training_frame=tf)
    cases = [({"nfolds": 3, "fold_assignment": "Stratified"},
              "categorical response"),
             ({"nfolds": 3, "fold_assignment": "Sideways"},
              "unknown fold_assignment")]
    for kw, msg in cases:
        for cls, fr in ((_gbm(), jf), (th.GBM, tf)):
            with pytest.raises(ValueError, match=msg):
                cls(ntrees=1, **kw).train(y="y", training_frame=fr)
    jm0 = _gbm()(ntrees=1).train(y="y", training_frame=jf)
    for cls, fr, ck in ((_gbm(), jf, jm0), (th.GBM, tf, m0)):
        with pytest.raises(ValueError, match="cross-validation"):
            cls(ntrees=2, nfolds=3, checkpoint=ck).train(y="y",
                                                        training_frame=fr)


# --- calibration ------------------------------------------------------------

@pytest.mark.parametrize("method", ["PlattScaling", "IsotonicRegression"])
def test_calibration_matches_jax(cl, monkeypatch, method):
    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    jf, tf = both_frames(train_cols(n=448, seed=21))
    jc, tc = both_frames(train_cols(n=256, seed=22))
    kw = dict(ntrees=3, max_depth=3, seed=1, calibrate_model=True,
              calibration_method=method)
    jm = _gbm()(calibration_frame=jc, **kw).train(y="y", training_frame=jf)
    tm = th.GBM(calibration_frame=tc, **kw).train(y="y", training_frame=tf)
    kind, parms = tm._calibrator
    assert kind == jm._calibrator[0]
    if kind == "platt":
        np.testing.assert_allclose(parms, jm._calibrator[1], rtol=1e-5)
    else:
        np.testing.assert_allclose(parms[0], jm._calibrator[1][0],
                                   atol=1e-5)
        np.testing.assert_allclose(parms[1], jm._calibrator[1][1],
                                   atol=1e-5)
    jp, tp = jm.predict(jf), tm.predict(tf)
    assert tp.names == jp.names == ["predict", "N", "Y", "cal_N", "cal_Y"]
    for c in ("cal_N", "cal_Y"):
        np.testing.assert_allclose(tp.col(c).to_numpy(),
                                   jp.col(c).to_numpy()[:448], atol=1e-5)
    assert isinstance(tm._parms["calibration_frame"], str)


def test_calibration_guards_match_jax(cl):
    jf, tf = both_frames(train_cols(n=128, gaussian=True))
    jb, tb = both_frames(train_cols(n=128))
    cases = [(jb, tb, {}, "requires a calibration_frame"),
             (jf, tf, {"calibration_frame": "cf"}, "binomial models")]
    for jfr, tfr, extra, msg in cases:
        for cls, fr in ((_gbm(), jfr), (th.GBM, tfr)):
            ex = dict(extra)
            if "calibration_frame" in ex:
                ex["calibration_frame"] = fr
            with pytest.raises(ValueError, match=msg):
                cls(ntrees=1, calibrate_model=True, **ex).train(
                    y="y", training_frame=fr)
    # GLM and DeepLearning take no calibration parameters, as in the
    # reference
    for cls in (_glm(), th.GLM, th.DeepLearning):
        with pytest.raises(ValueError):
            cls(calibrate_model=True)


def test_pava_and_interpolation_match_jax():
    import jax.numpy as jnp

    from h2o3_tpu.models.isotonic import interpolate as jint, pava as jpava
    from h2o3_tpu_torch.models.isotonic import interpolate, pava

    rng = np.random.default_rng(4)
    x = np.round(rng.random(300), 2)
    y = (rng.random(300) < x).astype(float)
    w = rng.uniform(0.5, 2, 300)
    a, b = jpava(x, y, w), pava(x, y, w)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    q = np.concatenate([rng.random(50) * 1.4 - 0.2, [np.nan]]).astype(
        np.float32)
    import torch

    np.testing.assert_allclose(
        interpolate(*b, torch.from_numpy(q)).numpy(),
        np.asarray(jint(*a, jnp.asarray(q))), atol=1e-6)
