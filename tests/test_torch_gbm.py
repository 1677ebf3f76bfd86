"""The slice as a whole: GBM trained and scored by the port (on the CPU)
against the JAX package run through its Pallas histogram kernel in
interpret mode, on the reference's `_train_frame` fixture.

Tolerances: forest structure equal; predictions atol 1e-5 (the JAX
package sums its histograms as 8 shard partials plus a psum, the port on
one device, and XLA's exp/log are not torch's, over 4 trees); training
AUC abs 1e-6 (the reference's own bar between its lowerings); RMSE and
deviance rtol 1e-5."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th

from torch_port_support import both_frames, forest_arrays, train_cols


def _both(monkeypatch, cols, **kw):
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    jf, tf = both_frames(cols)
    kw = dict(ntrees=4, max_depth=3, seed=3) | kw
    jm = JGBM(**kw).train(y="y", training_frame=jf)
    tm = th.GBM(**kw).train(y="y", training_frame=tf)
    a, b = forest_arrays(jm.forest), forest_arrays(tm.forest)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert tm.forest.init_f == pytest.approx(jm.forest.init_f, rel=1e-6)
    np.testing.assert_allclose(tm.forest.leaf_val,
                               np.asarray(jm.forest.leaf_val), atol=1e-5)
    return jm, tm, jf, tf


def test_bernoulli_gbm_matches_jax(cl, monkeypatch):
    jm, tm, jf, tf = _both(monkeypatch, train_cols())
    n = tf.nrows
    jp, tp = jm.predict(jf), tm.predict(tf)
    np.testing.assert_allclose(tp.col("Y").to_numpy(),
                               jp.col("Y").to_numpy()[:n], atol=1e-5)
    jmt, tmt = jm._output.training_metrics, tm._output.training_metrics
    assert tmt.auc == pytest.approx(jmt.auc, abs=1e-6)
    assert tmt.logloss == pytest.approx(jmt.logloss, rel=1e-5)
    assert tmt.rmse == pytest.approx(jmt.rmse, rel=1e-5)
    assert tm._output.model_category == "Binomial"
    assert tm._output.response_domain == ["N", "Y"]
    assert list(tm._output.variable_importances) == \
        list(jm._output.variable_importances)
    dev_j = jm._output.scoring_history[-1]["training_deviance"]
    dev_t = tm._output.scoring_history[-1]["training_deviance"]
    assert dev_t == pytest.approx(dev_j, rel=1e-5)
    assert tm.model_performance().auc == tmt.auc
    labels = tp.col("predict")
    assert labels.domain == ["N", "Y"]
    assert set(np.unique(labels.to_numpy())) <= {0, 1}


def test_gaussian_gbm_matches_jax(cl, monkeypatch):
    jm, tm, jf, tf = _both(monkeypatch, train_cols(gaussian=True))
    n = tf.nrows
    np.testing.assert_allclose(tm.predict(tf).col("predict").to_numpy(),
                               jm.predict(jf).col("predict").to_numpy()[:n],
                               atol=1e-5)
    jmt, tmt = jm._output.training_metrics, tm._output.training_metrics
    assert tm._output.model_category == "Regression"
    assert tmt.rmse == pytest.approx(jmt.rmse, rel=1e-5)
    assert tmt.mean_residual_deviance == pytest.approx(
        jmt.mean_residual_deviance, rel=1e-5)
    assert tmt.mae == pytest.approx(jmt.mae, rel=1e-5)


def test_scoring_adapts_test_frames_like_jax(cl, monkeypatch):
    """A test frame with columns reordered, a missing predictor and an
    unseen level scores the same in both packages."""
    jm, tm, _, _ = _both(monkeypatch, train_cols(seed=11), ntrees=2)
    rng = np.random.default_rng(2)
    g = np.array(["c", "zz", "a", "b"] * 25, object)
    test = {"g": (g, "enum"), "x": (rng.standard_normal(100), None)}
    jt, tt = both_frames(test)
    np.testing.assert_allclose(tm.predict(tt).col("Y").to_numpy(),
                               jm.predict(jt).col("Y").to_numpy()[:100],
                               atol=1e-5)
    jt2, tt2 = both_frames({"x": test["x"]})
    np.testing.assert_allclose(tm.predict(tt2).col("Y").to_numpy(),
                               jm.predict(jt2).col("Y").to_numpy()[:100],
                               atol=1e-5)


def test_unported_parameters_raise():
    """The parameters the port once refused (cross-validation,
    calibration, checkpoints and export) run now, and default to the
    reference's values; a checkpoint may be named by its DKV key; what
    still raises is an unknown checkpoint key and a dart booster with a
    checkpoint (ValueError, as in the reference)."""
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    th.init(device="cpu")
    _, tf = both_frames(train_cols(n=100))
    _, tc = both_frames(train_cols(n=64, seed=9))
    ref = JGBM.default_params()
    for k in ("nfolds", "fold_column", "fold_assignment",
              "keep_cross_validation_models",
              "keep_cross_validation_predictions", "calibrate_model",
              "calibration_frame", "calibration_method", "checkpoint",
              "export_checkpoints_dir"):
        assert th.GBM().params[k] == ref[k], k
    runs = ({"nfolds": 3}, {"nfolds": 2, "fold_assignment": "Modulo"},
            {"nfolds": 2, "keep_cross_validation_models": False},
            {"nfolds": 2, "keep_cross_validation_predictions": True},
            {"calibrate_model": True, "calibration_frame": tc},
            {"calibrate_model": True, "calibration_frame": tc,
             "calibration_method": "IsotonicRegression"})
    for kw in runs:
        m = th.GBM(ntrees=1, **kw).train(y="y", training_frame=tf)
        out = m._output
        assert (out.cross_validation_metrics is not None) == \
            ("nfolds" in kw), kw
        assert (out.cross_validation_models is not None) == (
            "nfolds" in kw and "keep_cross_validation_models" not in kw), kw
        assert (out.cross_validation_holdout_predictions is not None) == \
            ("keep_cross_validation_predictions" in kw), kw
        assert (m._calibrator is not None) == ("calibrate_model" in kw), kw
    m1 = th.GBM(ntrees=1).train(y="y", training_frame=tf)
    assert th.GBM(ntrees=2, checkpoint=m1).train(
        y="y", training_frame=tf).forest.n_trees == 2
    assert th.GLM(nfolds=3).train(
        y="y", training_frame=tf)._output.cross_validation_metrics
    assert th.GBM(ntrees=2, checkpoint=m1.key).train(
        y="y", training_frame=tf).forest.n_trees == 2
    with pytest.raises(ValueError, match="not found"):
        th.GBM(ntrees=2, checkpoint="m").train(y="y", training_frame=tf)
    d1 = th.XGBoost(ntrees=1, booster="dart").train(y="y", training_frame=tf)
    with pytest.raises(ValueError, match="dart"):
        th.XGBoost(ntrees=2, booster="dart", checkpoint=d1).train(
            y="y", training_frame=tf)
    with pytest.raises(ValueError):
        th.GBM(not_a_param=1)
    _, tv = both_frames(train_cols(n=64, seed=3))
    runs = ({"sample_rate": 0.5}, {"col_sample_rate": 0.5},
            {"col_sample_rate_per_tree": 0.5}, {"stopping_rounds": 2},
            {"stopping_rounds": 1, "stopping_tolerance": 0.1},
            {"max_runtime_secs": 60.0}, {"distribution": "quasibinomial"},
            {"sample_rate": 1.0})
    for kw in runs:
        m = th.GBM(ntrees=2, **kw).train(y="y", training_frame=tf,
                                         validation_frame=tv)
        assert m._output.validation_metrics is not None, kw
    _, tr = both_frames(train_cols(n=100, gaussian=True))
    for dist in ("poisson", "gamma", "tweedie", "laplace", "quantile",
                 "huber"):
        yy = np.abs(tr.col("y").to_numpy()) + 0.1
        fr = th.Frame()
        fr.add("x", tr.col("x")).add("g", tr.col("g"))
        fr.add("o", th.Column.from_numpy(np.zeros(100)))
        fr.add("y", th.Column.from_numpy(yy))
        m = th.GBM(ntrees=2, distribution=dist, offset_column="o").train(
            y="y", training_frame=fr)
        assert np.isfinite(m._output.training_metrics.rmse), dist


_BUILDERS = {
    "GBM": ("h2o3_tpu.models.tree.gbm", "GBM"),
    "DRF": ("h2o3_tpu.models.tree.drf", "DRF"),
    "XGBoost": ("h2o3_tpu.models.xgboost", "XGBoost"),
    "IsolationForest": ("h2o3_tpu.models.tree.isofor", "IsolationForest"),
    "ExtendedIsolationForest": ("h2o3_tpu.models.extended_isofor",
                                "ExtendedIsolationForest"),
    "GLM": ("h2o3_tpu.models.glm", "GLM"),
    "GAM": ("h2o3_tpu.models.gam", "GAM"),
    "RuleFit": ("h2o3_tpu.models.rulefit", "RuleFit"),
    "DeepLearning": ("h2o3_tpu.models.deeplearning", "DeepLearning"),
}


@pytest.mark.parametrize("name", sorted(_BUILDERS))
def test_every_reference_default_is_accepted(cl, name):
    """ROADMAP C9: each ported builder constructs with every key of the
    reference builder's default_params() at its default value, and
    stopping_metric, categorical_encoding (and the trees' huber_alpha)
    at any value."""
    import importlib

    mod, cls = _BUILDERS[name]
    ref = getattr(importlib.import_module(mod), cls).default_params()
    port = getattr(th, name)
    b = port(**ref)
    for k, v in ref.items():
        if k in b.params and v is not None:
            assert b.params[k] == v, k
    extra = {"stopping_metric": "logloss", "categorical_encoding": "Enum"}
    if "huber_alpha" in ref:
        extra["huber_alpha"] = 0.5
    assert port(**extra).params["stopping_metric"] == "logloss"
    if name == "GBM":
        _, tf = both_frames(train_cols(n=128))
        m = th.GBM(**dict(ref, ntrees=1)).train(y="y", training_frame=tf)
        assert m.forest.n_trees == 1


def test_training_is_deterministic_on_the_cpu():
    th.init(device="cpu")
    _, tf = both_frames(train_cols(seed=4, n=2000))
    a = th.GBM(ntrees=3, max_depth=4).train(y="y", training_frame=tf)
    b = th.GBM(ntrees=3, max_depth=4).train(y="y", training_frame=tf)
    assert np.array_equal(a.forest.leaf_val, b.forest.leaf_val)
    assert torch.equal(a.predict(tf).col("Y").data,
                       b.predict(tf).col("Y").data)
