"""XGBoost in the port (on the CPU) against the JAX package run through
its Pallas histogram kernel in interpret mode: parameter names and
defaults, boosters gbtree and dart, L1/L2 leaf regularisation,
validation stopping, the booster checks, and a JAX-trained model
carried across.

Tolerances are those of the GBM tests: forest structure equal, leaf
values and predictions atol 1e-5, metrics and the scoring history rtol
1e-5. XGBoost's default gamma (min_split_improvement) is 0, so a node
whose rows all carry one residual splits wherever rounding noise in
`wyy - wy^2/w` is largest, and the two packages round apart: the
structural cases set gamma 1e-4, above that noise, and
`test_default_gamma_splits_on_rounding_noise` shows the divergence at
gamma 0 (ROADMAP C7)."""

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert

from test_torch_gbm_surface import (assert_history_close,
                                    assert_models_match,
                                    assert_predictions_close,
                                    assert_same_forest, carry, class_cols,
                                    fit_both, reg_cols)
from torch_port_support import both_frames, forest_arrays, train_cols

GAMMA = 1e-4


def fit_xgb(monkeypatch, cols, valid=None, **kw):
    from h2o3_tpu.models.xgboost import XGBoost as JXGB

    return fit_both(monkeypatch, cols, valid=valid, jax_cls=JXGB,
                    port_cls=th.XGBoost, **kw)


def test_defaults_and_aliases_match_jax(cl):
    from h2o3_tpu.models import xgboost as jx

    from h2o3_tpu_torch.models import xgboost as tx

    assert tx._ALIASES == jx._ALIASES
    jd, td = jx.XGBoost.default_params(), tx.XGBoost.default_params()
    for k, v in td.items():
        if k in jd:
            assert v == jd[k], k
    for k in ("learn_rate", "max_depth", "nbins", "min_rows", "reg_lambda",
              "reg_alpha", "booster", "rate_drop", "skip_drop",
              "min_split_improvement", "tree_method"):
        assert td[k] == jd[k], k
    assert (td["learn_rate"], td["max_depth"], td["nbins"]) == (0.3, 6, 256)
    m = th.XGBoost(eta=0.05, n_estimators=7, subsample=0.5, max_bins=32,
                   colsample_bytree=0.9, colsample_bylevel=0.8,
                   min_child_weight=3, gamma=0.1)
    assert (m.params["learn_rate"], m.params["ntrees"],
            m.params["sample_rate"], m.params["nbins"],
            m.params["col_sample_rate_per_tree"],
            m.params["col_sample_rate"], m.params["min_rows"],
            m.params["min_split_improvement"]) == (0.05, 7, 0.5, 32, 0.9,
                                                   0.8, 3, 0.1)
    for name in jx._ALIASES:
        assert th.XGBoost.translate_param(name) == \
            jx.XGBoost.translate_param(name)
    assert th.XGBoost.translate_param("reg_lambda") == "reg_lambda"


_CASES = {
    "bernoulli": (lambda: train_cols(n=640), {}),
    "gaussian": (lambda: reg_cols(), {}),
    # nodes of 3 rows tie exactly on several thresholds (ROADMAP C6):
    # min_child_weight keeps the trees above them
    "multinomial": (lambda: class_cols(), {"ntrees": 2,
                                           "min_child_weight": 10}),
    "reg_alpha": (lambda: train_cols(n=640, seed=3),
                  {"reg_alpha": 0.5, "reg_lambda": 2.0}),
    "sampling": (lambda: train_cols(n=640, seed=4),
                 {"subsample": 0.7, "colsample_bylevel": 0.6, "seed": 5}),
    "default_bins": (lambda: train_cols(n=640, seed=6),
                     {"nbins": 256, "max_depth": 3, "ntrees": 2}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_gbtree_matches_jax(cl, monkeypatch, case):
    make, extra = _CASES[case]
    kw = dict(ntrees=3, nbins=32, gamma=GAMMA, seed=1) | extra
    jm, tm, jf, tf = fit_xgb(monkeypatch, make(), **kw)
    assert_models_match(jm, tm, jf, tf)
    assert tm.algo_name == "xgboost"
    if case == "default_bins":
        assert int(tm.spec.nbins.max()) == 257
        assert tm.spec.bin_columns(tf).dtype.itemsize == 2   # int16


@pytest.mark.parametrize("make", [lambda: train_cols(n=640, seed=8),
                                  lambda: reg_cols(seed=9)],
                         ids=["bernoulli", "gaussian"])
def test_dart_matches_jax(cl, monkeypatch, make):
    """rate_drop 0.3 and skip_drop 0.2: the same trees dropped each
    iteration (the scoring history's "dropped"), the same forest, the
    rescaled leaf values and predictions to 1e-5."""
    kw = dict(booster="dart", rate_drop=0.3, skip_drop=0.2, ntrees=6,
              nbins=16, gamma=GAMMA, seed=4, score_each_iteration=True)
    jm, tm, jf, tf = fit_xgb(monkeypatch, make(), **kw)
    dropped = [e["dropped"] for e in tm._output.scoring_history]
    assert dropped == [e["dropped"] for e in jm._output.scoring_history]
    assert sum(dropped) > 0, "fixture should drop trees"
    assert_models_match(jm, tm, jf, tf)


def test_dart_without_drops_is_gbtree_bitwise(cl):
    _, tf = both_frames(train_cols(n=640, seed=10))
    kw = dict(ntrees=4, nbins=16, seed=2, max_depth=4)
    g = th.XGBoost(**kw).train(y="y", training_frame=tf)
    d = th.XGBoost(booster="dart", rate_drop=0.0, **kw).train(
        y="y", training_frame=tf)
    a, b = forest_arrays(g.forest), forest_arrays(d.forest)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert d.forest.leaf_val.tobytes() == g.forest.leaf_val.tobytes()
    pg, pd = g.predict(tf), d.predict(tf)
    assert pd.col("Y").to_numpy().tobytes() == pg.col("Y").to_numpy().tobytes()


@pytest.mark.parametrize("booster", ["gbtree", "dart"])
def test_validation_stopping_matches_jax(cl, monkeypatch, booster):
    """A validation frame with stopping_rounds: the same validation
    deviance history and the same stopping tree."""
    extra = ({"rate_drop": 0.2} if booster == "dart" else {})
    kw = dict(booster=booster, ntrees=30, nbins=16, gamma=GAMMA,
              max_depth=4, eta=0.5, stopping_rounds=2,
              stopping_tolerance=0.01, seed=7) | extra
    jm, tm, jf, tf = fit_xgb(monkeypatch, train_cols(n=640, seed=11),
                             valid=train_cols(n=256, seed=12), **kw)
    assert tm.forest.n_trees == jm.forest.n_trees < 30
    assert_same_forest(jm, tm)
    assert_history_close(jm, tm)
    assert "validation_deviance" in tm._output.scoring_history[-1]
    assert_predictions_close(jm, tm, jf, tf)


def test_booster_checks(cl):
    _, tf = both_frames(class_cols(n=256))
    with pytest.raises(ValueError, match="unknown booster"):
        th.XGBoost(booster="linear", ntrees=1).train(y="y", training_frame=tf)
    with pytest.raises(ValueError, match="binomial/regression"):
        th.XGBoost(booster="dart", ntrees=1).train(y="y", training_frame=tf)
    # gblinear trains the port's GLM (a multinomial one here)
    m = th.XGBoost(booster="gblinear").train(y="y", training_frame=tf)
    assert isinstance(m, th.GLMModel) and m.linkname == "multinomial"
    assert m._parms["booster"] == "gblinear"
    with pytest.raises(ValueError, match="unknown"):
        th.XGBoost(not_a_parameter=1)


_GBLINEAR = {
    "binomial": (lambda: train_cols(n=640), {}),
    "gaussian_l1": (lambda: reg_cols(), {"reg_alpha": 0.5,
                                         "reg_lambda": 2.0}),
    "multinomial": (lambda: class_cols(), {"reg_lambda": 5.0}),
    "ridge_only": (lambda: train_cols(n=640, seed=3), {"reg_lambda": 50.0}),
}


@pytest.mark.parametrize("case", sorted(_GBLINEAR))
def test_gblinear_matches_jax(cl, monkeypatch, case):
    """booster='gblinear' is the elastic-net GLM with alpha = reg_alpha /
    (reg_alpha + reg_lambda) and lambda = (reg_alpha + reg_lambda) /
    rows, in both packages: coefficients and predictions atol 1e-5 +
    rtol 1e-5 (the GLM tests' tolerances)."""
    make, kw = _GBLINEAR[case]
    jm, tm, jf, tf = fit_xgb(monkeypatch, make(), booster="gblinear", **kw)
    assert type(tm).__name__ == type(jm).__name__ == "GLMModel"
    assert tm.linkname == jm.linkname
    assert tm.iterations == jm.iterations
    jc, tc = jm.coef(), tm.coef()
    assert list(tc) == list(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    n = tf.nrows
    jp, tp = jm.predict(jf), tm.predict(tf)
    assert tp.names == jp.names
    for c in tp.names:
        if not tp.col(c).is_categorical:
            np.testing.assert_allclose(tp.col(c).to_numpy(),
                                       jp.col(c).to_numpy()[:n], rtol=1e-5,
                                       atol=1e-5, err_msg=c)


def test_default_gamma_splits_on_rounding_noise(cl, monkeypatch):
    """At gamma 0 a node of one residual value (gain exactly 0) splits on
    rounding noise: here both packages split such a node (gain < 1e-6 in
    both) on different features. Every node before it is equal
    (ROADMAP C7)."""
    jm, tm, _, _ = fit_xgb(monkeypatch, train_cols(n=640), ntrees=1,
                           nbins=32, seed=1)
    a = {k: np.asarray(getattr(jm.forest, k)) for k in
         ("feat", "thresh_bin", "gain", "cover")}
    b = {k: np.asarray(getattr(tm.forest, k)) for k in a}
    M = min(a["feat"].shape[1], b["feat"].shape[1])
    differ = (a["feat"][0, :M] != b["feat"][0, :M]) | \
        (a["thresh_bin"][0, :M] != b["thresh_bin"][0, :M])
    assert differ.any(), "this fixture shows the divergence"
    m = int(np.argmax(differ))
    for k in ("feat", "thresh_bin", "cover"):
        np.testing.assert_array_equal(b[k][0, :m], a[k][0, :m], err_msg=k)
    np.testing.assert_allclose(b["gain"][0, :m], a["gain"][0, :m], rtol=1e-5)
    assert a["feat"][0, m] >= 0 and b["feat"][0, m] >= 0
    assert 0 < a["gain"][0, m] < 1e-6 and 0 < b["gain"][0, m] < 1e-6
    assert a["cover"][0, m] == b["cover"][0, m]


def test_jax_xgboost_carried_across_scores_bitwise(cl):
    from h2o3_tpu.models.xgboost import XGBoost as JXGB

    jf, tf = both_frames(train_cols(n=640, seed=14))
    jm = JXGB(ntrees=3, nbins=16, max_depth=4, seed=2).train(
        y="y", training_frame=jf)
    tm = convert.xgboost_model_from_numpy(carry(jm))
    n = tf.nrows
    jmarg = np.asarray(jm.forest.predict_binned(jm.spec.bin_columns(jf)))[:n]
    assert tm._margin(tm.adapt_test(tf)).numpy().tobytes() == \
        jmarg.tobytes()
    assert tm.algo_name == "xgboost"
