"""Checkpoint continuation in the port against the JAX package's, on the
CPU: GBM (binomial and multinomial), DRF, XGBoost gbtree and
DeepLearning. Each package continues its own first model, whose
structure the other tests hold equal, so the two continuations start
from the same forest or weights.

Tolerances: the continued forest's structure equal, leaf values and
predictions to 1e-5 (tree families; DRF's leaves are rescaled by
n_old / n_total in float32); DeepLearning predictions to 1e-4 (its
short-train bar). The same ValueErrors, at the same point."""

import numpy as np
import pytest

import h2o3_tpu_torch as th

from torch_port_support import (both_frames, dl_cols, forest_arrays,
                                train_cols)


def _ref(name):
    import importlib

    mod, cls = {"GBM": ("h2o3_tpu.models.tree.gbm", "GBM"),
                "DRF": ("h2o3_tpu.models.tree.drf", "DRF"),
                "XGBoost": ("h2o3_tpu.models.xgboost", "XGBoost"),
                "DeepLearning": ("h2o3_tpu.models.deeplearning",
                                 "DeepLearning")}[name]
    return getattr(importlib.import_module(mod), cls)


def _multinomial_cols(n=384, seed=6):
    cols = train_cols(n=n, seed=seed)
    rng = np.random.default_rng(seed)
    x = cols["x"][0]
    k = np.digitize(x + 0.3 * rng.standard_normal(n), [-0.5, 0.5])
    cols["y"] = (np.array(["p", "q", "r"], object)[k], "enum")
    return cols


CASES = {
    "gbm_binomial": ("GBM", train_cols(n=384, seed=3),
                     dict(max_depth=3, seed=3, learn_rate_annealing=0.9)),
    "gbm_multinomial": ("GBM", _multinomial_cols(),
                        dict(max_depth=3, seed=4, sample_rate=0.8)),
    "drf": ("DRF", train_cols(n=384, seed=8),
            dict(max_depth=6, seed=8)),
    "xgboost": ("XGBoost", train_cols(n=384, seed=9, gaussian=True),
                dict(max_depth=3, seed=9, nbins=16,
                     min_split_improvement=1e-4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tree_checkpoint_matches_jax(cl, monkeypatch, case):
    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    name, cols, kw = CASES[case]
    jf, tf = both_frames(cols)
    J, T = _ref(name), getattr(th, name)
    j1 = J(ntrees=2, **kw).train(y="y", training_frame=jf)
    t1 = T(ntrees=2, **kw).train(y="y", training_frame=tf)
    j2 = J(ntrees=4, checkpoint=j1, **kw).train(y="y", training_frame=jf)
    t2 = T(ntrees=4, checkpoint=t1, **kw).train(y="y", training_frame=tf)
    a, b = forest_arrays(j2.forest), forest_arrays(t2.forest)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert t2.forest.n_trees == j2.forest.n_trees == \
        4 * (3 if case == "gbm_multinomial" else 1)
    np.testing.assert_allclose(t2.forest.leaf_val,
                               np.asarray(j2.forest.leaf_val), atol=1e-5)
    n = tf.nrows
    jp, tp = j2.predict(jf), t2.predict(tf)
    for c in tp.names:
        if c != "predict" or case == "xgboost":
            np.testing.assert_allclose(tp.col(c).to_numpy(),
                                       jp.col(c).to_numpy()[:n], atol=1e-5,
                                       err_msg=c)
    # split gains accumulate onto the checkpoint's raw importances
    assert sorted(t2._varimp_raw) == sorted(j2._varimp_raw)
    for k in j2._varimp_raw:
        assert t2._varimp_raw[k] == pytest.approx(j2._varimp_raw[k],
                                                  rel=1e-4), k
    # the first model is left as it was
    assert t1.forest.n_trees == j1.forest.n_trees


def test_gbm_continuation_is_a_longer_train(cl):
    """2 + 2 trees from a checkpoint grow the 4-tree model's forest (no
    sampling, so the continued run's draws do not matter)."""
    th.init(device="cpu")
    _, tf = both_frames(train_cols(n=300, seed=12))
    kw = dict(max_depth=3, seed=1)
    m4 = th.GBM(ntrees=4, **kw).train(y="y", training_frame=tf)
    m2 = th.GBM(ntrees=2, **kw).train(y="y", training_frame=tf)
    mc = th.GBM(ntrees=4, checkpoint=m2, **kw).train(y="y",
                                                     training_frame=tf)
    a, b = forest_arrays(m4.forest), forest_arrays(mc.forest)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(mc.forest.leaf_val, m4.forest.leaf_val,
                               atol=1e-6)
    assert mc._output.scoring_history[-1]["tree"] == 4


def test_deeplearning_checkpoint_matches_jax(cl):
    jf, tf = both_frames(dl_cols("binomial", n=640, seed=4))
    J = _ref("DeepLearning")
    kw = dict(hidden=[16, 16], seed=5)
    j1 = J(epochs=1, **kw).train(y="y", training_frame=jf)
    t1 = th.DeepLearning(epochs=1, **kw).train(y="y", training_frame=tf)
    j2 = J(epochs=3, checkpoint=j1, **kw).train(y="y", training_frame=jf)
    t2 = th.DeepLearning(epochs=3, checkpoint=t1, **kw).train(
        y="y", training_frame=tf)
    assert t2.epochs_trained == j2.epochs_trained == 3
    assert [h["epoch"] for h in t2._output.scoring_history] == [2, 3]
    np.testing.assert_allclose(t2.predict(tf).col("Y").to_numpy(),
                               j2.predict(jf).col("Y").to_numpy()[:640],
                               atol=1e-4)
    assert t2.data_info is t1.data_info


def test_checkpoint_guards_match_jax(cl):
    jf, tf = both_frames(train_cols(n=128, seed=2))
    jg, tg = both_frames(train_cols(n=128, seed=2, gaussian=True))
    refs = {}
    for lib, fr, G, D, X, DL in (
            ("j", jf, _ref("GBM"), _ref("DRF"), _ref("XGBoost"),
             _ref("DeepLearning")),
            ("t", tf, th.GBM, th.DRF, th.XGBoost, th.DeepLearning)):
        refs[lib] = dict(
            fr=fr, G=G, D=D, X=X, DL=DL,
            g2=G(ntrees=2, max_depth=2, seed=1).train(y="y",
                                                     training_frame=fr),
            dl=DL(hidden=[4], epochs=2, seed=1).train(y="y",
                                                      training_frame=fr))
    checks = [
        (lambda r: r["G"](ntrees=2, max_depth=2, seed=1,
                          checkpoint=r["g2"]), "must be greater"),
        (lambda r: r["G"](ntrees=3, max_depth=4, seed=1,
                          checkpoint=r["g2"]), "cannot be modified"),
        (lambda r: r["D"](ntrees=3, checkpoint=r["g2"]), "not a drf"),
        (lambda r: r["X"](ntrees=3, booster="dart",
                          checkpoint=r["X"](ntrees=1, booster="dart").train(
                              y="y", training_frame=r["fr"])),
         "dart"),
        (lambda r: r["DL"](hidden=[4], epochs=2, seed=1,
                           checkpoint=r["dl"]), "must be greater"),
        (lambda r: r["DL"](hidden=[5], epochs=3, seed=1,
                           checkpoint=r["dl"]), "cannot be modified"),
    ]
    for make, msg in checks:
        for lib in ("j", "t"):
            r = refs[lib]
            with pytest.raises(ValueError, match=msg):
                make(r).train(y="y", training_frame=r["fr"])
    # a regression frame for a classifier's forest: the names match, the
    # response's type does not
    for lib, fr in (("j", jg), ("t", tg)):
        r = refs[lib]
        with pytest.raises(ValueError):
            r["G"](ntrees=3, max_depth=2, seed=1, checkpoint=r["g2"],
                   distribution="gaussian").train(y="y", training_frame=fr)


def test_checkpoint_by_key_waits_for_the_dkv(cl, monkeypatch):
    """Trained models live in the DKV under their keys, so a checkpoint
    named by its key continues that model: the same forest as passing
    the Model, and the reference's continuation by key; an unknown key
    raises the reference's ValueError in both packages. IsolationForest
    takes no checkpoint at all."""
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    jf, tf = both_frames(train_cols(n=128))
    kw = dict(max_depth=3, seed=1)
    j1 = JGBM(ntrees=2, **kw).train(y="y", training_frame=jf)
    t1 = th.GBM(ntrees=2, **kw).train(y="y", training_frame=tf)
    assert th.DKV.get(t1.key) is t1
    jk = JGBM(ntrees=4, checkpoint=str(j1.key), **kw).train(
        y="y", training_frame=jf)
    tk = th.GBM(ntrees=4, checkpoint=t1.key, **kw).train(y="y",
                                                         training_frame=tf)
    tm = th.GBM(ntrees=4, checkpoint=t1, **kw).train(y="y",
                                                     training_frame=tf)
    a, b, c = (forest_arrays(m.forest) for m in (jk, tk, tm))
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        np.testing.assert_array_equal(b[k], c[k], err_msg=k)
    np.testing.assert_allclose(tk.forest.leaf_val,
                               np.asarray(jk.forest.leaf_val), atol=1e-5)
    for G, fr in ((JGBM, jf), (th.GBM, tf)):
        with pytest.raises(ValueError, match="not found"):
            G(ntrees=2, checkpoint="GBMModel_abc").train(y="y",
                                                         training_frame=fr)
    with pytest.raises(ValueError, match="does not support checkpoint"):
        th.IsolationForest(ntrees=2, checkpoint="x").train(training_frame=tf)
