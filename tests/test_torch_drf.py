"""DRF in the port (on the CPU) against the JAX package run through its
Pallas histogram kernel in interpret mode: binomial, regression,
multinomial and binomial_double_trees at the default sample_rate
(0.632) and mtries, one case at depth 12 (deep packed tables go to the
host), a validation frame with early stopping, the per-node feature
draws bitwise, and JAX-trained forests carried across (bitwise
margins).

Tolerances: forest structure equal (0/1 and class responses with unit
weights, and the fixture's float regression response); training metrics
(out-of-bag) and the scoring history rtol 1e-5; predictions and leaf
values atol 1e-5. Two candidate splits whose gains tie exactly (mirror
images on a class indicator) are told apart by rounding alone, and the
packages can pick different ones: `test_exact_gain_ties_break_by_
rounding` shows it (ROADMAP C6)."""

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert

from test_torch_gbm_surface import (assert_history_close,
                                    assert_metrics_close,
                                    assert_models_match, carry, class_cols,
                                    fit_both, reg_cols)
from torch_port_support import both_frames, train_cols


def fit_drf(monkeypatch, cols, valid=None, **kw):
    from h2o3_tpu.models.tree.drf import DRF as JDRF

    return fit_both(monkeypatch, cols, valid=valid, jax_cls=JDRF,
                    port_cls=th.DRF, **kw)


_CASES = {
    "binomial": (lambda: train_cols(n=640), {}),
    "regression": (lambda: reg_cols(), {}),
    "multinomial": (lambda: class_cols(), {}),
    "binomial_double_trees": (lambda: train_cols(n=640, seed=3),
                              {"binomial_double_trees": True}),
    "binomial_depth12": (lambda: train_cols(n=1280, seed=9),
                         {"max_depth": 12, "ntrees": 2}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_drf_matches_jax(cl, monkeypatch, case):
    make, extra = _CASES[case]
    kw = dict(ntrees=3, max_depth=6, seed=3) | extra
    jm, tm, jf, tf = fit_drf(monkeypatch, make(), **kw)
    assert_models_match(jm, tm, jf, tf)
    # training metrics are out of bag: some rows were in every bag
    assert tm._output.training_metrics.nobs < tf.nrows
    if case == "binomial_double_trees":
        assert tm.forest.per_class_trees and tm.forest.n_margins == 2
    if case == "binomial_depth12":
        assert tm.forest.max_depth == 12


def test_exact_gain_ties_break_by_rounding(cl, monkeypatch):
    """On this 4-class fixture one node has two thresholds of one feature
    that cut the same class counts in mirror image (14 + 4 rows either
    way), so their gains are equal in exact arithmetic. The histograms'
    rounding differs (8 f32 shard partials in the JAX package, exact
    int64 sums in the port) and so does the threshold picked; everything
    before that node is equal (ROADMAP C6)."""
    jm, tm, _, _ = fit_drf(monkeypatch, class_cols(seed=4, K=4), ntrees=3,
                           max_depth=6, seed=3, mtries=2, min_rows=3.0)
    a = {k: np.asarray(getattr(jm.forest, k)) for k in
         ("feat", "thresh_bin", "left", "right", "gain", "cover")}
    b = {k: np.asarray(getattr(tm.forest, k)) for k in a}
    differ = (a["feat"] != b["feat"]) | (a["thresh_bin"] != b["thresh_bin"])
    assert differ.any(), "this fixture shows the divergence"
    t, m = np.argwhere(differ)[0]
    for k in ("feat", "thresh_bin", "left", "right", "cover"):
        np.testing.assert_array_equal(b[k][:t], a[k][:t], err_msg=k)
    assert a["feat"][t, m] == b["feat"][t, m] >= 0
    assert a["thresh_bin"][t, m] != b["thresh_bin"][t, m]
    assert b["gain"][t, m] == pytest.approx(a["gain"][t, m], rel=1e-5)
    kids = [sorted([x["cover"][t, x["left"][t, m]],
                    x["cover"][t, x["right"][t, m]]]) for x in (a, b)]
    assert kids[0] == kids[1]


def test_drf_validation_frame_and_early_stopping_match_jax(cl, monkeypatch):
    valid = {k: (v[:320], c) for k, (v, c) in train_cols(n=640,
                                                          seed=2).items()}
    kw = dict(ntrees=20, max_depth=5, seed=3, stopping_rounds=2,
              stopping_tolerance=0.05, score_tree_interval=1)
    jm, tm, jf, tf = fit_drf(monkeypatch, train_cols(n=640, seed=1),
                             valid=valid, **kw)
    assert_models_match(jm, tm, jf, tf)
    assert tm.forest.n_trees < 20, "the fixture should stop early"
    assert "validation_rmse" in tm._output.scoring_history[-1]
    assert_metrics_close(jm._output.validation_metrics,
                         tm._output.validation_metrics, "Binomial")
    assert_history_close(jm, tm)


def test_node_feature_draws_bitwise_vs_jax():
    from h2o3_tpu.models.tree import drf as jdrf
    from h2o3_tpu.models.tree import device_tree as jdt
    from h2o3_tpu_torch.models.tree import device_tree as tdt
    from h2o3_tpu_torch.models.tree import drf as tdrf

    for F, mtries in ((6, 2), (10, 3), (1, 1)):
        jr, tr = np.random.default_rng(F), np.random.default_rng(F)
        jfn = jdrf._node_feat_mask_fn(jr, F, mtries)
        tfn = tdrf._node_feat_mask_fn(tr, F, mtries)
        for _ in range(3):
            jm = jdt.build_feat_masks(6, jfn, F, 21)
            tm = tdt.build_feat_masks(6, tfn, F, 21)
            for a, b in zip(tm, jm):
                np.testing.assert_array_equal(a, b)
                assert (a.sum(axis=1) == mtries).all()
    assert th.DRF()._mtries(6, True) == 2
    assert th.DRF()._mtries(6, False) == 2
    assert th.DRF()._mtries(10, False) == 3
    assert th.DRF(mtries=20)._mtries(6, True) == 6


@pytest.mark.parametrize("make,extra", [
    (lambda: train_cols(n=640, seed=12), {}),
    (lambda: class_cols(seed=13), {}),
    (lambda: train_cols(n=640, seed=14), {"binomial_double_trees": True})],
    ids=["binomial", "multinomial", "double_trees"])
def test_jax_drf_carried_across_scores_bitwise(cl, make, extra):
    from h2o3_tpu.models.tree.drf import DRF as JDRF

    jf, tf = both_frames(make())
    jm = JDRF(ntrees=3, max_depth=6, seed=2, **extra).train(
        y="y", training_frame=jf)
    tm = convert.drf_model_from_numpy(carry(jm))
    n = tf.nrows
    jmarg = np.asarray(jm.forest.predict_binned(jm.spec.bin_columns(jf)))[:n]
    tmarg = tm.forest.predict_binned(tm.spec.bin_columns(tf)).numpy()
    assert tmarg.tobytes() == jmarg.tobytes(), "margins differ"
    assert tm._margin(tm.adapt_test(tf)).numpy().tobytes() == jmarg.tobytes()
    jp, tp = jm.predict(jf), tm.predict(tf)
    assert tp.names == jp.names
    for c in tp.names[1:]:
        np.testing.assert_allclose(tp.col(c).to_numpy(),
                                   jp.col(c).to_numpy()[:n], atol=1e-6)
