"""IsolationForest in the port (on the CPU) against the JAX package on
the same numpy fixtures: uniform bins, the level-wise count histogram,
host draws in the reference's order.

Tolerances: the forest arrays (structure, categorical tables and leaf
path lengths) bitwise: the node counts are integers, exact in both
histograms, and every random draw is the same numpy call. The summed
path lengths and `mean_length` are bitwise for one forest; scores agree
to 1e-6 (XLA's exp2 and torch's can differ in the last bit)."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.models.tree import hist_gather as hg
from h2o3_tpu_torch.models.tree.isofor import _avg_path

from torch_port_support import both_frames, forest_arrays


def if_cols(n=640, seed=0, n_num=3, outliers=0.0):
    """n_num NaN-laced normals and a 4-level categorical; with
    `outliers`, that share of rows moved 6 sigma out on every numeric."""
    rng = np.random.default_rng(seed)
    cols = {}
    moved = rng.random(n) < outliers
    for i in range(n_num):
        x = rng.standard_normal(n) + 6.0 * moved
        x[rng.random(n) < 0.05] = np.nan
        cols[f"n{i}"] = (x, None)
    cols["g"] = (np.array(list("abcd"), object)[rng.integers(0, 4, n)],
                 "enum")
    return cols, moved


def fit_both(cols, **kw):
    from h2o3_tpu.models.tree.isofor import IsolationForest as JIF

    jf, tf = both_frames(cols)
    jm = JIF(**kw).train(training_frame=jf)
    tm = th.IsolationForest(**kw).train(training_frame=tf)
    return jm, tm, jf, tf


def assert_same_forest(jm, tm):
    a, b = forest_arrays(jm.forest), forest_arrays(tm.forest)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert tm.forest.leaf_val.tobytes() == \
        np.asarray(jm.forest.leaf_val).tobytes()
    np.testing.assert_array_equal(tm.forest.cover, jm.forest.cover)
    assert tm._parms["_cnorm"] == jm._parms["_cnorm"]


def assert_scores_close(jm, tm, jf, tf):
    n = tf.nrows
    jp, tp = jm.predict(jf), tm.predict(tf)
    assert tp.names == jp.names == ["predict", "mean_length"]
    for c in tp.names:
        np.testing.assert_allclose(tp.col(c).to_numpy(),
                                   jp.col(c).to_numpy()[:n], rtol=1e-6,
                                   atol=1e-6, err_msg=c)
    return tp


_CASES = {
    "defaults": (1, {}),
    "mtries": (2, {"mtries": 2, "max_depth": 6}),
    "sample_rate": (3, {"sample_rate": 0.2, "ntrees": 4}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_isolation_forest_matches_jax(cl, case):
    seed, extra = _CASES[case]
    kw = dict(ntrees=6, seed=seed) | extra
    jm, tm, jf, tf = fit_both(if_cols(seed=seed)[0], **kw)
    assert_same_forest(jm, tm)
    assert tm._output.model_category == "AnomalyDetection"
    assert tm._output.training_metrics is None
    assert tm.forest.cat_split.max() >= 0, "fixture splits a categorical"
    tp = assert_scores_close(jm, tm, jf, tf)
    s = tp.col("predict").to_numpy()
    assert ((s > 0) & (s < 1)).all()


def test_outliers_score_higher_and_one_histogram_per_level(cl,
                                                         monkeypatch):
    """Rows moved 6 sigma out isolate sooner: their mean score is above
    the rest. Every level a tree grows builds one histogram (one kernel
    launch on the card; on the CPU the wrapper runs its plain version and
    counts no launch)."""
    from h2o3_tpu_torch.models.tree import isofor

    calls = []
    build = isofor.build_histogram
    monkeypatch.setattr(isofor, "build_histogram",
                        lambda *a: calls.append(a[-1]) or build(*a))
    cols, moved = if_cols(n=1280, seed=9, outliers=0.02)
    _, tf = both_frames(cols)
    hg.launches = 0
    m = th.IsolationForest(ntrees=10, seed=9).train(training_frame=tf)
    assert hg.launches == 0
    depths = m.forest.depths()
    assert len(calls) == int((depths + 1).sum())
    assert depths.max() == m.forest.max_depth == 8
    assert max(calls) <= 2 ** 8
    s = m.predict(tf).col("predict").to_numpy()
    assert s[moved].mean() > s[~moved].mean() + 0.1


def test_avg_path_matches_jax():
    from h2o3_tpu.models.tree.isofor import _avg_path as j_avg_path

    for n in (0, 1, 2, 3, 10, 255, 256, 1e6):
        assert _avg_path(n) == j_avg_path(n)


def carry_isofor(jm):
    fo, sp, o = jm.forest, jm.spec, jm._output
    forest = {k: np.asarray(getattr(fo, k)) for k in
              ("feat", "thresh_bin", "na_left", "left", "right", "leaf_val",
               "cat_split", "cat_table", "tree_class", "na_bins")}
    forest |= {"max_depth": fo.max_depth, "init_f": fo.init_f,
               "nclasses": fo.nclasses}
    return {"forest": forest,
            "spec": {"names": list(sp.names), "is_cat": np.asarray(sp.is_cat),
                     "nbins": np.asarray(sp.nbins),
                     "edges": [np.asarray(e) for e in sp.edges],
                     "cards": np.asarray(sp.cards)},
            "output": {"names": list(o.names), "domains": dict(o.domains),
                       "model_category": o.model_category},
            "cnorm": jm._parms["_cnorm"]}


def test_jax_isolation_forest_carried_across_scores_bitwise(cl):
    from h2o3_tpu.models.tree.isofor import IsolationForest as JIF

    jf, tf = both_frames(if_cols(seed=21)[0])
    jm = JIF(ntrees=5, seed=21).train(training_frame=jf)
    tm = convert.isofor_model_from_numpy(carry_isofor(jm))
    n = tf.nrows
    jt = np.asarray(jm._margin(jm.adapt_test(jf)))[:n]
    tt = tm._margin(tm.adapt_test(tf)).numpy()
    assert tt.tobytes() == jt.tobytes(), "summed path lengths differ"
    jp, tp = jm.predict(jf), tm.predict(tf)
    assert tp.col("mean_length").to_numpy().tobytes() == \
        jp.col("mean_length").to_numpy()[:n].tobytes()
    np.testing.assert_allclose(tp.col("predict").to_numpy(),
                               jp.col("predict").to_numpy()[:n], rtol=2e-7,
                               atol=0)


def test_isolation_forest_takes_no_response_and_scores_a_new_frame(cl):
    cols, _ = if_cols(seed=4)
    _, tf = both_frames(cols)
    m = th.IsolationForest(ntrees=3, seed=4, max_depth=4).train(
        x=["n0", "g"], training_frame=tf)
    assert m._output.names == ["n0", "g"]
    test_cols, _ = if_cols(n=128, seed=5)
    _, test = both_frames({k: test_cols[k] for k in ("g", "n0")})
    p = m.predict(test)
    assert p.nrows == 128
    assert torch.isfinite(p.col("predict").data).all()
