"""NaiveBayes in the port (on the CPU) against the JAX package on the
same numpy fixtures: binomial and multinomial responses, Laplace
smoothing, the probability and sdev floors, NAs in predictors and in
the response, weights, and scoring with an unseen level.

Tolerances:
- priors and the categorical tables exactly equal: both count unit
  (or small integer) weights, exact in float32 and float64;
- per-class means and standard deviations rtol 1e-6 (the reference
  sums x and x² in float32 on its test mesh, the port in float64);
- probabilities atol 1e-6, AUC and logloss rtol 1e-6.
Row counts are multiples of 64, so the JAX package pads no rows."""

import numpy as np
import pytest

import h2o3_tpu_torch as th

from torch_port_support import both_frames, dl_cols, flagship_cols


def _with_na(cols, seed=9):
    rng = np.random.default_rng(seed)
    out = dict(cols)
    x, _ = out["n0"]
    x = x.copy()
    x[rng.random(len(x)) < 0.1] = np.nan
    out["n0"] = (x, None)
    g, t = out["c0"]
    g = g.astype(object).copy()
    g[rng.random(len(g)) < 0.1] = None
    out["c0"] = (g, t)
    return out


def fit_both(cols, **kw):
    from h2o3_tpu.models.naive_bayes import NaiveBayes as JNB

    jf, tf = both_frames(cols)
    jm = JNB(**kw).train(y="y", training_frame=jf)
    tm = th.NaiveBayes(**kw).train(y="y", training_frame=tf)
    return jm, tm, jf, tf


def assert_nb_close(jm, tm, jf, tf):
    np.testing.assert_array_equal(tm.priors, jm.priors)
    assert len(tm.cat_tables) == len(jm.cat_tables)
    for a, b in zip(jm.cat_tables, tm.cat_tables):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(tm.num_means, jm.num_means, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tm.num_sdevs, jm.num_sdevs, rtol=1e-6)
    jp, tp = jm.predict(jf), tm.predict(tf)
    assert tp.names == jp.names
    for nm in jp.names[1:]:
        np.testing.assert_allclose(tp.col(nm).data.numpy(),
                                   np.asarray(jp.col(nm).data)[:jf.nrows],
                                   atol=1e-6)
    jt, tt = jm._output.training_metrics, tm._output.training_metrics
    assert tt.logloss == pytest.approx(jt.logloss, rel=1e-6)
    if hasattr(jt, "auc"):
        assert tt.auc == pytest.approx(jt.auc, rel=1e-6)


@pytest.mark.parametrize("kw", [{}, {"laplace": 1.0},
                                {"min_sdev": 0.5, "eps_sdev": 0.9,
                                 "min_prob": 0.01, "eps_prob": 0.05}])
def test_binomial_matches_jax(cl, kw):
    assert_nb_close(*fit_both(flagship_cols(640, seed=2), **kw))


def test_multinomial_with_nas_matches_jax(cl):
    assert_nb_close(*fit_both(_with_na(dl_cols("multinomial", seed=4)),
                              laplace=0.5))


def test_weights_and_na_response_match_jax(cl):
    cols = flagship_cols(640, seed=6)
    rng = np.random.default_rng(1)
    cols["w"] = (rng.integers(1, 4, 640).astype(float), None)
    y = cols["y"][0].astype(object).copy()
    y[rng.random(640) < 0.05] = None
    cols["y"] = (y, "enum")
    assert_nb_close(*fit_both(cols, weights_column="w"))


def test_unseen_level_and_auc(cl):
    _, tm, _, tf = fit_both(flagship_cols(640, seed=3))
    assert tm._output.training_metrics.auc > 0.6
    cols = flagship_cols(64, seed=8)
    g = cols["c0"][0].astype(object).copy()
    g[:5] = "zz"
    cols["c0"] = (g, "enum")
    _, tf2 = both_frames(cols)
    p = tm.predict(tf2)
    probs = p.col("Y").data.numpy()
    assert np.isfinite(probs).all() and ((probs >= 0) & (probs <= 1)).all()


def test_numeric_response_is_refused(cl):
    cols = dl_cols("regression", n=64)
    _, tf = both_frames(cols)
    with pytest.raises(ValueError, match="categorical response"):
        th.NaiveBayes().train(y="y", training_frame=tf)
