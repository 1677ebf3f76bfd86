"""RuleFit in the port (on the CPU) against the JAX package, its rule
generators run through the Pallas histogram kernel in interpret mode:
DRF and GBM generators, the model types "rules", "linear" and
"rules_and_linear", a given lambda and the lasso lambda search, and a
JAX-fitted RuleFit carried across.

Tolerances:
- the generators' forests equal in structure, so the rules (names,
  descriptions, trees and leaves) are equal, and the same lambdas are
  fitted;
- the lasso on the rule frame: rule coefficients atol 2e-2, predictions
  atol 2e-3, deviance rtol 5e-4. The leaf indicators of one tree sum to
  one, the intercept's column, so the rule design is rank-deficient,
  and the reference's ADMM (rho 1, 50 sweeps) is far from converged on
  a Gram of this scale: a 1e-6 relative change of the design moves its
  fitted values by about 1e-4 (`test_rule_lasso_is_sensitive_to_
  rounding`). The two packages' float32 designs and Grams differ by
  about that much, so their fits differ as much (ROADMAP C10; these
  fixtures show up to 1e-2 in a coefficient, 1.1e-3 in a fitted value
  and 1.2e-4 in the deviance);
- a carried model's predictions atol 1e-6."""

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert

from test_torch_gbm_surface import carry
from test_torch_glm import carry_glm
from torch_port_support import both_frames, forest_arrays


def rule_cols(kind="class", n=640, seed=0):
    rng = np.random.default_rng(seed)
    x1, x2 = rng.standard_normal(n), rng.uniform(-2, 2, n)
    g = np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)]
    eta = x1 + (g == "a") + np.where(x2 > 0.5, 1.0, -0.5)
    y = (np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "Y", "N")
         if kind == "class" else eta + 0.3 * rng.standard_normal(n))
    return {"x1": (x1, None), "x2": (x2, None), "g": (g, "enum"),
            "y": (y, "enum" if kind == "class" else None)}


def fit_both(monkeypatch, cols, **kw):
    from h2o3_tpu.models.rulefit import RuleFit as JRF

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    jf, tf = both_frames(cols)
    kw = dict(rule_generation_ntrees=6, seed=3, **kw)
    jm = JRF(**kw).train(y="y", training_frame=jf)
    tm = th.RuleFit(**kw).train(y="y", training_frame=tf)
    return jm, tm, jf, tf


def _by_name(rules):
    return {r["name"]: r for r in rules}


def assert_rulefit_close(jm, tm, jf, tf):
    assert len(tm.tree_models) == len(jm.tree_models)
    for jt, tt in zip(jm.tree_models, tm.tree_models):
        a, b = forest_arrays(jt.forest), forest_arrays(tt.forest)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    jr, tr = _by_name(jm.rules), _by_name(tm.rules)
    assert sorted(tr) == sorted(jr)
    for k in jr:
        assert tr[k]["rule"] == jr[k]["rule"], k
        assert (tr[k]["model"], tr[k]["tree"], tr[k]["node"]) == \
            (jr[k]["model"], jr[k]["tree"], jr[k]["node"])
        assert tr[k]["coefficient"] == pytest.approx(jr[k]["coefficient"],
                                                     abs=2e-2), k
    coefs = [abs(r["coefficient"]) for r in tm.rules]
    assert coefs == sorted(coefs, reverse=True)
    assert tm.linear_names == jm.linear_names
    jg, tg = jm.glm_model, tm.glm_model
    assert tg.dinfo.coef_names() == jg.dinfo.coef_names()
    assert tg.iterations == jg.iterations
    assert tg.residual_deviance == pytest.approx(jg.residual_deviance,
                                                 rel=5e-4)
    assert tm._output.model_category == jm._output.model_category
    n = tf.nrows
    jp, tp = jm.predict(jf), tm.predict(tf)
    assert tp.names == jp.names
    for c in tp.names:
        if not tp.col(c).is_categorical:
            np.testing.assert_allclose(tp.col(c).to_numpy(),
                                       jp.col(c).to_numpy()[:n], atol=2e-3,
                                       err_msg=c)


@pytest.mark.parametrize("algorithm", ["DRF", "GBM"])
@pytest.mark.parametrize("model_type", ["rules_and_linear", "rules"])
def test_rule_generators_match_jax(cl, monkeypatch, algorithm, model_type):
    jm, tm, jf, tf = fit_both(monkeypatch, rule_cols(),
                              algorithm=algorithm, model_type=model_type,
                              min_rule_length=2, max_rule_length=3)
    assert len(tm.tree_models) == 2           # depths 2 and 3
    assert_rulefit_close(jm, tm, jf, tf)
    assert bool(tm.linear_names) == (model_type != "rules")


def test_linear_model_type_matches_jax(cl, monkeypatch):
    jm, tm, jf, tf = fit_both(monkeypatch, rule_cols(), model_type="linear")
    assert tm.rules == [] and tm.tree_models == []
    assert tm.linear_names == ["x1", "x2"]
    assert_rulefit_close(jm, tm, jf, tf)


def test_regression_at_a_given_lambda_matches_jax(cl, monkeypatch):
    jm, tm, jf, tf = fit_both(monkeypatch, rule_cols("real", seed=2),
                              lambda_=0.01, max_rule_length=2,
                              min_rule_length=2)
    assert tm._output.model_category == "Regression"
    assert_rulefit_close(jm, tm, jf, tf)


def test_rule_lasso_is_sensitive_to_rounding(cl, monkeypatch):
    """ROADMAP C10: each generator tree's leaf indicators sum to one, so
    with the intercept the rule design has fewer independent columns
    than columns; and the lasso's 50 ADMM sweeps, refitted on the same
    design changed by one part in 1e6, move the fitted values by more
    than 1e-5."""
    import torch

    from h2o3_tpu_torch.models.glm import _irls_fit

    _, tm, _, tf = fit_both(monkeypatch, rule_cols("real", seed=2),
                            lambda_=0.01, max_rule_length=2,
                            min_rule_length=2)
    g = tm.glm_model
    X = g._design(tm.adapt_test(tf))
    Xd = np.concatenate([X.numpy(), np.ones((X.shape[0], 1))], 1)
    assert np.linalg.matrix_rank(Xd.astype(np.float64)) <= \
        Xd.shape[1] - tm.tree_models[0].forest.n_trees
    y = tf.col("y").data
    w, off = torch.ones_like(y), torch.zeros_like(y)
    l1 = float(np.float32(0.01 * 640))
    noise = torch.as_tensor(np.random.default_rng(0).standard_normal(
        X.shape).astype(np.float32))
    fits = [_irls_fit(Xv, y, w, off, torch.zeros(X.shape[1] + 1), 0.0, l1,
                      1e-4, famname="gaussian", linkname="identity",
                      max_iter=50)[0] for Xv in (X, X * (1 + 1e-6 * noise))]
    eta = [torch.cat([X, torch.ones(X.shape[0], 1)], 1) @ b for b in fits]
    assert float((eta[0] - eta[1]).abs().max()) > 1e-5


def carry_rulefit(jm):
    o = jm._output
    return {"tree_models": [dict(carry(t), algo=t.algo_name)
                            for t in jm.tree_models],
            "rules": [dict(r) for r in jm.rules],
            "linear_names": list(jm.linear_names),
            "glm": carry_glm(jm.glm_model),
            "output": {"names": list(o.names), "domains": dict(o.domains),
                       "response_domain": o.response_domain,
                       "model_category": o.model_category,
                       "response_name": o.response_name}}


@pytest.mark.parametrize("algorithm", ["DRF", "GBM"])
def test_jax_rulefit_carried_across(cl, monkeypatch, algorithm):
    jm, _, jf, tf = fit_both(monkeypatch, rule_cols(seed=5),
                             algorithm=algorithm)
    tm = convert.rulefit_model_from_numpy(carry_rulefit(jm))
    assert [t.algo_name for t in tm.tree_models] == \
        [t.algo_name for t in jm.tree_models]
    np.testing.assert_allclose(tm.predict(tf).col("Y").to_numpy(),
                               jm.predict(jf).col("Y").to_numpy()[:640],
                               atol=1e-6)
