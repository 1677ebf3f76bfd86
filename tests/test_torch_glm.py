"""GLM in the port (on the CPU) against the JAX package on the same numpy
fixtures: every family and link, ridge, L1 and elastic net through ADMM,
non_negative, intercept=False, weights, offset, missing-value handling,
multinomial and ordinal through the port's L-BFGS, interactions, lambda
search, p-values, coef/coef_norm, the validation errors, and a
JAX-fitted GLM carried across.

Tolerances (both packages work in float32; the reference's Gram is 8
shard partials plus a psum, the port's one BLAS call, and XLA's exp/log
are not torch's, so fits agree to rounding, not bit for bit):
- coefficients (coef and coef_norm) atol 1e-5 + rtol 1e-5;
- predictions atol 1e-5 + rtol 1e-5; deviances, AIC and training
  metrics rtol 1e-5;
- the IRLS iteration count equal, or one apart (a step can land on
  either side of beta_epsilon);
- lambda search: the same lambdas fitted and the same lambda chosen
  (its value to 1e-6 relative: lambda_max is a float32 reduction);
- p-values rtol 1e-3 (a p-value's relative error is about z^2 times the
  coefficients'), standard errors rtol 1e-5;
- a carried model's predictions atol 1e-6 + rtol 1e-6 (the same
  coefficients; only the order of the dot products differs).
Designs made rank-deficient by the reference's interaction expansion
agree to 1e-3 in their predictions only: ROADMAP C10 and
`test_collinear_interactions_agree_only_to_rounding`.
Row counts are multiples of 64, so the JAX package pads no rows."""

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert

from torch_port_support import both_frames, carry_glm

TOL = dict(rtol=1e-5, atol=1e-5)


def glm_cols(kind, n=640, seed=1, na=False):
    """x1, x2 numeric, g a 3-level enum, y of the given kind from a
    linear predictor of the three."""
    rng = np.random.default_rng(seed)
    x1, x2 = rng.standard_normal(n), rng.uniform(-1, 1, n)
    g = np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)]
    eta = 0.4 * x1 - 0.3 * x2 + 0.5 * (g == "a") - 0.2 * (g == "c")
    mu = np.exp(eta + 0.5)
    y = {"real": 1 + eta + 0.2 * rng.standard_normal(n),
         "binary": (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(float),
         "fraction": 1 / (1 + np.exp(-eta - 0.3 * rng.standard_normal(n))),
         "count": rng.poisson(mu).astype(float),
         "positive": rng.gamma(3.0, mu / 3.0),
         "inverse": rng.gamma(4.0, 1 / (2.0 + eta) / 4.0),
         "tweedie": np.where(rng.random(n) < 0.3, 0.0,
                             rng.gamma(2.0, mu / 2.0)),
         "negbin": rng.negative_binomial(2, 2 / (2 + mu)).astype(float),
         "class": np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "Y",
                           "N"),
         }[kind]
    if na:
        x1[rng.random(n) < 0.1] = np.nan
        g[rng.random(n) < 0.1] = None
    cols = {"x1": (x1, None), "x2": (x2, None), "g": (g, "enum")}
    cols["y"] = (y, "enum" if kind == "class" else None)
    return cols


def class_cols(n=640, seed=4, K=4):
    """x1, x2 numeric, g an enum and a K-level ordered response: a
    latent linear score plus logistic noise cut at its quantiles (not
    separable, so the optimum is unique)."""
    rng = np.random.default_rng(seed)
    x1, x2 = rng.standard_normal(n), rng.standard_normal(n)
    g = np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)]
    u = 1.2 * x1 - 0.7 * x2 + 0.8 * (g == "a") + rng.logistic(size=n)
    code = np.searchsorted(np.quantile(u, np.arange(1, K) / K), u)
    y = np.array([f"k{k}" for k in range(K)], object)[code]
    return {"x1": (x1, None), "x2": (x2, None), "g": (g, "enum"),
            "y": (y, "enum")}


def fit_both(cols, **kw):
    from h2o3_tpu.models.glm import GLM as JGLM

    jf, tf = both_frames(cols)
    jm = JGLM(**kw).train(y="y", training_frame=jf)
    tm = th.GLM(**kw).train(y="y", training_frame=tf)
    return jm, tm, jf, tf


def assert_coefs_close(jc, tc):
    assert list(tc) == list(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], err_msg=k, **TOL)


def assert_predictions_close(jm, tm, jf, tf, **tol):
    n = tf.nrows
    jp, tp = jm.predict(jf), tm.predict(tf)
    assert tp.names == jp.names
    for c in tp.names:
        t, j = tp.col(c).to_numpy(), jp.col(c).to_numpy()[:n]
        if tp.col(c).is_categorical:
            assert tp.col(c).domain == jp.col(c).domain
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, err_msg=c, **(tol or TOL))


_METRICS = {"Regression": ("rmse", "mae", "mean_residual_deviance"),
            "Binomial": ("auc", "logloss", "rmse"),
            "Multinomial": ("logloss", "rmse")}


def assert_glm_close(jm, tm, jf, tf):
    out = tm._output
    assert out.model_category == jm._output.model_category
    assert out.response_domain == jm._output.response_domain
    assert out.names == list(jm._output.names)
    assert tm.linkname == jm.linkname
    assert abs(tm.iterations - jm.iterations) <= 1
    assert_coefs_close(jm.coef(), tm.coef())
    if np.asarray(jm.beta).ndim == 1:
        # the reference's coef_norm takes one coefficient per name
        assert_coefs_close(jm.coef_norm(), tm.coef_norm())
    np.testing.assert_allclose(tm.beta.numpy(), np.asarray(jm.beta), **TOL)
    for k in ("residual_deviance", "null_deviance", "aic"):
        j, t = getattr(jm, k), getattr(tm, k)
        if np.isnan(j):
            assert np.isnan(t), k
        else:
            assert t == pytest.approx(j, rel=1e-5), k
    jmm, tmm = jm._output.training_metrics, out.training_metrics
    assert tmm.nobs == pytest.approx(jmm.nobs, rel=1e-6)
    for k in _METRICS[out.model_category]:
        assert getattr(tmm, k) == pytest.approx(getattr(jmm, k),
                                                rel=1e-5, abs=1e-7), k
    assert_predictions_close(jm, tm, jf, tf)


_FAMILIES = {
    "gaussian": ("real", {"family": "gaussian"}),
    "gaussian_log_link": ("real", {"family": "gaussian", "link": "log"}),
    "binomial": ("class", {}),
    "binomial_numeric_01": ("binary", {"family": "binomial"}),
    "quasibinomial": ("binary", {"family": "quasibinomial"}),
    "fractionalbinomial": ("fraction", {"family": "fractionalbinomial"}),
    "poisson": ("count", {"family": "poisson"}),
    "gamma": ("positive", {"family": "gamma"}),
    "gamma_inverse_link": ("inverse", {"family": "gamma",
                                       "link": "inverse"}),
    "tweedie": ("tweedie", {"family": "tweedie"}),
    "tweedie_link_power": ("tweedie", {"family": "tweedie",
                                       "tweedie_variance_power": 1.2,
                                       "tweedie_link_power": 0.5}),
    "negativebinomial": ("negbin", {"family": "negativebinomial",
                                    "theta": 0.5}),
}


@pytest.mark.parametrize("case", sorted(_FAMILIES))
def test_family_and_link_match_jax(cl, case):
    kind, kw = _FAMILIES[case]
    assert_glm_close(*fit_both(glm_cols(kind), **kw))


_PENALTIES = {
    "ridge": ("real", {"lambda_": 0.1, "alpha": 0.0}),
    "lasso_admm": ("class", {"lambda_": 0.02, "alpha": 1.0}),
    "elastic_net_admm": ("real", {"lambda_": 0.05, "alpha": 0.5}),
    "poisson_lasso_admm": ("count", {"family": "poisson", "lambda_": 0.01,
                                     "alpha": 1.0}),
    "non_negative": ("real", {"lambda_": 0.0, "non_negative": True}),
    "non_negative_l1": ("class", {"lambda_": 0.005, "alpha": 1.0,
                                  "non_negative": True}),
    "no_intercept_gaussian": ("real", {"intercept": False}),
    "no_intercept_binomial": ("class", {"intercept": False}),
    "no_standardize": ("class", {"standardize": False, "lambda_": 0.0}),
}


@pytest.mark.parametrize("case", sorted(_PENALTIES))
def test_penalties_and_intercept_match_jax(cl, case):
    kind, kw = _PENALTIES[case]
    jm, tm, jf, tf = fit_both(glm_cols(kind), **kw)
    assert_glm_close(jm, tm, jf, tf)
    b = tm.coef_norm()
    if kw.get("non_negative"):
        assert min(v for k, v in b.items() if k != "Intercept") >= 0.0
        assert min(jm.coef_norm()[k] for k in b if k != "Intercept") >= 0.0
    if kw.get("intercept") is False:
        assert b["Intercept"] == 0.0
        assert tm.dinfo.use_all_factor_levels and not tm.dinfo.standardize


def _with(cols, **extra):
    out = dict(cols)
    out.update(extra)
    return out


def test_weights_match_jax(cl):
    rng = np.random.default_rng(8)
    w = rng.uniform(0.0, 3.0, 640)
    w[:64] = 0.0
    cols = _with(glm_cols("real"), w=(w, None))
    jm, tm, jf, tf = fit_both(cols, weights_column="w")
    assert "w" not in tm.dinfo.predictor_names
    assert_glm_close(jm, tm, jf, tf)


def test_offset_matches_jax_and_is_read_at_scoring(cl):
    rng = np.random.default_rng(9)
    cols = _with(glm_cols("count"), o=(0.3 * rng.standard_normal(640), None))
    jm, tm, jf, tf = fit_both(cols, family="poisson", offset_column="o")
    assert "o" not in tm.dinfo.predictor_names
    assert_glm_close(jm, tm, jf, tf)
    # the test frame's offset moves the prediction: adapt_test carries it
    plain = th.GLM(family="poisson").train(y="y", training_frame=tf)
    assert not np.allclose(tm.predict(tf).col("predict").to_numpy(),
                           plain.predict(tf).col("predict").to_numpy())
    assert "o" in tm.adapt_test(tf)


@pytest.mark.parametrize("mvh", ["MeanImputation", "Skip"])
def test_missing_values_handling_matches_jax(cl, mvh):
    jm, tm, jf, tf = fit_both(glm_cols("class", na=True),
                              missing_values_handling=mvh)
    assert_glm_close(jm, tm, jf, tf)


@pytest.mark.parametrize("kw", [{}, {"lambda_": 0.5}, {"standardize": False}])
def test_multinomial_matches_jax(cl, kw):
    jm, tm, jf, tf = fit_both(class_cols(), family="multinomial", **kw)
    assert tuple(tm.beta.shape) == (tm.dinfo.fullN + 1, 4)
    assert_glm_close(jm, tm, jf, tf)


@pytest.mark.parametrize("kw", [{}, {"lambda_": 0.5}])
def test_ordinal_matches_jax(cl, kw):
    jm, tm, jf, tf = fit_both(class_cols(K=3), family="ordinal", **kw)
    assert tuple(tm.beta.shape) == (tm.dinfo.fullN + 2,)
    c = tm.coef()
    assert c["theta_0"] < c["theta_1"]
    assert_glm_close(jm, tm, jf, tf)


def _interaction_cols(n=640, seed=5):
    rng = np.random.default_rng(seed)
    a, b = rng.standard_normal(n), rng.standard_normal(n)
    g = np.array(["u", "v", "w"], object)[rng.integers(0, 3, n)]
    h = np.array(["p", "q"], object)[rng.integers(0, 2, n)]
    y = (a - 0.5 * b + 1.5 * a * b + np.where(g == "u", 2 * a, -a)
         + 0.7 * ((g == "v") & (h == "q")) + 0.1 * rng.standard_normal(n))
    g[rng.random(n) < 0.05] = None
    return {"a": (a, None), "b": (b, None), "g": (g, "enum"),
            "h": (h, "enum"), "y": (y, None)}


def test_num_num_interaction_matches_jax(cl):
    jm, tm, jf, tf = fit_both(_interaction_cols(), lambda_=0.0,
                              interactions=["a", "b"])
    assert "a:b" in tm.coef()
    assert_glm_close(jm, tm, jf, tf)


def _design_rank(m, tf):
    X = m._design(m.adapt_test(tf)).numpy().astype(np.float64)
    X = np.concatenate([X, np.ones((X.shape[0], 1))], 1)
    return np.linalg.matrix_rank(X), X.shape[1]


def test_collinear_interactions_agree_only_to_rounding(cl):
    """ROADMAP C10: enum x num and enum x enum interactions keep every
    level, so their columns sum to the numeric (or to the enum's
    indicators) and the design is rank-deficient. The float32 solve
    settles the null-space part by rounding and the jitter, and the two
    packages settle it apart: fitted values and deviance agree, the
    coefficients do not."""
    jm, tm, jf, tf = fit_both(_interaction_cols(),
                              interactions=["a", "b", "g", "h"])
    assert {"a:b", "g_u:a", "g_v:h_q"} <= set(tm.coef())
    rank, cols = _design_rank(tm, tf)
    assert rank < cols
    assert tm.residual_deviance == pytest.approx(jm.residual_deviance,
                                                 rel=1e-5)
    assert_predictions_close(jm, tm, jf, tf, atol=1e-3, rtol=0)
    jc, tc = jm.coef(), tm.coef()
    assert max(abs(jc[k] - tc[k]) for k in jc) > 1e-5


def test_interaction_level_missing_from_the_test_frame(cl):
    """A training level absent from the test frame expands to zeros, not
    to NA (the reference's tests/test_glm.py:262). The enum x num design
    is rank-deficient (C10), so predictions agree to 1e-3."""
    jm, tm, _, _ = fit_both(_interaction_cols(), lambda_=0.0,
                            interactions=["g", "a"])
    xs = np.linspace(-2, 2, 64)
    test = {"g": (np.array(["u"] * 64, object), "enum"), "a": (xs, None),
            "b": (np.zeros(64), None), "h": (np.array(["p"] * 64), "enum")}
    jt, tt = both_frames(test)
    t = tm.predict(tt).col("predict").to_numpy()
    np.testing.assert_allclose(t, jm.predict(jt).col("predict").to_numpy()[
        :64], atol=1e-3)
    assert np.all(np.isfinite(t))
    np.testing.assert_allclose(t, 3 * xs, atol=0.3)     # the u slope


@pytest.mark.parametrize("kind,kw", [
    ("real", {"alpha": 0.5}),
    ("class", {"alpha": 1.0}),
    ("count", {"family": "poisson", "nlambdas": 12}),
])
def test_lambda_search_matches_jax(cl, kind, kw):
    from h2o3_tpu.models.glm import GLM as JGLM

    jf, tf = both_frames(glm_cols(kind))
    jb, tb = JGLM(lambda_search=True, **kw), th.GLM(lambda_search=True, **kw)
    jm = jb.train(y="y", training_frame=jf)
    tm = tb.train(y="y", training_frame=tf)
    # the same lambdas fitted and the same one chosen; lambda_max is a
    # float32 reduction, so the path's values agree to 1e-6 relative
    assert tm.iterations == jm.iterations
    assert tb.params["lambda_"] == pytest.approx(jb.params["lambda_"],
                                                 rel=1e-6)
    assert_coefs_close(jm.coef(), tm.coef())
    assert tm.residual_deviance == pytest.approx(jm.residual_deviance,
                                                 rel=1e-5)
    assert_predictions_close(jm, tm, jf, tf)


@pytest.mark.parametrize("kind,kw", [("class", {}),
                                     ("real", {"standardize": False}),
                                     ("count", {"family": "poisson"})])
def test_p_values_match_the_reference(cl, kind, kw):
    jm, tm, _, _ = fit_both(glm_cols(kind), lambda_=0.0,
                            compute_p_values=True, **kw)
    np.testing.assert_allclose(tm.std_errors, jm.std_errors, rtol=1e-5)
    np.testing.assert_allclose(tm.p_values, jm.p_values, rtol=1e-3,
                               atol=1e-12)
    assert np.all(np.isfinite(tm.p_values))


def test_normal_tail_matches_scipy():
    from scipy import stats

    from h2o3_tpu_torch.models.glm import normal_cdf

    z = np.array([0.0, 0.3, 1.0, 1.96, 3.5, 6.0, -2.0])
    np.testing.assert_allclose([normal_cdf(v) for v in z],
                               stats.norm.cdf(z), rtol=1e-14)


def test_validation_errors_match_jax(cl):
    from h2o3_tpu.models.glm import GLM as JGLM

    jf, tf = both_frames(class_cols(K=3))
    cases = [({"family": "binomial"}, "binary response"),
             ({"compute_p_values": True, "lambda_": 0.1}, "compute_p_values"),
             ({"family": "multinomial", "intercept": False}, "intercept"),
             ({"family": "ordinal", "non_negative": True}, "non_negative")]
    for kw, msg in cases:
        for cls, fr in ((JGLM, jf), (th.GLM, tf)):
            with pytest.raises(ValueError, match=msg):
                cls(**kw).train(y="y", training_frame=fr)
    jf2, tf2 = both_frames(_with(class_cols(K=3), y=(
        np.array(["a", "b"] * 320, object), "enum")))
    for cls, fr in ((JGLM, jf2), (th.GLM, tf2)):
        with pytest.raises(ValueError, match="3 ordered levels"):
            cls(family="ordinal").train(y="y", training_frame=fr)


@pytest.mark.parametrize("case", ["binomial_na", "poisson_offset",
                                  "multinomial", "ordinal",
                                  "interactions"])
def test_jax_glm_carried_across(cl, case):
    """A JAX-fitted GLM scores in the port as in the JAX package."""
    from h2o3_tpu.models.glm import GLM as JGLM

    rng = np.random.default_rng(12)
    cols, kw = {
        "binomial_na": (glm_cols("class", na=True), {}),
        "poisson_offset": (_with(glm_cols("count"), o=(
            0.3 * rng.standard_normal(640), None)),
            {"family": "poisson", "offset_column": "o"}),
        "multinomial": (class_cols(), {"family": "multinomial"}),
        "ordinal": (class_cols(K=3), {"family": "ordinal"}),
        "interactions": (_interaction_cols(), {"interactions": ["a", "b"]}),
    }[case]
    jf, tf = both_frames(cols)
    jm = JGLM(**kw).train(y="y", training_frame=jf)
    tm = convert.glm_model_from_numpy(carry_glm(jm))
    assert tm.dinfo.coef_names() == jm.dinfo.coef_names()
    jc, tc = jm.coef(), tm.coef()
    assert list(tc) == list(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], rtol=1e-12, err_msg=k)
    n = tf.nrows
    jp, tp = jm.predict(jf), tm.predict(tf)
    for c in tp.names:
        if c != "predict" or not tp.col(c).is_categorical:
            np.testing.assert_allclose(tp.col(c).to_numpy(),
                                       jp.col(c).to_numpy()[:n], atol=1e-6,
                                       rtol=1e-6, err_msg=c)


@pytest.mark.parametrize("cols,kw", [
    (glm_cols("class"), {"lambda_": 0.01, "alpha": 0.5}),
    (class_cols(), {"family": "multinomial"})])
def test_training_is_deterministic_on_the_cpu(cl, cols, kw):
    _, tf = both_frames(cols)
    a = th.GLM(**kw).train(y="y", training_frame=tf)
    b = th.GLM(**kw).train(y="y", training_frame=tf)
    assert a.beta.numpy().tobytes() == b.beta.numpy().tobytes()


@pytest.mark.gpu
def test_card_glm_matches_the_cpu():
    """The same GLMs on the card and on the CPU (cuBLAS and the CPU's
    BLAS sum in different orders): coefficients atol 1e-4."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fits = []
    for dev in ("cuda", "cpu"):
        th.init(device=dev)
        fr = th.Frame()
        for k, (v, ct) in glm_cols("class").items():
            fr.add(k, th.Column.from_numpy(v, ctype=ct))
        fits.append([th.GLM(**kw).train(y="y", training_frame=fr).coef()
                     for kw in ({}, {"lambda_search": True})])
    th.init(device="cpu")
    for a, b in zip(*fits):
        for k in a:
            assert a[k] == pytest.approx(b[k], abs=1e-4), k


def test_saturated_logistic_diverges_in_both_packages(cl):
    """ROADMAP C11: where some |x.b| passes ~17, float32's logistic
    rounds mu to exactly 0 or 1, mu(1 - mu) g'(mu)^2 underflows to 0,
    the EPS clamp makes that row's IRLS weight 1e10, and the reference's
    IRLS diverges: both packages run to max_iterations and end with a
    NaN deviance. (The bench's GLM stage scales its b by 1/sqrt(p) so it
    stays clear of this.)"""
    rng = np.random.default_rng(0)
    n, p = 640, 8
    X = rng.standard_normal((n, p))
    eta = X @ (4.0 * rng.standard_normal(p))
    assert np.abs(eta).max() > 17
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "Y", "N")
    cols = {f"x{j}": (X[:, j], None) for j in range(p)}
    cols["y"] = (y, "enum")
    jm, tm, _, _ = fit_both(cols, lambda_=0.0, max_iterations=10)
    assert tm.iterations == jm.iterations == 10
    assert np.isnan(tm.residual_deviance) and np.isnan(jm.residual_deviance)
