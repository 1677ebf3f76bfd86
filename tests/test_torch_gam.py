"""GAM in the port (on the CPU) against the JAX package: the four basis
types' matrices, the knots, the fitted model and a JAX-fitted GAM
carried across.

Tolerances:
- knots bitwise (the quantiles are exact in both packages);
- basis matrices atol 1e-6 + rtol 1e-6 (float32 elementwise maps; XLA's
  and torch's float32 powers and divisions may round apart);
- the fitted models at the default smoothing scale: the same IRLS
  iteration count, deviance rtol 1e-4, predictions atol 1e-4. Spline
  bases are nearly collinear, so the float32 Gram's rounding, summed in
  different orders in the two packages, moves the solve by more than the
  1e-5 of well-conditioned GLMs, and the more so the weaker the ridge
  (ROADMAP C10; `test_weak_ridge_widens_the_gap` shows it at scale
  0.001);
- a carried model's predictions atol 1e-4 (the carried coefficients on
  bases that agree to 1e-6)."""

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.models import gam as tg

from test_torch_glm import carry_glm
from torch_port_support import both_frames

BS = [0, 1, 2, 3]


def gam_cols(n=640, seed=0):
    rng = np.random.default_rng(seed)
    x1, x2 = rng.standard_normal(n), rng.uniform(-2, 2, n)
    g = np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)]
    y = (np.sin(2 * x2) + 0.5 * x1 + 0.3 * (g == "a")
         + 0.1 * rng.standard_normal(n))
    return {"x1": (x1, None), "x2": (x2, None), "g": (g, "enum"),
            "y": (y, None)}


def _bases():
    from h2o3_tpu.models import gam as jg

    return {0: (jg._nspline_basis, tg.nspline_basis),
            1: (jg._thinplate_basis, tg.thinplate_basis),
            2: (jg._ispline_basis, tg.ispline_basis),
            3: (jg._mspline_basis, tg.mspline_basis)}


@pytest.mark.parametrize("bs", BS)
def test_basis_matrix_matches_jax(cl, bs):
    import jax
    import jax.numpy as jnp
    import torch

    knots = np.array([-1.7, -0.9, -0.2, 0.35, 1.1, 1.8])
    x = np.concatenate([np.linspace(-2.5, 2.5, 501), knots]).astype(
        np.float32)
    jfn, tfn = _bases()[bs]
    j = np.asarray(jax.jit(jfn(knots))(jnp.asarray(x)))
    t = tfn(knots)(torch.as_tensor(x)).numpy()
    assert t.dtype == np.float32 and t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def fit_both(bs, **kw):
    from h2o3_tpu.models.gam import GAM as JGAM

    jf, tf = both_frames(gam_cols())
    kw = dict(gam_columns=["x2"], bs=[bs], num_knots=[7], **kw)
    jm = JGAM(**kw).train(y="y", training_frame=jf)
    tm = th.GAM(**kw).train(y="y", training_frame=tf)
    return jm, tm, jf, tf


@pytest.mark.parametrize("bs", BS)
def test_gam_matches_jax(cl, bs):
    jm, tm, jf, tf = fit_both(bs)
    assert tm.knots["x2"].tobytes() == jm.knots["x2"].tobytes()
    assert tm.get_knot_locations() == jm.get_knot_locations()
    jg, tg_ = jm.glm_model, tm.glm_model
    assert tg_.dinfo.coef_names() == jg.dinfo.coef_names()
    assert tg_.iterations == jg.iterations
    assert tg_.residual_deviance == pytest.approx(jg.residual_deviance,
                                                  rel=1e-4)
    n = tf.nrows
    # the expanded frames: basis columns to 1e-6
    je, te = jm._expand_frame(jf), tm._expand_frame(tf)
    assert te.names == je.names
    for c in te.names:
        if "_gam" in c:
            np.testing.assert_allclose(te.col(c).to_numpy(),
                                       je.col(c).to_numpy()[:n], rtol=1e-6,
                                       atol=1e-6, err_msg=c)
    np.testing.assert_allclose(tm.predict(tf).col("predict").to_numpy(),
                               jm.predict(jf).col("predict").to_numpy()[:n],
                               atol=1e-4)
    assert tm._output.training_metrics.rmse == pytest.approx(
        jm._output.training_metrics.rmse, rel=1e-4)
    if bs == 2:       # I-splines fit with non-negative coefficients
        assert tg_._parms["non_negative"]
        assert min(v for k, v in tm.coef().items() if "_gam" in k) >= 0.0


def test_several_gam_columns_and_a_binomial_response(cl):
    from h2o3_tpu.models.gam import GAM as JGAM

    cols = gam_cols(seed=3)
    rng = np.random.default_rng(4)
    cols["y"] = (np.where(rng.random(640) < 1 / (1 + np.exp(
        -np.sin(2 * cols["x2"][0]) - cols["x1"][0])), "Y", "N"), "enum")
    jf, tf = both_frames(cols)
    kw = dict(gam_columns=["x1", "x2"], bs=[3, 0], num_knots=[5, 6])
    jm = JGAM(**kw).train(y="y", training_frame=jf)
    tm = th.GAM(**kw).train(y="y", training_frame=tf)
    assert tm._output.model_category == "Binomial"
    for c in ("x1", "x2"):
        assert tm.knots[c].tobytes() == jm.knots[c].tobytes()
    np.testing.assert_allclose(tm.predict(tf).col("Y").to_numpy(),
                               jm.predict(jf).col("Y").to_numpy()[:640],
                               atol=1e-4)


def test_weak_ridge_widens_the_gap(cl):
    """ROADMAP C10: at scale 0.001 the standardised natural-spline
    design is ill-conditioned (cond(XᵀX) > 1e4), and the two packages'
    float32 fits differ by more than 1e-5 in their predictions, but
    agree to 1e-3."""
    jm, tm, jf, tf = fit_both(0, scale=[0.001])
    g = tm.glm_model
    X = g._design(g.adapt_test(tm._expand_frame(tf))).numpy()
    X = np.concatenate([X, np.ones((X.shape[0], 1))], 1).astype(np.float64)
    assert np.linalg.cond(X.T @ X) > 1e4
    t = tm.predict(tf).col("predict").to_numpy()
    j = jm.predict(jf).col("predict").to_numpy()[:640]
    np.testing.assert_allclose(t, j, atol=1e-3)
    assert np.abs(t - j).max() > 1e-5
    assert g.residual_deviance == pytest.approx(
        jm.glm_model.residual_deviance, rel=1e-3)


def test_errors_match_jax(cl):
    from h2o3_tpu.models.gam import GAM as JGAM

    jf, tf = both_frames(gam_cols())
    for kw, msg in (({}, "gam_columns"), ({"gam_columns": ["x2"], "bs": [7]},
                                          "unsupported"),
                    ({"gam_columns": ["x2"], "bs": [0, 1]}, "entries")):
        for cls, fr in ((JGAM, jf), (th.GAM, tf)):
            with pytest.raises(ValueError, match=msg):
                cls(**kw).train(y="y", training_frame=fr)


def carry_gam(jm):
    o = jm._output
    return {"knots": dict(jm.knots), "bs_types": dict(jm.bs_types),
            "glm": carry_glm(jm.glm_model),
            "output": {"names": list(o.names), "domains": dict(o.domains),
                       "response_domain": o.response_domain,
                       "model_category": o.model_category,
                       "response_name": o.response_name}}


@pytest.mark.parametrize("bs", [0, 2])
def test_jax_gam_carried_across(cl, bs):
    jm, _, jf, tf = fit_both(bs)
    tm = convert.gam_model_from_numpy(carry_gam(jm))
    np.testing.assert_allclose(tm.predict(tf).col("predict").to_numpy(),
                               jm.predict(jf).col("predict").to_numpy()[:640],
                               atol=1e-4)
