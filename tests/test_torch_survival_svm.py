"""CoxPH and PSVM in the port (on the CPU) against the JAX package, and
the port's BFGS (optim/bfgs.py) against jax.scipy.optimize.minimize.

Tolerances:
- BFGS in float64 (a quadratic plus a quartic term): the same steps,
  line-search evaluations and outcome as jax's, the minimiser atol
  1e-12; in float32 the same steps until the objective's changes reach
  its last bits, where a line search's float32 comparisons may branch
  apart (ROADMAP C22): a quadratic's first 7 steps agree to 1e-6, and on
  PSVM's squared-hinge objective the minimiser agrees to atol 1e-4 and
  the objective to rtol 1e-6, the step counts printed side by side;
- CoxPH (Efron and Breslow ties, strata, a start column, weights):
  the log-likelihoods (fitted and null) rtol 1e-6, which holds
  torch.func's gradient and Hessian to jax.grad and jax.hessian through
  the Newton steps; the coefficients only atol 2e-3 (ROADMAP C23: the
  float32 partial likelihood of 640 rows is flat to its last bits over
  ~1e-3 of coefficient space, so Newton stops anywhere in it; these
  fixtures show up to 8.6e-4, and the reference's own coefficients move
  5e-4 between its 8-device test mesh and one device), the linear
  predictors atol 1e-2, the baseline hazard rtol 2e-3 and the
  concordance abs 1e-4 (the same pairs, a few near-equal predictors
  ranked apart);
- PSVM: the same ICF pivot rows (host numpy on designs equal to an
  ulp), the fitted
  weights atol 1e-3 and decision values atol 1e-3, the support-vector
  counts equal.
Row counts are multiples of 64, so the JAX package pads no rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch.optim import bfgs

from torch_port_support import both_frames


@pytest.mark.parametrize("d,scale,seed", [(5, 1.0, 0), (20, 1.0, 3)])
def test_bfgs_follows_jax_step_for_step_in_float64(d, scale, seed):
    """On a convex quadratic plus a quartic term, in float64 (where
    rounding cannot flip a branch), the same steps, line-search
    evaluations and outcome as jax's BFGS, the minimiser atol 1e-12."""
    from jax.scipy.optimize import minimize as jmin

    rng = np.random.default_rng(seed)
    M = rng.standard_normal((d, d))
    A = scale * M @ M.T / d + np.eye(d)
    b = rng.standard_normal(d)
    with jax.enable_x64(True):
        jA, jb = jnp.asarray(A), jnp.asarray(b)
        res_j = jmin(lambda x: 0.5 * x @ jA @ x - jb @ x
                     + 0.1 * jnp.sum(x ** 4),
                     jnp.zeros(d, jnp.float64), method="BFGS")
        want = (int(res_j.nit), int(res_j.nfev), bool(res_j.success),
                np.asarray(res_j.x))
    tA, tb = torch.as_tensor(A), torch.as_tensor(b)
    res_t = bfgs.minimize(bfgs.value_and_grad(
        lambda x: 0.5 * x @ tA @ x - tb @ x + 0.1 * torch.sum(x ** 4)),
        torch.zeros(d, dtype=torch.float64))
    assert (res_t.nit, res_t.nfev) == want[:2]
    assert (res_t.converged and not res_t.failed) == want[2]
    np.testing.assert_allclose(res_t.x.numpy(), want[3], atol=1e-12)


def test_bfgs_float32_quadratic_parts_only_at_the_last_bits():
    """ROADMAP C22: in float32 the two agree step for step until the
    objective's changes reach its last bits, where a line search's
    comparisons may branch apart; the minimiser agrees to 1e-4."""
    from jax.scipy.optimize import minimize as jmin

    rng = np.random.default_rng(0)
    M = rng.standard_normal((10, 10))
    A = (M @ M.T + 10 * np.eye(10)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    jA, jb = jnp.asarray(A), jnp.asarray(b)
    tA, tb = torch.as_tensor(A), torch.as_tensor(b)
    for k in (3, 7):
        res_j = jmin(lambda x: 0.5 * x @ jA @ x - jb @ x,
                     jnp.zeros(10, jnp.float32), method="BFGS",
                     options={"maxiter": k})
        res_t = bfgs.minimize(bfgs.value_and_grad(
            lambda x: 0.5 * x @ tA @ x - tb @ x), torch.zeros(10),
            maxiter=k)
        assert (res_t.nit, res_t.nfev) == (int(res_j.nit),
                                          int(res_j.nfev)), k
        np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                                   atol=1e-6)
    res_t = bfgs.minimize(bfgs.value_and_grad(
        lambda x: 0.5 * x @ tA @ x - tb @ x), torch.zeros(10))
    np.testing.assert_allclose(res_t.x.numpy(), np.linalg.solve(A, b),
                               atol=1e-4)


def svm_cols(n=640, seed=0, sep=1.5):
    """Two overlapping Gaussian classes in 3 numerics plus an enum."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    X = rng.standard_normal((n, 3)) + sep * (2 * y[:, None] - 1) * \
        np.array([1.0, 0.5, 0.0])
    g = np.array(["a", "b"], object)[rng.integers(0, 2, n)]
    cols = {f"x{j}": (X[:, j], None) for j in range(3)}
    cols["g"] = (g, "enum")
    cols["y"] = (np.array(["N", "Y"], object)[y], "enum")
    return cols


def test_bfgs_matches_jax_on_the_psvm_objective():
    from jax.scipy.optimize import minimize as jmin
    from h2o3_tpu_torch.models.psvm import _icf, svm_loss

    rng = np.random.default_rng(3)
    X = rng.standard_normal((256, 4)).astype(np.float32)
    y = np.where(X[:, 0] + 0.5 * rng.standard_normal(256) > 0, 1.0,
                 -1.0).astype(np.float32)
    w = np.ones(256, np.float32)
    _, H, _ = _icf(X, 0.25, 17)
    Hd, yd, wd = jnp.asarray(H), jnp.asarray(y), jnp.asarray(w)

    def jloss(b):
        f = Hd @ b[:-1] + b[-1]
        m = jnp.maximum(1.0 - yd * f, 0.0)
        return 0.5 * jnp.sum(b[:-1] ** 2) + jnp.sum(wd * m * m)

    res_j = jax.jit(lambda b0: jmin(jloss, b0, method="BFGS",
                                    options={"maxiter": 2000}))(
        jnp.zeros(18, jnp.float32))
    res_t = bfgs.minimize(bfgs.value_and_grad(svm_loss(
        torch.as_tensor(H), torch.as_tensor(y), torch.as_tensor(w), 1.0)),
        torch.zeros(18), maxiter=2000)
    print(f"BFGS steps: jax {int(res_j.nit)}, port {res_t.nit}")
    assert res_t.fun == pytest.approx(float(res_j.fun), rel=1e-6)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               atol=1e-4)


def surv_cols(n=640, seed=0, ties=True, strata=False, start=False,
              weights=False):
    """Exponential survival times with hazard exp(0.5 x1 - 0.8 x2 +
    0.4 [g == b]), 25% censored, rounded to tenths (ties) or not."""
    rng = np.random.default_rng(seed)
    x1, x2 = rng.standard_normal(n), rng.standard_normal(n)
    g = np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)]
    eta = 0.5 * x1 - 0.8 * x2 + 0.4 * (g == "b")
    t = rng.exponential(1.0 / np.exp(eta))
    if ties:
        t = np.round(t, 1) + 0.1
    ev = (rng.random(n) > 0.25).astype(float)
    cols = {"x1": (x1, None), "x2": (x2, None), "g": (g, "enum"),
            "t": (t, None), "event": (ev, None)}
    if strata:
        cols["s"] = (np.array(["p", "q"], object)[rng.integers(0, 2, n)],
                     "enum")
    if start:
        cols["t0"] = (np.minimum(rng.uniform(0, 0.3, n), t * 0.5), None)
    if weights:
        cols["w"] = (rng.integers(1, 3, n).astype(float), None)
    return cols


@pytest.mark.parametrize("case,kw", [
    ("efron", {}),
    ("breslow", {"ties": "breslow"}),
    ("strata", {"stratify_by": ["s"]}),
    ("start", {"start_column": "t0"}),
    ("weights", {"weights_column": "w"}),
])
def test_coxph_matches_jax(cl, case, kw):
    from h2o3_tpu.models.coxph import CoxPH as JC

    cols = surv_cols(strata=case == "strata", start=case == "start",
                     weights=case == "weights")
    jf, tf = both_frames(cols)
    kw = dict(kw, stop_column="t")
    jm = JC(**kw).train(y="event", training_frame=jf)
    tm = th.CoxPH(**kw).train(y="event", training_frame=tf)
    assert list(tm.coefficients) == list(jm.coefficients)
    np.testing.assert_allclose(list(tm.coefficients.values()),
                               list(jm.coefficients.values()), atol=2e-3)
    assert tm.loglik == pytest.approx(jm.loglik, rel=1e-6)
    assert tm.loglik_null == pytest.approx(jm.loglik_null, rel=1e-6)
    assert tm.concordance == pytest.approx(jm.concordance, abs=1e-4)
    np.testing.assert_allclose(tm.baseline_hazard, jm.baseline_hazard,
                               rtol=2e-3)
    jp = np.asarray(jm.predict(jf).col("predict").data)[:jf.nrows]
    np.testing.assert_allclose(tm.predict(tf).col("predict").data.numpy(),
                               jp, atol=1e-2)
    assert tm._output.model_category == "CoxPH"
    assert 1 <= tm.iterations <= 20


def test_coxph_recovers_the_truth(cl):
    _, tf = both_frames(surv_cols(n=6400, seed=3, ties=False))
    m = th.CoxPH(stop_column="t").train(y="event", training_frame=tf)
    c = m.coefficients
    assert c["x1"] == pytest.approx(0.5, abs=0.08)
    assert c["x2"] == pytest.approx(-0.8, abs=0.08)
    assert c["g.b"] == pytest.approx(0.4, abs=0.12)
    assert m.concordance > 0.6


def test_psvm_matches_jax(cl):
    from h2o3_tpu.core.dkv import DKV as JDKV
    from h2o3_tpu.models.psvm import PSVM as JP

    jf, tf = both_frames(svm_cols())
    kw = dict(hyper_param=1.0, seed=1)
    jm = JP(**kw).train(y="y", training_frame=jf)
    tm = th.PSVM(**kw).train(y="y", training_frame=tf)
    # the same pivot rows (the designs agree to an ulp)
    np.testing.assert_allclose(tm.pivots, jm.pivots, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tm.icf_L, jm.icf_L, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.beta, jm.beta, atol=1e-3)
    jd = np.asarray(jm._predict_raw(jm.adapt_test(jf))["decision"])[:640]
    td = tm._predict_raw(tm.adapt_test(tf))["decision"].numpy()
    np.testing.assert_allclose(td, jd, atol=1e-3)
    assert (tm.svs_count, tm.bsv_count) == (jm.svs_count, jm.bsv_count)
    assert tm.rho == pytest.approx(jm.rho, abs=1e-3)
    ja = np.asarray(JDKV.get(jm.alpha_key).col("alpha").data)[:640]
    np.testing.assert_allclose(th.DKV.get(tm.alpha_key).col("alpha")
                               .data.numpy(), ja, atol=1e-2)
    assert tm._output.training_metrics.auc > 0.85


def test_psvm_refuses_a_non_binary_response(cl):
    cols = svm_cols(n=64)
    cols["y"] = (np.array(["a", "b", "c"] * 21 + ["a"], object), "enum")
    _, tf = both_frames(cols)
    with pytest.raises(ValueError, match="binary"):
        th.PSVM().train(y="y", training_frame=tf)
