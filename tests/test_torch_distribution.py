"""Every distribution family of the port (models/distribution.py) against
the JAX package's on the same numpy inputs: link and inverse link, the
negative half-gradient (tree residuals), the leaf Newton-step rows, the
prior rows with and without an offset, and the per-row deviance, all
rtol 1e-6; and the family lookup.

Tweedie's deviance is a sum of three powers that cancel to near zero
where mu is near y; XLA's pow and torch's differ by an ulp, so its
rtol 1e-6 is taken against the size of the terms the formula sums, not
against their near-zero sum."""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.models import distribution as tdist

# (name, get_distribution keywords, response kind)
FAMILIES = [
    ("gaussian", {}, "real"), ("bernoulli", {}, "binary"),
    ("quasibinomial", {}, "binary"), ("poisson", {}, "count"),
    ("gamma", {}, "positive"), ("tweedie", {"tweedie_power": 1.3}, "count"),
    ("laplace", {}, "real"), ("quantile", {"quantile_alpha": 0.2}, "real"),
    ("huber", {}, "real")]


def _inputs(kind, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.uniform(-2.5, 2.5, n).astype(np.float32)
    w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    w[:50] = 0.0
    o = (0.3 * rng.standard_normal(n)).astype(np.float32)
    y = {"real": rng.standard_normal(n) * 3,
         "binary": rng.integers(0, 2, n),
         "count": rng.poisson(2.0, n),
         "positive": rng.gamma(2.0, 1.5, n) + 1e-3}[kind].astype(np.float32)
    # the exact ties of the piecewise families (y == f, |y - f| == delta)
    if kind == "real":
        y[50:60] = f[50:60]
        y[60:70] = f[60:70] + 1.0
    return y, f, w, o


def _close(got, ref, what, scale=None):
    got, ref = got.numpy(), np.asarray(ref)
    if scale is None:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                   err_msg=what)
    else:
        bad = np.abs(got - ref) > 1e-6 * scale + 1e-6
        assert not bad.any(), (what, got[bad][:5], ref[bad][:5])


def _tweedie_terms(w, y, f, p):
    """2w times the sum of |each term| of the tweedie deviance."""
    y, mu = y.astype(np.float64), np.exp(f.astype(np.float64))
    return 2 * w * (np.abs(np.maximum(y, 0) ** (2 - p) / ((1 - p) * (2 - p)))
                    + np.abs(y * mu ** (1 - p) / (1 - p))
                    + np.abs(mu ** (2 - p) / (2 - p)))


@pytest.mark.parametrize("name,kw,kind", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_family_functions_match_jax(name, kw, kind):
    import jax.numpy as jnp

    from h2o3_tpu.models import distribution as jdist

    jd = jdist.get_distribution(name, **kw)
    td = tdist.get_distribution(name, **kw)
    assert td.name == jd.name
    y, f, w, o = _inputs(kind)
    t = torch.as_tensor
    _close(td.linkinv(t(f)), jd.linkinv(jnp.asarray(f)), "linkinv")
    mu = np.clip(np.abs(f) / 3 + 0.05, 0.05, 0.95).astype(np.float32)
    _close(td.link(t(mu)), jd.link(jnp.asarray(mu)), "link")
    z_ref = jd.neg_half_gradient(jnp.asarray(y), jnp.asarray(f))
    z = td.neg_half_gradient(t(y), t(f))
    _close(z, z_ref, "neg_half_gradient")
    args = (t(w), t(y), z, t(f))
    jargs = (jnp.asarray(w), jnp.asarray(y), z_ref, jnp.asarray(f))
    _close(td.gamma_num(*args), jd.gamma_num(*jargs), "gamma_num")
    _close(td.gamma_denom(*args), jd.gamma_denom(*jargs), "gamma_denom")
    for off in (np.zeros_like(o), o):
        _close(td.init_f_num(t(w), t(y), t(off)),
               jd.init_f_num(jnp.asarray(w), jnp.asarray(y), jnp.asarray(off)),
               "init_f_num")
        _close(td.init_f_denom(t(w), t(y), t(off)),
               jd.init_f_denom(jnp.asarray(w), jnp.asarray(y),
                               jnp.asarray(off)), "init_f_denom")
    scale = (_tweedie_terms(w, y, f, td.power) if name == "tweedie"
             else None)
    _close(td.deviance(t(w), t(y), t(f)),
           jd.deviance(jnp.asarray(w), jnp.asarray(y), jnp.asarray(f)),
           "deviance", scale)


def test_multinomial_family_and_lookup():
    import jax.numpy as jnp

    from h2o3_tpu.models import distribution as jdist

    f = np.linspace(-3, 3, 11).astype(np.float32)
    _close(tdist.get_distribution("multinomial").linkinv(torch.as_tensor(f)),
           jdist.get_distribution("multinomial").linkinv(jnp.asarray(f)),
           "multinomial linkinv")
    assert tdist.get_distribution("binomial").name == "bernoulli"
    assert tdist.get_distribution("Tweedie", tweedie_power=1.7).power == 1.7
    assert tdist.get_distribution("quantile", quantile_alpha=0.9).alpha == 0.9
    assert tdist.get_distribution("huber").delta == 1.0
    with pytest.raises(ValueError):
        tdist.get_distribution("modified_huber")
    with pytest.raises(ValueError):
        tdist.get_distribution("tweedie", tweedie_power=2.5)
    assert tdist.auto_distribution("enum", 2) == "bernoulli"
    assert tdist.auto_distribution("enum", 4) == "multinomial"
    assert tdist.auto_distribution("real", 1) == "gaussian"
