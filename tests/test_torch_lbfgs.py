"""The port's L-BFGS (h2o3_tpu_torch/optim/lbfgs.py) against optax.lbfgs(),
the optimizer the JAX package's multinomial and ordinal GLM run
(h2o3_tpu/models/glm.py:343-362), step by step on the CPU.

Both run the GLM's loop (value and gradient reused from the line
search's state, a step while it == 0 or |g| > 1e-6) from the same start.
Tolerance: every iterate of the first 6-8 steps within 1e-4 relative of
optax's (both work in float32, and XLA's reduction order and fused
multiply-adds are not torch's, so the iterates agree to rounding, not
bit for bit), and the end point within the tolerance each case states."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from h2o3_tpu_torch.optim import lbfgs as tl

STEP_RTOL = 1e-4


def _optax_trace(loss, x0, max_iter):
    """optax.lbfgs() driven as glm.py:346-362 drives it, iterate by
    iterate."""
    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(loss)

    @jax.jit
    def step(x, state):
        value, grad = vg(x, state=state)
        updates, state = opt.update(grad, state, x, value=value, grad=grad,
                                    value_fn=loss)
        return optax.apply_updates(x, updates), state

    x, state, out = jnp.asarray(x0), opt.init(jnp.asarray(x0)), []
    for it in range(max_iter):
        g = optax.tree_utils.tree_get(state, "grad")
        if it > 0 and not float(optax.tree_utils.tree_norm(g)) > 1e-6:
            break
        x, state = step(x, state)
        out.append(np.asarray(x))
    return out


def _port_trace(loss, x0, max_iter):
    trace = []
    x, iters = tl.minimize(tl.value_and_grad(loss), torch.as_tensor(x0),
                           max_iter, trace=trace)
    assert iters == len(trace)
    return [t.numpy() for t in trace]


def _rosenbrock_jax(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosenbrock_torch(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _softmax_data(seed=0, n=512, p=6, K=4):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.standard_normal((n, p)), np.ones((n, 1))],
                       1).astype(np.float32)
    B = rng.standard_normal((p + 1, K))
    logits = X @ B + rng.standard_normal((n, K))
    y = np.argmax(logits, 1).astype(np.int64)
    w = (rng.random(n) + 0.5).astype(np.float32)
    return X, y, w


def _softmax_losses(X, y, w, lam):
    wsum = float(w.sum())
    Xj, yj, wj = jnp.asarray(X), jnp.asarray(y), jnp.asarray(w)
    Xt, yt, wt = torch.as_tensor(X), torch.as_tensor(y), torch.as_tensor(w)

    def jloss(B):
        logits = Xj @ B
        lse = jax.scipy.special.logsumexp(logits, axis=-1)
        nll = jnp.sum(wj * (lse - logits[jnp.arange(len(y)), yj])) / wsum
        return nll + 0.5 * lam * jnp.sum(B[:-1] ** 2) / wsum

    def tloss(B):
        logits = Xt @ B
        lse = torch.logsumexp(logits, -1)
        picked = torch.gather(logits, 1, yt[:, None])[:, 0]
        nll = torch.sum(wt * (lse - picked)) / wsum
        return nll + 0.5 * lam * torch.sum(B[:-1] ** 2) / wsum

    return jloss, tloss


@pytest.mark.parametrize("x0", [[-1.2, 1.0], [-1.5, 2.0, 0.5, -0.3]])
def test_rosenbrock_matches_optax_step_by_step(x0):
    x0 = np.asarray(x0, np.float32)
    ref = _optax_trace(_rosenbrock_jax, x0, 100)
    got = _port_trace(_rosenbrock_torch, x0, 100)
    for i, (a, b) in enumerate(zip(ref[:8], got[:8])):
        np.testing.assert_allclose(b, a, rtol=STEP_RTOL, atol=1e-6,
                                   err_msg=f"step {i}")
    # the two end at the same point to 1e-5 (in 2-d the minimum (1, 1);
    # in 4-d the local minimum near (-0.776, 0.613, 0.382, 0.146), where
    # float32 gradients stay above 1e-6 until max_iter); the step counts
    # may differ by a few once rounding has moved the iterates apart
    np.testing.assert_allclose(got[-1], ref[-1], atol=1e-5)
    assert abs(len(got) - len(ref)) <= 3


@pytest.mark.parametrize("lam", [0.0, 5.0])
def test_softmax_loss_matches_optax_step_by_step(lam):
    X, y, w = _softmax_data()
    jloss, tloss = _softmax_losses(X, y, w, lam)
    B0 = np.zeros((X.shape[1], 4), np.float32)
    ref = _optax_trace(jloss, B0, 50)
    got = _port_trace(tloss, B0, 50)
    for i, (a, b) in enumerate(zip(ref[:6], got[:6])):
        np.testing.assert_allclose(b, a, rtol=STEP_RTOL, atol=1e-5,
                                   err_msg=f"step {i}")
    # the end points: the same loss to 1e-6 relative
    lj = float(jloss(jnp.asarray(ref[-1])))
    lt = float(tloss(torch.as_tensor(got[-1])))
    assert lt == pytest.approx(lj, rel=1e-6)


def test_first_step_is_capped_to_the_unit_ball():
    """At the first step the identity is scaled by min(1, 1/|g|), and the
    line search's first guess is 1, so a quadratic with a large gradient
    moves by at most 1 before the search extends the step."""
    vg = tl.value_and_grad(lambda x: 0.5 * torch.sum(x * x))
    mem = tl._Memory(torch.zeros(3))
    x = torch.tensor([30.0, -40.0, 0.0])
    d = mem.direction(vg(x)[1], x)
    assert float(torch.linalg.vector_norm(d)) == pytest.approx(1.0, rel=1e-6)


def test_stops_at_max_iter_and_at_a_zero_gradient():
    vg = tl.value_and_grad(lambda x: torch.sum((x - 2.0) ** 2))
    x, it = tl.minimize(vg, torch.zeros(2), 1)
    assert it == 1
    x, it = tl.minimize(vg, torch.zeros(2), 50)
    np.testing.assert_allclose(x.numpy(), [2.0, 2.0], atol=1e-6)
    assert it < 50
