"""The port's Threefry-2x32 (core/random.py) against jax.random with
jax_threefry_partitionable on: keys, fold_in and uniform bitwise over
several seeds, counters t and odd and large n; and the row samples of
the tree builders bitwise against the reference's own draws."""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.core import random as rnd
from h2o3_tpu_torch.models.tree.shared_tree import sample_mask


def _jax_key_words(key):
    import jax

    return np.asarray(jax.random.key_data(key)).astype(np.int64).tolist()


def test_partitionable_threefry_is_on():
    import jax

    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 3, 12345, 2 ** 31 - 1])
def test_key_and_fold_in_bitwise(seed):
    import jax

    jk = jax.random.PRNGKey(seed)
    assert rnd.PRNGKey(seed).tolist() == _jax_key_words(jk)
    for t in (0, 1, 2, 49, 1000, 2 ** 31 - 1):
        got = rnd.fold_in(rnd.PRNGKey(seed), t).tolist()
        assert got == _jax_key_words(jax.random.fold_in(jk, np.int32(t))), t


@pytest.mark.parametrize("seed,t,n", [
    (0, 0, 1), (1, 3, 7), (3, 1, 1001), (12345, 49, 65_537),
    (2 ** 31 - 1, 7, 200_003), (42, 0, 1_000_000)])
def test_uniform_bitwise(seed, t, n):
    import jax

    jk = jax.random.fold_in(jax.random.PRNGKey(seed), np.int32(t))
    ref = np.asarray(jax.random.uniform(jk, (n,)))
    got = rnd.uniform(rnd.fold_in(rnd.PRNGKey(seed), t), n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert got.numpy().tobytes() == ref.tobytes()
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def test_uniform_of_a_shape_is_the_flat_draw_reshaped():
    import jax

    key = rnd.PRNGKey(9)
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (37, 5)))
    got = rnd.uniform(key, (37, 5))
    assert got.shape == (37, 5)
    assert got.numpy().tobytes() == ref.tobytes()
    # element i depends on i alone: a padded draw starts with the same rows
    assert torch.equal(rnd.uniform(key, 400)[:37 * 5], got.reshape(-1))


@pytest.mark.parametrize("rate", [0.632, 0.5])
def test_tree_row_sample_bitwise_vs_the_reference(cl, rate):
    """GBM's (`_pre_fn`) and DRF's (`_drf_step_fns`) row samples over a
    padded column: the port's mask over the real rows is the head of the
    reference's."""
    import jax

    from h2o3_tpu.models.distribution import get_distribution
    from h2o3_tpu.models.tree.drf import _drf_step_fns
    from h2o3_tpu.models.tree.shared_tree import _pre_fn

    n, n_pad = 1000, 1024
    y = jax.numpy.zeros(n_pad, jax.numpy.float32)
    w = jax.numpy.ones(n_pad, jax.numpy.float32)
    key = jax.random.PRNGKey(5)
    pre = _pre_fn(get_distribution("gaussian"), True)
    drf_pre, _ = _drf_step_fns(True)
    for t in (0, 1, 17):
        mine = sample_mask(rnd.PRNGKey(5), t, n, rate, "cpu").numpy()
        gbm_mask = np.asarray(pre(y, y, w, key, np.int32(t), rate)[4])
        drf_mask = np.asarray(drf_pre(w, key, np.int32(t), rate)[0])
        np.testing.assert_array_equal(mine, gbm_mask[:n])
        np.testing.assert_array_equal(mine, drf_mask[:n])
        assert 0.3 < mine.mean() < 0.8


# --- split, bernoulli, randint (DeepLearning's draws) -------------------

@pytest.mark.parametrize("seed", [0, 5, 12345, 2 ** 31 - 1])
def test_split_bitwise(seed):
    import jax

    jk = jax.random.PRNGKey(seed)
    for num in (2, 3, 7):
        got = rnd.split(rnd.PRNGKey(seed), num)
        assert got.tolist() == _jax_key_words(jax.random.split(jk, num))
    # split(key, n)[i] is fold_in(key, i)
    assert rnd.split(rnd.PRNGKey(seed), 3)[2].tolist() == \
        rnd.fold_in(rnd.PRNGKey(seed), 2).tolist()


@pytest.mark.parametrize("seed,shape,p", [
    (0, (32, 15), 0.8), (7, (5, 200), 0.5), (2 ** 31 - 1, (1000,), 0.1),
    (99, (3, 4, 5), 1.0 - 0.3)])
def test_bernoulli_bitwise(seed, shape, p):
    import jax

    ref = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p,
                                          shape))
    got = rnd.bernoulli(rnd.PRNGKey(seed), p, shape)
    assert got.dtype == torch.bool and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 3, 12345, 2 ** 31 - 1])
@pytest.mark.parametrize("lo,hi", [
    (0, 640), (0, 1000), (0, 65_536), (0, 65_537), (0, 70_001),
    (0, 1_000_003), (5, 2 ** 31 - 1), (-7, 9), (4, 4)])
def test_randint_bitwise(seed, lo, hi):
    """Spans below, at and above 2**16 (where the uint32 square wraps to
    0), not powers of two, a negative minval and an empty range."""
    import jax

    for shape in ((32,), (4, 9)):
        ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                            lo, hi))
        got = rnd.randint(rnd.PRNGKey(seed), shape, lo, hi)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), ref)


def test_batched_keys_draw_as_each_key_alone():
    """A (S, 2) batch of keys draws what each key draws alone: one
    vectorised call makes a chunk of steps' draws."""
    keys = torch.stack([rnd.fold_in(rnd.PRNGKey(11), t) for t in range(6)])
    rows = rnd.randint(keys, (32,), 0, 70_001)
    masks = rnd.bernoulli(keys, 0.7, (3, 5))
    subs = rnd.split(keys, 3)
    for t in range(6):
        assert torch.equal(rows[t], rnd.randint(keys[t], (32,), 0, 70_001))
        assert torch.equal(masks[t], rnd.bernoulli(keys[t], 0.7, (3, 5)))
        assert torch.equal(subs[t], rnd.split(keys[t], 3))
        assert torch.equal(rnd.fold_in(keys, 4)[t], rnd.fold_in(keys[t], 4))


def test_host_key_chain_is_the_split_loop():
    """native.split_chain (csrc/threefry.cpp) walks key <- split(key,
    3)[0] exactly as a loop of split does, and as jax.random does."""
    import jax

    from h2o3_tpu_torch import native

    steps = 40
    sub, last = native.split_chain(rnd.PRNGKey(2024), steps, 3)
    assert sub.shape == (steps, 2, 2)
    key, jkey = rnd.PRNGKey(2024), jax.random.PRNGKey(2024)
    for s in range(steps):
        ks = rnd.split(key, 3)
        jkey, kidx, kdrop = jax.random.split(jkey, 3)
        assert sub[s, 0].tolist() == ks[1].tolist() == _jax_key_words(kidx)
        assert sub[s, 1].tolist() == ks[2].tolist() == _jax_key_words(kdrop)
        key = ks[0]
    assert last.tolist() == key.tolist() == _jax_key_words(jkey)
