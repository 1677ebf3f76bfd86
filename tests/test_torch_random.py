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
