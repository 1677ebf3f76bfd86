"""Column quantiles in the port (h2o3_tpu_torch/ops/quantile.py, on the
CPU) against the JAX package's `quantile_column`: the same histogram
refinement over float32 bounds with exact counts, so every quantile is
bitwise equal, with ties, NaNs, constant and all-NA columns, and the
knot probabilities GAM asks for."""

import numpy as np
import pytest

from h2o3_tpu_torch.ops.quantile import quantile_column as tquantile

from torch_port_support import both_frames

GAM_PROBS = np.linspace(0.02, 0.98, 7).tolist()
PROBS = [0.0, 0.001, 0.1, 0.25, 0.5, 0.75, 0.9, 0.999, 1.0] + GAM_PROBS


def _columns(n=1280, seed=0):
    rng = np.random.default_rng(seed)
    ties = rng.integers(0, 5, n).astype(float)          # heavy ties
    nans = rng.standard_normal(n) * 1e3
    nans[rng.random(n) < 0.2] = np.nan
    narrow = 1.0 + rng.standard_normal(n) * 1e-6       # float32 spacing
    return {"normal": rng.standard_normal(n),
            "lognormal": rng.lognormal(0.0, 2.0, n),
            "ties": ties, "nans": nans, "narrow": narrow,
            "uniform_int": rng.integers(-50, 50, n).astype(float),
            "constant": np.full(n, 2.5), "all_na": np.full(n, np.nan)}


@pytest.mark.parametrize("name", sorted(_columns()))
def test_quantiles_bitwise_equal_jax(cl, name):
    from h2o3_tpu.ops.quantile import quantile_column as jquantile

    arr = _columns()[name]
    jf, tf = both_frames({name: (arr, None)})
    j = np.asarray(jquantile(jf.col(name), PROBS), np.float64)
    t = np.asarray(tquantile(tf.col(name), PROBS), np.float64)
    assert t.tobytes() == j.tobytes(), (name, t - j)


def test_quantiles_match_numpy_type7(cl):
    """Type-7 interpolation of the exact order statistics: numpy's
    default quantile of the float32 values, to float64 rounding."""
    arr = _columns(seed=3)["nans"]
    _, tf = both_frames({"x": (arr, None)})
    got = tquantile(tf.col("x"), PROBS)
    vals = arr.astype(np.float32).astype(np.float64)
    want = np.nanquantile(vals, PROBS)
    np.testing.assert_allclose(got, want, rtol=1e-12)
