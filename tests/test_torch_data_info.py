"""Column rollups and DataInfo in the port (on the CPU) against the JAX
package on the same numpy fixture.

Tolerances: rollup min, max, NA and nonzero counts equal; mean and sigma
rel 1e-6 (both packages sum in float32, the JAX package as 8 shard
partials plus a psum, the port in one pass). The expanded design matrix
is bitwise equal where it reads no rollup (no NAs to impute and no
standardisation) and equal to 1e-6 elsewhere; modes, NA row masks and
coefficient names are equal."""

import jax
import numpy as np
import pytest

from h2o3_tpu_torch.models.data_info import DataInfo as TDataInfo

from torch_port_support import both_frames


def _cols(n=640, seed=3, na=True):
    """Two numerics (one with a wide range and exact zeros), an integer
    column, two categoricals (one with a mode tie broken by the first
    level) and a string column DataInfo skips."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 3 + 1
    u = np.round(rng.exponential(50.0, n), 0)
    k = rng.integers(-5, 6, n).astype(float)
    g = np.array(["a", "b", "c", "d"], object)[rng.integers(0, 4, n)]
    h = np.array(["p", "q"], object)[np.arange(n) % 2]
    if na:
        x[rng.random(n) < 0.1] = np.nan
        u[rng.random(n) < 0.05] = np.nan
        g[rng.random(n) < 0.1] = None
    return {"x": (x, None), "u": (u, None), "k": (k, "int"),
            "g": (g, "enum"), "h": (h, "enum"),
            "s": (np.array([f"r{i}" for i in range(n)], object), None)}


@pytest.mark.parametrize("name", ["x", "u", "k", "g", "h"])
def test_rollups_match_jax(cl, name):
    jf, tf = both_frames(_cols())
    j, t = jf.col(name).rollups, tf.col(name).rollups
    assert (t.min, t.max) == (j.min, j.max)
    assert (t.na_count, t.nz_count, t.rows) == (j.na_count, j.nz_count,
                                                 j.rows)
    assert t.mean == pytest.approx(j.mean, rel=1e-6)
    assert t.sigma == pytest.approx(j.sigma, rel=1e-6)


def test_rollups_of_an_all_na_and_a_constant_column(cl):
    n = 128
    jf, tf = both_frames({"a": (np.full(n, np.nan), None),
                          "c": (np.full(n, 2.5), None)})
    a = tf.col("a").rollups
    assert a.rows == 0 and a.na_count == n and np.isnan(a.mean)
    for name in ("a", "c"):
        j, t = jf.col(name).rollups, tf.col(name).rollups
        for k in ("min", "max", "mean", "sigma"):
            jv, tv = getattr(j, k), getattr(t, k)
            assert (np.isnan(jv) and np.isnan(tv)) or tv == jv, (name, k)


def _pair(jf, tf, **kw):
    from h2o3_tpu.models.data_info import DataInfo as JDataInfo

    return JDataInfo(jf, **kw), TDataInfo(tf, **kw)


def _expand(jdi, tdi, jf, tf):
    n = tf.nrows
    je = np.asarray(jax.jit(jdi.expand)(*(c.data for c in jdi.cols(jf))))
    te = tdi.expand(*(c.data for c in tdi.cols(tf))).numpy()
    return je[:n], te


@pytest.mark.parametrize("use_all", [False, True])
@pytest.mark.parametrize("na,standardize", [(False, False), (False, True),
                                            (True, False), (True, True)])
def test_expand_matches_jax(cl, na, standardize, use_all):
    jf, tf = both_frames(_cols(na=na))
    jdi, tdi = _pair(jf, tf, standardize=standardize,
                     use_all_factor_levels=use_all)
    assert tdi.predictor_names == jdi.predictor_names == ["g", "h", "x", "u",
                                                          "k"]
    assert tdi.coef_names() == jdi.coef_names()
    assert (tdi.fullN, tdi.num_offset) == (jdi.fullN, jdi.num_offset)
    np.testing.assert_array_equal(tdi.cat_offsets, jdi.cat_offsets)
    np.testing.assert_array_equal(tdi.cat_modes, jdi.cat_modes)
    np.testing.assert_allclose(tdi.num_means, jdi.num_means, rtol=1e-6)
    np.testing.assert_allclose(tdi.num_sigmas, jdi.num_sigmas, rtol=1e-6)
    je, te = _expand(jdi, tdi, jf, tf)
    assert te.dtype == np.float32 and te.shape == je.shape
    if not na and not standardize:
        assert te.tobytes() == je.tobytes()
    else:
        np.testing.assert_allclose(te, je, rtol=1e-6, atol=1e-6)


def test_mode_na_row_mask_and_layout_switch(cl):
    jf, tf = both_frames(_cols(seed=11))
    jdi, tdi = _pair(jf, tf, ignored=["k"], response="u")
    assert tdi.predictor_names == jdi.predictor_names == ["g", "h", "x"]
    # h alternates p, q: a tie, broken by the first level
    assert list(tdi.cat_modes) == list(jdi.cat_modes)
    assert tdi.cat_modes[1] == 0
    n = tf.nrows
    jm = np.asarray(jdi.na_row_mask(*(c.data for c in jdi.cols(jf))))[:n]
    tm = tdi.na_row_mask(*(c.data for c in tdi.cols(tf))).numpy()
    np.testing.assert_array_equal(tm, jm)
    assert 0 < tm.sum() < n
    for flag in (True, False):
        jdi.set_use_all_factor_levels(flag)
        tdi.set_use_all_factor_levels(flag)
        assert tdi.coef_names() == jdi.coef_names()
        assert tdi.fullN == jdi.fullN


def test_from_state_expands_bitwise(cl):
    """A DataInfo rebuilt from its plain state expands as the original."""
    _, tf = both_frames(_cols(seed=5))
    tdi = TDataInfo(tf, standardize=True)
    state = {k: getattr(tdi, k) for k in
             ("standardize", "cat_names", "num_names", "domains", "cards",
              "use_all_factor_levels", "num_means", "num_sigmas",
              "cat_modes", "impute_values")}
    back = TDataInfo.from_state(state)
    arrays = [c.data for c in tdi.cols(tf)]
    assert back.coef_names() == tdi.coef_names()
    assert back.expand(*arrays).numpy().tobytes() == \
        tdi.expand(*arrays).numpy().tobytes()


@pytest.mark.parametrize("kw", [{"weights": "u"}, {"offset": "x"},
                                {"weights": "u", "offset": "x",
                                 "response": "k"}])
def test_weights_and_offset_are_never_predictors(cl, kw):
    """The reference's DataInfo arguments (data_info.py:53-65): the
    weights and offset columns drop out of the design like the
    response, in the same layout as the JAX package's."""
    jf, tf = both_frames(_cols(na=False))
    jdi, tdi = _pair(jf, tf, **kw)
    skip = {v for v in kw.values()}
    assert not skip & set(tdi.predictor_names)
    assert tdi.predictor_names == jdi.predictor_names
    assert tdi.coef_names() == jdi.coef_names()
    assert (tdi.weights_name, tdi.offset_name) == (kw.get("weights"),
                                                   kw.get("offset"))
    je, te = _expand(jdi, tdi, jf, tf)
    np.testing.assert_allclose(te, je, rtol=1e-6, atol=1e-6)


def test_missing_values_handling_is_kept(cl):
    _, tf = both_frames(_cols())
    assert TDataInfo(tf).missing_values_handling == "MeanImputation"
    assert TDataInfo(tf, missing_values_handling="Skip"
                     ).missing_values_handling == "Skip"
