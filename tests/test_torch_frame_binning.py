"""Port frames and binning: Column/Frame round-trips, and BinSpec edges,
bin counts, offsets, padded edges and the bin matrix BITWISE equal to the
JAX package's on the same numpy data."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch.models.tree.binning import BinSpec as TBinSpec

from torch_port_support import both_frames, flagship_cols


def test_frame_round_trip_real_and_enum_columns():
    th.init(device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal(50)
    x[[3, 7]] = np.nan
    codes = rng.integers(0, 3, 50).astype(float)
    codes[5] = np.nan
    labels = np.array(["b", "a", None, "c", "a"] * 10, object)
    wide_dom = [f"L{i:03d}" for i in range(200)]
    fr = th.Frame()
    fr.add("x", th.Column.from_numpy(x))
    fr.add("k", th.Column.from_numpy(codes, ctype="enum",
                                     domain=["p", "q", "r"]))
    fr.add("s", th.Column.from_numpy(labels, ctype="enum"))
    fr.add("w", th.Column.from_numpy(rng.integers(0, 200, 50), ctype="enum",
                                     domain=wide_dom))
    assert fr.names == ["x", "k", "s", "w"] and fr.nrows == 50
    assert fr.ncols == 4 and "k" in fr and "zz" not in fr
    got = fr.col("x").to_numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.astype(np.float32))
    k = fr.col("k")
    assert k.data.dtype == torch.int8 and k.to_numpy()[5] == -1
    assert list(k.values()[:3]) == [["p", "q", "r"][int(c)]
                                    for c in codes[:3]]
    s = fr.col("s")
    assert s.domain == ["a", "b", "c"] and s.to_numpy()[2] == -1
    assert s.values()[2] is None and s.values()[0] == "b"
    w = fr.col("w")
    assert w.data.dtype == torch.int16 and w.cardinality > 126
    sub = fr.subframe(["s", "x"])
    assert sub.names == ["s", "x"] and sub.col("x") is fr.col("x")
    assert fr.to_numpy().shape == (50, 4)
    with pytest.raises(ValueError):
        fr.add("x", th.Column.from_numpy(x))
    with pytest.raises(ValueError):
        fr.add("short", th.Column.from_numpy(x[:10]))


def _binning_cases():
    rng = np.random.default_rng(3)
    n = 1500
    x = rng.standard_normal(n) * 10
    x[rng.random(n) < 0.3] = np.nan
    wide = np.array([f"v{i:02d}" for i in rng.integers(0, 40, n)], object)
    wide[rng.random(n) < 0.05] = None
    return {
        "nans": ({"x": (x, None), "u": (rng.random(n), None)}, {}),
        "constant": ({"c": (np.full(n, 2.5), None),
                      "x": (rng.standard_normal(n), None)}, {}),
        "cat_past_nbins_cats": ({"w": (wide, "enum"),
                                 "x": (x, None)}, {"nbins_cats": 16}),
        "coarse_nbins": ({"x": (rng.standard_normal(n), None),
                          "i": (rng.integers(0, 5, n), None)}, {"nbins": 7}),
        "flagship_5k": (flagship_cols(5000), {}),
    }


@pytest.mark.parametrize("case", sorted(_binning_cases()))
def test_binspec_and_bin_matrix_bitwise_vs_jax(cl, case):
    from h2o3_tpu.models.tree.binning import BinSpec as JBinSpec

    cols, kw = _binning_cases()[case]
    jf, tf = both_frames(cols)
    names = [c for c in cols if c != "y"]
    js = JBinSpec.build(jf, names, **kw)
    ts = TBinSpec.build(tf, names, **kw)
    np.testing.assert_array_equal(ts.is_cat, js.is_cat)
    np.testing.assert_array_equal(ts.nbins, js.nbins)
    np.testing.assert_array_equal(ts.offsets, js.offsets)
    np.testing.assert_array_equal(ts.cards, js.cards)
    assert len(ts.edges) == len(js.edges)
    for te, je in zip(ts.edges, js.edges):
        assert te.dtype == je.dtype == np.float32
        assert te.tobytes() == je.tobytes()
    assert ts.padded_edges().tobytes() == js.padded_edges().tobytes()
    jb = np.asarray(js.bin_columns(jf))[: tf.nrows]
    tb = ts.bin_columns(tf).numpy()
    assert tb.dtype == jb.dtype
    np.testing.assert_array_equal(tb, jb)
