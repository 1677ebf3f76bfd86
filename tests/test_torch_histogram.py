"""The level-wise tree path in the port (on the CPU) against the JAX
package: the uniform binning strategy, `build_histogram` over ragged
per-feature offsets, the host split search, `route_rows`, `leaf_stats`
and the public single-tree `grow_tree`.

Tolerances: uniform edges, bin counts and bins bitwise (min and max are
exact, and both packages take the edges from np.linspace in float64);
the histogram's w channel bitwise with integral weights (sums of
integers are exact in both) and its wy and wyy channels rel 1e-6 (the
port sums in int64 fixed point, the JAX package in float32); split
tables and routing bitwise from one histogram; leaf sums rel 1e-6;
grown trees equal in structure with node statistics rel 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu_torch.models.tree import dtree as tdtree
from h2o3_tpu_torch.models.tree import histogram as thist
from h2o3_tpu_torch.models.tree.binning import BinSpec as TBinSpec
from h2o3_tpu_torch.models.tree.shared_tree import grow_tree as t_grow_tree

from torch_port_support import both_frames


def _cols(n=640, seed=0):
    """A NaN-laced numeric, a wide numeric, an all-NaN and a constant
    column, and a 5-level categorical."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    x[rng.random(n) < 0.1] = np.nan
    u = rng.exponential(100.0, n)
    g = np.array(list("abcde"), object)[rng.integers(0, 5, n)]
    return {"x": (x, None), "u": (u, None),
            "a": (np.full(n, np.nan), None), "c": (np.full(n, 4.0), None),
            "g": (g, "enum")}


def _specs(jf, tf, names, nbins=64):
    from h2o3_tpu.models.tree.binning import BinSpec as JBinSpec

    return (JBinSpec.build(jf, names, nbins=nbins, strategy="uniform"),
            TBinSpec.build(tf, names, nbins=nbins, strategy="uniform"))


def _assert_same_spec(js, ts):
    np.testing.assert_array_equal(ts.nbins, js.nbins)
    np.testing.assert_array_equal(ts.offsets, js.offsets)
    np.testing.assert_array_equal(ts.is_cat, js.is_cat)
    for je, te in zip(js.edges, ts.edges):
        assert te.dtype == np.float32
        assert te.tobytes() == np.asarray(je).tobytes()


@pytest.mark.parametrize("nbins", [16, 64, 256])
def test_uniform_binspec_bitwise_vs_jax(cl, nbins):
    jf, tf = both_frames(_cols())
    names = ["x", "u", "a", "c", "g"]
    js, ts = _specs(jf, tf, names, nbins)
    _assert_same_spec(js, ts)
    # the all-NaN and the constant column get no edges: value bin + NA bin
    assert list(ts.nbins[2:4]) == [2, 2]
    assert len(ts.edges[0]) == nbins - 1
    n = tf.nrows
    tb = ts.bin_columns(tf).numpy()
    assert tb.dtype == (np.int16 if nbins == 256 else np.uint8)
    np.testing.assert_array_equal(tb, np.asarray(js.bin_columns(jf))[:n])


@pytest.mark.parametrize("n", [399_999, 400_001])
def test_uniform_stride_sample_bitwise_vs_jax(cl, n):
    """Above 200k rows min and max come from the stride sample, whose
    stride follows the reference's padded length (2 at both sizes); the
    largest value sits on an odd row, outside the sample."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n)
    x[rng.random(n) < 0.1] = np.nan
    x[1] = 100.0
    jf, tf = both_frames({"x": (x, None)})
    js, ts = _specs(jf, tf, ["x"], nbins=64)
    _assert_same_spec(js, ts)
    assert ts.edges[0].max() < 100.0


def test_unknown_strategy_raises():
    _, tf = both_frames({"x": (np.arange(64.0), None)})
    with pytest.raises(ValueError, match="strategy"):
        TBinSpec.build(tf, ["x"], strategy="sketch")


def _level_inputs(seed=1, n=640, S=3):
    rng = np.random.default_rng(seed)
    cols = _cols(n, seed)
    jf, tf = both_frames(cols)
    names = ["x", "u", "c", "g"]
    js, ts = _specs(jf, tf, names)
    node = rng.integers(-1, S, n).astype(np.int32)
    w = rng.integers(0, 4, n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    return jf, tf, js, ts, node, w, y


def _jax_arrays(js, jf, n, *arrays):
    jb = js.bin_columns(jf)
    pad = jb.shape[0] - n
    fills = {np.int32: -1}
    return jb, [jnp.asarray(np.pad(a, (0, pad), constant_values=fills.get(
        a.dtype.type, 0))) for a in arrays]


@pytest.mark.parametrize("S", [1, 3, 8])
def test_build_histogram_vs_jax(cl, S):
    from h2o3_tpu.models.tree.histogram import build_histogram

    jf, tf, js, ts, node, w, y = _level_inputs(seed=S, S=S)
    n = tf.nrows
    jb, (jn, jw, jy) = _jax_arrays(js, jf, n, node, w, y)
    jh = build_histogram(jb, jn, jw, jy, js, S)
    th = thist.build_histogram(ts.bin_columns(tf), torch.as_tensor(node),
                               torch.as_tensor(w), torch.as_tensor(y), ts, S)
    assert th.shape == jh.shape == (S, ts.tot_bins, 3)
    assert th.dtype == np.float64
    assert th[..., 0].tobytes() == jh[..., 0].tobytes()
    assert th[..., 0].sum() == w[node >= 0].sum() * ts.F
    np.testing.assert_allclose(th[..., 1:], jh[..., 1:], rtol=1e-6,
                               atol=1e-5)


def _splits_and_lt(mod, hist, spec):
    sp = mod.find_best_splits(hist, spec, min_rows=2.0,
                              min_split_improvement=1e-5)
    return sp, mod.left_table_for(sp, spec, int(spec.nbins.max()))


def test_split_search_and_routing_vs_jax(cl):
    """One histogram through both packages' split search gives the same
    splits; the same decisions route every row to the same node or
    leaf; per-leaf sums agree."""
    from h2o3_tpu.models.tree import dtree as jdtree
    from h2o3_tpu.models.tree.histogram import leaf_stats, route_rows

    S = 4
    jf, tf, js, ts, node, w, y = _level_inputs(seed=7, S=S)
    n = tf.nrows
    hist = thist.build_histogram(ts.bin_columns(tf), torch.as_tensor(node),
                                 torch.as_tensor(w), torch.as_tensor(y),
                                 ts, S)
    jsp, jlt = _splits_and_lt(jdtree, hist, js)
    tsp, tlt = _splits_and_lt(tdtree, hist, ts)
    np.testing.assert_array_equal(tlt, jlt)
    assert sum(s is not None for s in tsp) >= 2, "fixture should split"
    for a, b in zip(jsp, tsp):
        assert (a is None) == (b is None)
        if a is not None:
            assert (b.feat, b.is_cat, b.thresh_bin, b.na_left) == \
                (a.feat, a.is_cat, a.thresh_bin, a.na_left)
            assert b.gain == a.gain
            assert b.left_stats == a.left_stats
    # routing: split slots move to 2s / 2s+1, the others (and the last
    # slot, made terminal here) become leaves
    sf = np.array([s.feat if s else -1 for s in tsp], np.int32)
    sf[-1] = -1
    ls = np.where(sf >= 0, 2 * np.arange(S), -1).astype(np.int32)
    rs = np.where(sf >= 0, 2 * np.arange(S) + 1, -1).astype(np.int32)
    lid = np.where(sf < 0, 10 + np.arange(S), -1).astype(np.int32)
    leaf0 = np.full(n, -1, np.int32)
    jb, (jn, jl0) = _jax_arrays(js, jf, n, node, leaf0)
    kw = dict(split_feat=sf, left_table=tlt, left_slot=ls, right_slot=rs,
              leaf_id=lid)
    jnode, jleaf = route_rows(jb, jn, jl0, **kw)
    tnode, tleaf = thist.route_rows(ts.bin_columns(tf), torch.as_tensor(node),
                                    torch.as_tensor(leaf0), **kw)
    np.testing.assert_array_equal(tnode.numpy(), np.asarray(jnode)[:n])
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf)[:n])
    assert (tleaf.numpy() >= 10).any() and (tnode.numpy() >= 0).any()
    # per-leaf sums over the routed rows
    _, (jw, jy) = _jax_arrays(js, jf, n, w, y)
    jnum, jden = leaf_stats(jleaf, jw * jy, jw, 14)
    tnum, tden = thist.leaf_stats(tleaf, torch.as_tensor(w * y),
                                  torch.as_tensor(w), 14)
    np.testing.assert_allclose(tnum, jnum, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tden, jden, rtol=1e-6)


def _tree_dump(tree):
    out = []
    for nd in tree.nodes:
        sp = nd.split
        out.append((nd.nid, nd.depth, nd.left, nd.right, nd.leaf_id,
                    None if sp is None else
                    (sp.feat, sp.is_cat, sp.thresh_bin, sp.na_left,
                     None if sp.left_bins is None
                     else tuple(sp.left_bins.tolist()))))
    return out


@pytest.mark.parametrize("max_depth", [0, 4])
def test_grow_tree_vs_jax(cl, max_depth):
    """The public single-tree API: the same tree, dense leaf ids and the
    same leaf per row; node weights and means rel 1e-6."""
    from h2o3_tpu.models.tree.binning import BinSpec as JBinSpec
    from h2o3_tpu.models.tree.shared_tree import grow_tree

    rng = np.random.default_rng(4)
    n = 640
    x = rng.standard_normal(n)
    g = np.array(list("abc"), object)[rng.integers(0, 3, n)]
    jf, tf = both_frames({"x": (x, None), "g": (g, "enum")})
    js = JBinSpec.build(jf, ["x", "g"])
    ts = TBinSpec.build(tf, ["x", "g"])
    w = rng.integers(1, 3, n).astype(np.float32)
    y = (2 * x + (g == "a") + 0.3 * rng.standard_normal(n)).astype(np.float32)
    active = rng.random(n) < 0.9
    jb, (jw, jy, ja) = _jax_arrays(js, jf, n, w, y, active)
    kw = dict(max_depth=max_depth, min_rows=5.0, min_split_improvement=1e-5)
    jt, jrl = grow_tree(jb, jw, jy, js, row_active=ja, **kw)
    tt, trl = t_grow_tree(ts.bin_columns(tf), torch.as_tensor(w),
                          torch.as_tensor(y), ts,
                          row_active=torch.as_tensor(active), **kw)
    assert _tree_dump(tt) == _tree_dump(jt)
    assert tt.n_leaves == jt.n_leaves
    if max_depth:
        assert tt.n_leaves >= 4
    np.testing.assert_array_equal(trl.numpy(), np.asarray(jrl)[:n])
    assert ((trl.numpy() >= 0) == active).all()
    for a, b in zip(jt.nodes, tt.nodes):
        assert b.weight == pytest.approx(a.weight, rel=1e-6)
        assert b.pred == pytest.approx(a.pred, rel=1e-6, abs=1e-6)
