"""The port's tree grower pieces against the JAX package: the split
search on one shared histogram (split tables bitwise, gains to 1e-6),
host-tree assembly from one packed table, and a JAX-trained GBM carried
across (convert.py) scoring bitwise-equal margins."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.models.tree import device_tree as tdt
from h2o3_tpu_torch.models.tree.binning import BinSpec as TBinSpec
from h2o3_tpu_torch.models.tree.hist_gather import hist_gather_ref

from torch_port_support import both_frames, forest_arrays, train_cols

# F=4, maxB=9: a numeric feature, a categorical with empty levels (the
# +inf sort key), an NA-heavy numeric feature and a small categorical
NBINS = (9, 7, 9, 4)
IS_CAT = (False, True, False, True)


def _level_hist(seed, S, n=3000):
    rng = np.random.default_rng(seed)
    F, maxB = len(NBINS), max(NBINS)
    cols = [rng.integers(0, NBINS[0], n),
            rng.choice([0, 2, 5], n),             # levels 1, 3, 4 empty
            np.where(rng.random(n) < 0.6, NBINS[2] - 1,
                     rng.integers(0, NBINS[2] - 1, n)),
            rng.integers(0, NBINS[3], n)]
    binned = np.stack(cols, axis=1).astype(np.uint8)
    node = rng.integers(0, S, n).astype(np.int32)
    node[rng.random(n) < 0.1] = -1
    w = (rng.random(n) + 0.5).astype(np.float32)
    y = (binned[:, 0] * 0.3 - (binned[:, 1] == 2) + (binned[:, 2] == 8)
         + rng.standard_normal(n)).astype(np.float32)
    y -= y.mean()
    t = torch.as_tensor
    hist = hist_gather_ref(t(binned), t(node), t(w), t(y),
                           offsets=np.arange(F) * maxB, TB=F * maxB, S=S)
    return hist.reshape(S, F, maxB, 3).numpy()


@pytest.mark.parametrize("seed,S,min_rows", [(0, 1, 10.0), (1, 4, 10.0),
                                             (2, 8, 40.0), (3, 16, 1.0)])
def test_search_level_bitwise_vs_jax(cl, seed, S, min_rows):
    import jax

    from h2o3_tpu.models.tree import device_tree as jdt

    hist = _level_hist(seed, S)
    maxB = max(NBINS)
    kw = dict(maxB=maxB, min_rows=min_rows, min_split_improvement=1e-5)
    jout = jax.jit(lambda h: jdt._search_level(
        h, nbins=NBINS, is_cat=IS_CAT, feat_mask=None, **kw))(hist)
    tout = tdt._search_level(torch.as_tensor(hist),
                             nbins=torch.as_tensor(NBINS),
                             is_cat=torch.as_tensor(IS_CAT), **kw)
    names = ("split_feat", "thresh", "na_left", "gain", "left_table", "tot")
    j = {k: np.asarray(v) for k, v in zip(names, jout)}
    t = {k: v.numpy() for k, v in zip(names, tout)}
    assert (t["split_feat"] >= 0).any(), "fixture should split somewhere"
    for k in ("split_feat", "thresh", "na_left", "left_table"):
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for k in ("gain", "tot"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-6, err_msg=k)


def test_prefix_sum_matches_the_reference_scan():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    for L in (5, 16, 17, 21, 40, 300):
        x = (rng.standard_normal((3, 2, L, 3)) * 100).astype(np.float32)
        ref = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=2))(x))
        got = tdt._prefix_sum(torch.as_tensor(x), 2).numpy()
        assert got.tobytes() == ref.tobytes(), L


def test_segment_sum_is_exact_per_group_and_keeps_empty_groups():
    from h2o3_tpu_torch.core.ops import segment_sum

    rng = np.random.default_rng(4)
    idx = rng.choice([1, 2, 4, 6], 5000)             # groups 0, 3, 5, 7 empty
    vals = rng.standard_normal((5000, 4)).astype(np.float32)
    got = segment_sum(torch.as_tensor(idx), torch.as_tensor(vals), 8)
    assert got.dtype == torch.float32 and got.shape == (8, 4)
    expect = np.zeros((8, 4))
    np.add.at(expect, idx, vals.astype(np.float64))
    np.testing.assert_array_equal(got.numpy(), expect.astype(np.float32))
    one = segment_sum(torch.as_tensor(idx), torch.as_tensor(vals[:, 0]), 8)
    assert one.shape == (8,) and torch.equal(one, got[:, 0])


def _spec_pair(jspec):
    return TBinSpec(jspec.names, jspec.is_cat, jspec.nbins, jspec.edges,
                    jspec.cards)


def _tree_dump(tree):
    out = []
    for nd in tree.nodes:
        sp = nd.split
        out.append((nd.nid, nd.depth, nd.left, nd.right, nd.leaf_id,
                    nd.leaf_value, nd.weight, nd.pred,
                    None if sp is None else
                    (sp.feat, sp.is_cat, sp.thresh_bin,
                     None if sp.left_bins is None else sp.left_bins.tolist(),
                     sp.na_left, sp.gain, sp.left_stats, sp.right_stats)))
    return out, tree.n_leaves


def test_host_tree_from_packed_identical(cl):
    from h2o3_tpu.models.tree import device_tree as jdt
    from h2o3_tpu.models.tree.binning import BinSpec as JBinSpec

    jf, tf = both_frames(train_cols(seed=9))
    jspec = JBinSpec.build(jf, ["x", "g"])
    tspec = _spec_pair(jspec)
    binned = tspec.bin_columns(tf)
    y = torch.as_tensor(np.asarray(tf.col("x").to_numpy() > 0, np.float32))
    w = torch.ones(tf.nrows)
    packed, leaf4, _ = tdt.grow_tree_device(
        binned, w, y - y.mean(), tspec, max_depth=3, min_rows=5.0,
        min_split_improvement=1e-5)
    p, wy = packed.numpy(), leaf4[:, :2].numpy().astype(np.float64)
    vals = np.linspace(-1, 1, wy.shape[0])
    jt = jdt.host_tree_from_packed(p, wy, jspec, 3, leaf_values=vals)
    tt = tdt.host_tree_from_packed(p, wy, tspec, 3, leaf_values=vals)
    assert len(tt.nodes) > 3
    assert _tree_dump(tt) == _tree_dump(jt)


def test_grow_tree_device_matches_jax(cl, monkeypatch):
    """One tree from the same bins, weights and residuals: the packed
    split tables' discrete lanes and every row's leaf are equal; node
    totals and leaf sums agree to f32 summation order."""
    import jax.numpy as jnp

    from h2o3_tpu.models.tree import device_tree as jdt
    from h2o3_tpu.models.tree.binning import BinSpec as JBinSpec

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    jf, tf = both_frames(train_cols(seed=13, n=900))
    jspec = JBinSpec.build(jf, ["x", "g"])
    tspec = _spec_pair(jspec)
    n = tf.nrows
    jb = jspec.bin_columns(jf)
    pad = jb.shape[0] - n
    rng = np.random.default_rng(1)
    w = (rng.random(n) + 0.5).astype(np.float32)
    z = (tf.col("x").to_numpy() + rng.standard_normal(n)).astype(np.float32)
    wp, zp = np.pad(w, (0, pad)), np.pad(z, (0, pad))
    jp, jl, jr = jdt.grow_tree_device(
        jb, jnp.asarray(wp), jnp.asarray(zp), jspec, max_depth=4,
        min_rows=10.0, min_split_improvement=1e-5)
    tp, tl, tr = tdt.grow_tree_device(
        tspec.bin_columns(tf), torch.as_tensor(w), torch.as_tensor(z), tspec,
        max_depth=4, min_rows=10.0, min_split_improvement=1e-5)
    jp, tp = np.asarray(jp), tp.numpy()
    maxB = int(tspec.nbins.max())
    discrete = [0, 1, 2] + list(range(4, 4 + maxB)) + [tp.shape[2] - 2,
                                                      tp.shape[2] - 1]
    np.testing.assert_array_equal(tp[..., discrete], jp[..., discrete])
    assert (tp[..., 0] >= 0).sum() >= 3, "fixture should grow a tree"
    tots = slice(4 + maxB, 7 + maxB)
    np.testing.assert_allclose(tp[..., tots], jp[..., tots], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(tp[..., 3], jp[..., 3], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr)[:n])
    assert (tr >= 0).all(), "every row ends in a leaf"
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-4)
    assert float(tl[:, 0].sum()) == pytest.approx(float(w.sum()), rel=1e-6)


def _carry(jm):
    fo, sp, o = jm.forest, jm.spec, jm._output
    return {
        "forest": {k: np.asarray(getattr(fo, k)) for k in
                   ("feat", "thresh_bin", "na_left", "left", "right",
                    "leaf_val", "cat_split", "cat_table", "tree_class",
                    "na_bins")} | {"max_depth": fo.max_depth,
                                   "init_f": fo.init_f,
                                   "nclasses": fo.nclasses},
        "spec": {"names": list(sp.names), "is_cat": np.asarray(sp.is_cat),
                 "nbins": np.asarray(sp.nbins),
                 "edges": [np.asarray(e) for e in sp.edges],
                 "cards": np.asarray(sp.cards)},
        "output": {"names": list(o.names), "domains": dict(o.domains),
                   "response_domain": o.response_domain,
                   "model_category": o.model_category,
                   "response_name": o.response_name},
    }


def test_jax_gbm_carried_across_scores_bitwise(cl):
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    jf, tf = both_frames(train_cols())
    jm = JGBM(ntrees=4, max_depth=3, seed=3).train(y="y", training_frame=jf)
    tm = convert.gbm_model_from_numpy(_carry(jm))
    n = tf.nrows
    jmarg = np.asarray(jm.forest.predict_binned(jm.spec.bin_columns(jf)))[:n]
    tmarg = tm.forest.predict_binned(tm.spec.bin_columns(tf)).numpy()
    assert tmarg.tobytes() == jmarg.tobytes(), "margins differ"
    # the fused bin + walk path gives the same margins
    assert tm._margin(tm.adapt_test(tf)).numpy().tobytes() == jmarg.tobytes()
    jp = jm.predict(jf).col("Y").to_numpy()[:n]
    tp = tm.predict(tf).col("Y").to_numpy()
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    for k, v in forest_arrays(tm.forest).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jm.forest, k)))
    perf = tm.model_performance(tf)
    assert perf.auc == pytest.approx(jm._output.training_metrics.auc,
                                     abs=1e-6)


def test_convert_round_trips_the_ports_own_model():
    th.init(device="cpu")
    _, tf = both_frames(train_cols(seed=5))
    m = th.GBM(ntrees=3, max_depth=2, seed=1).train(y="y", training_frame=tf)
    d = _carry(m)
    m2 = convert.gbm_model_from_numpy(d)
    a = m.predict(tf).col("Y").data
    b = m2.predict(tf).col("Y").data
    assert torch.equal(a, b)
