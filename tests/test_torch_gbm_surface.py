"""The GBM's full training surface in the port (on the CPU) against the
JAX package run through its Pallas histogram kernel in interpret mode:
multinomial responses, row and column sampling, validation frames with
early stopping, offsets and every distribution; and the pieces under
them: the quantile stride above 200k rows (bitwise edges), the split
search with feature masks (bitwise split tables), the column-sampling
draws (bitwise masks), the packed-table traversal (bitwise values) and a
JAX-trained multinomial forest carried across (bitwise margins).

Tolerances of the whole models: forest structure equal and the same
number of trees; leaf values and predictions atol 1e-5; metrics and the
scoring history rtol 1e-5 (the JAX package sums its histograms as 8
shard partials plus a psum, the port on one device, and XLA's exp/log
are not torch's). A laplace forest deeper than two levels splits some
nodes on rounding noise, and there the two packages can pick different
thresholds: `test_laplace_splits_on_rounding_noise` shows it (ROADMAP
C5)."""

import types

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.models.tree import device_tree as tdt
from h2o3_tpu_torch.models.tree.binning import BinSpec as TBinSpec
from h2o3_tpu_torch.models.tree.hist_gather import hist_gather_ref

from torch_port_support import both_frames, forest_arrays, train_cols

# fixtures: row counts are multiples of 64, so the JAX package's 8-shard
# padding adds no rows and both packages draw the same host streams


def class_cols(n=640, seed=5, K=3):
    """x, x2 numeric, g a 3-level enum, y a K-level class of (x, g)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    x2 = rng.standard_normal(n)
    g = np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)]
    score = x + (g == "a") + 0.5 * rng.standard_normal(n)
    code = np.clip(np.round(score * (K - 1) / 2).astype(int) + K // 2, 0,
                   K - 1)
    y = np.array([f"k{i}" for i in range(K)], object)[code]
    return {"x": (x, None), "x2": (x2, None), "g": (g, "enum"),
            "y": (y, "enum")}


def reg_cols(kind="real", n=640, seed=2):
    """x numeric, g enum, o a small offset, y of the given kind."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    g = np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)]
    o = 0.1 * rng.standard_normal(n)
    mu = np.exp(0.5 * x + (g == "a"))
    y = {"real": 2 * x + (g == "a") + 0.3 * rng.standard_normal(n),
         "count": rng.poisson(mu).astype(float),
         "positive": rng.gamma(2.0, mu / 2.0),
         "binary": (rng.random(n) < 1 / (1 + np.exp(-2 * x))).astype(float)
         }[kind]
    return {"x": (x, None), "g": (g, "enum"), "o": (o, None),
            "y": (y, None)}


def fit_both(monkeypatch, cols, valid=None, jax_cls=None, port_cls=None,
             **kw):
    """Train the JAX package's and the port's builder on the same data;
    -> (jax model, port model, jax frame, port frame)."""
    if jax_cls is None:
        from h2o3_tpu.models.tree.gbm import GBM as jax_cls
    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    jf, tf = both_frames(cols)
    jkw, tkw = {}, {}
    if valid is not None:
        jkw["validation_frame"], tkw["validation_frame"] = both_frames(valid)
    jm = jax_cls(**kw).train(y="y", training_frame=jf, **jkw)
    tm = (port_cls or th.GBM)(**kw).train(y="y", training_frame=tf, **tkw)
    return jm, tm, jf, tf


def assert_same_forest(jm, tm):
    jfo, tfo = jm.forest, tm.forest
    assert tfo.n_trees == jfo.n_trees
    assert tfo.nclasses == jfo.nclasses
    a, b = forest_arrays(jfo), forest_arrays(tfo)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_array_equal(tfo.tree_class, np.asarray(jfo.tree_class))
    np.testing.assert_allclose(tfo.leaf_val, np.asarray(jfo.leaf_val),
                               atol=1e-5)
    assert tfo.init_f == pytest.approx(jfo.init_f, rel=1e-6, abs=1e-7)
    if jfo.init_class is None:
        assert tfo.init_class is None
    else:
        np.testing.assert_allclose(tfo.init_class, jfo.init_class,
                                   rtol=1e-6)


def assert_history_close(jm, tm):
    jh, th_ = jm._output.scoring_history, tm._output.scoring_history
    assert [sorted(e) for e in th_] == [sorted(e) for e in jh]
    for je, te in zip(jh, th_):
        for k in je:
            assert te[k] == pytest.approx(je[k], rel=1e-5, abs=1e-7), k


_METRICS = {"Regression": ("rmse", "mae", "r2", "mean_residual_deviance"),
            "Binomial": ("auc", "logloss", "rmse", "mean_per_class_error"),
            "Multinomial": ("logloss", "rmse", "mean_per_class_error")}


def assert_metrics_close(jmm, tmm, category):
    assert type(tmm).__name__ == type(jmm).__name__
    assert tmm.nobs == pytest.approx(jmm.nobs, rel=1e-6)
    for k in _METRICS[category]:
        j, t = getattr(jmm, k), getattr(tmm, k)
        if np.isnan(j):
            assert np.isnan(t), k
        else:
            assert t == pytest.approx(j, rel=1e-5, abs=1e-7), k
    if category == "Multinomial":
        np.testing.assert_array_equal(tmm.cm.table, jmm.cm.table)
        np.testing.assert_allclose(tmm.hit_ratios, jmm.hit_ratios,
                                   rtol=1e-6)


def assert_predictions_close(jm, tm, jf, tf):
    n = tf.nrows
    jp, tp = jm.predict(jf), tm.predict(tf)
    assert tp.names == jp.names
    for c in tp.names:
        t, j = tp.col(c).to_numpy(), jp.col(c).to_numpy()[:n]
        if c == "predict" and tp.col(c).is_categorical:
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, atol=1e-5, err_msg=c)


def assert_models_match(jm, tm, jf, tf):
    assert tm._output.model_category == jm._output.model_category
    assert_same_forest(jm, tm)
    assert_predictions_close(jm, tm, jf, tf)
    assert_metrics_close(jm._output.training_metrics,
                         tm._output.training_metrics,
                         tm._output.model_category)
    assert_history_close(jm, tm)


# ---------------------------------------------------------------------------
# binning above 200k rows (ROADMAP C1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [399_999, 400_001])
def test_binspec_stride_sample_bitwise_vs_jax(cl, n):
    """Above 200k rows the quantiles come from a stride sample whose
    stride the reference takes from its padded length (400,000 and
    400,008 here, so 2 for both); the port pads the same way."""
    from h2o3_tpu.models.tree.binning import BinSpec as JBinSpec

    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) * 5
    x[rng.random(n) < 0.1] = np.nan
    u = np.round(rng.exponential(3.0, n), 1)
    jf, tf = both_frames({"x": (x, None), "u": (u, None)})
    js = JBinSpec.build(jf, ["x", "u"])
    ts = TBinSpec.build(tf, ["x", "u"])
    np.testing.assert_array_equal(ts.nbins, js.nbins)
    for te, je in zip(ts.edges, js.edges):
        assert te.tobytes() == je.tobytes()


# ---------------------------------------------------------------------------
# the grower's new inputs: feature masks, column-sampling draws, traversal
# ---------------------------------------------------------------------------

NBINS = (9, 7, 9, 4)
IS_CAT = (False, True, False, True)


def _level_hist(seed, S, n=3000):
    rng = np.random.default_rng(seed)
    F, maxB = len(NBINS), max(NBINS)
    binned = np.stack([rng.integers(0, b, n) for b in NBINS],
                      axis=1).astype(np.uint8)
    node = rng.integers(0, S, n).astype(np.int32)
    w = (rng.random(n) + 0.5).astype(np.float32)
    y = (binned[:, 0] * 0.3 - (binned[:, 1] == 2) + (binned[:, 2] == 8)
         + (binned[:, 3] == 1) + rng.standard_normal(n)).astype(np.float32)
    y -= y.mean()
    t = torch.as_tensor
    hist = hist_gather_ref(t(binned), t(node), t(w), t(y),
                           offsets=np.arange(F) * maxB, TB=F * maxB, S=S)
    return hist.reshape(S, F, maxB, 3).numpy()


@pytest.mark.parametrize("seed,S,keep", [(0, 1, 0.5), (1, 8, 0.5),
                                         (2, 16, 0.25), (3, 4, 1.0)])
def test_search_level_with_feat_mask_bitwise_vs_jax(cl, seed, S, keep):
    import jax

    from h2o3_tpu.models.tree import device_tree as jdt

    hist = _level_hist(seed, S)
    rng = np.random.default_rng(seed)
    mask = rng.random((S, len(NBINS))) < keep
    mask[np.arange(S), rng.integers(0, len(NBINS), S)] = True
    kw = dict(maxB=max(NBINS), min_rows=5.0, min_split_improvement=1e-5)
    jout = jax.jit(lambda h, m: jdt._search_level(
        h, nbins=NBINS, is_cat=IS_CAT, feat_mask=m, **kw))(hist, mask)
    tout = tdt._search_level(torch.as_tensor(hist),
                             nbins=torch.as_tensor(NBINS),
                             is_cat=torch.as_tensor(IS_CAT),
                             feat_mask=torch.as_tensor(mask), **kw)
    names = ("split_feat", "thresh", "na_left", "gain", "left_table", "tot")
    j = {k: np.asarray(v) for k, v in zip(names, jout)}
    t = {k: v.numpy() for k, v in zip(names, tout)}
    assert (t["split_feat"] >= 0).any(), "fixture should split somewhere"
    sf = t["split_feat"]
    assert mask[np.arange(S)[sf >= 0], sf[sf >= 0]].all()
    for k in ("split_feat", "thresh", "na_left", "left_table"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for k in ("gain", "tot"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("tree_rate,node_rate", [(0.5, 1.0), (1.0, 0.3),
                                                 (0.7, 0.6), (0.01, 0.5)])
def test_column_sampling_draws_bitwise_vs_jax(tree_rate, node_rate):
    """The per-level masks of four trees from one seeded Generator: the
    same draws in the same order as the reference."""
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    spec = types.SimpleNamespace(F=6)
    kw = dict(col_sample_rate_per_tree=tree_rate, col_sample_rate=node_rate)
    jb, tb = JGBM(**kw), th.GBM(**kw)
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(4):
        jm = tdt.build_feat_masks(5, jb._feat_mask_fn(jr, spec), 6, 9)
        tm = tdt.build_feat_masks(5, tb._feat_mask_fn(tr, spec), 6, 9)
        assert [m.shape for m in tm] == [(2 ** d, 6) for d in range(5)]
        for a, b in zip(tm, jm):
            np.testing.assert_array_equal(a, b)
            assert a.any(axis=1).all(), "every slot keeps a feature"
    assert th.GBM()._feat_mask_fn(tr, spec) is None


def test_grow_tree_device_with_feat_masks_matches_jax(cl, monkeypatch):
    """One tree from the same bins, weights, residuals and per-level
    feature masks: the packed tables' discrete lanes and every row's leaf
    are equal, and no slot splits on a feature its mask leaves out."""
    import jax.numpy as jnp

    from h2o3_tpu.models.tree import device_tree as jdt
    from h2o3_tpu.models.tree.binning import BinSpec as JBinSpec

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    jf, tf = both_frames(class_cols(n=896, seed=17))
    names = ["x", "x2", "g"]
    jspec = JBinSpec.build(jf, names)
    tspec = TBinSpec(jspec.names, jspec.is_cat, jspec.nbins, jspec.edges,
                     jspec.cards)
    n = tf.nrows
    rng = np.random.default_rng(2)
    w = (rng.random(n) + 0.5).astype(np.float32)
    z = (tf.col("x").to_numpy() - tf.col("x2").to_numpy()
         + rng.standard_normal(n)).astype(np.float32)
    masks = tdt.build_feat_masks(
        4, lambda S: rng.random((S, 3)) < 0.6, 3, int(tspec.nbins.max()))
    for m in masks:
        m[~m.any(axis=1), 0] = True
    jp, _, jr = jdt.grow_tree_device(
        jspec.bin_columns(jf), jnp.asarray(w), jnp.asarray(z), jspec,
        max_depth=4, min_rows=10.0, min_split_improvement=1e-5,
        feat_masks=masks)
    tp, _, tr = tdt.grow_tree_device(
        tspec.bin_columns(tf), torch.as_tensor(w), torch.as_tensor(z), tspec,
        max_depth=4, min_rows=10.0, min_split_improvement=1e-5,
        feat_masks=masks)
    jp, tp = np.asarray(jp), tp.numpy()
    maxB = int(tspec.nbins.max())
    discrete = [0, 1, 2] + list(range(4, 4 + maxB)) + [tp.shape[2] - 2,
                                                      tp.shape[2] - 1]
    np.testing.assert_array_equal(tp[..., discrete], jp[..., discrete])
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr)[:n])
    for d, m in enumerate(masks):
        sf = tp[d, : m.shape[0], 0].astype(int)
        assert (sf >= 0).any() or d > 0
        assert m[np.nonzero(sf >= 0)[0], sf[sf >= 0]].all(), d


def test_apply_packed_bitwise_vs_jax(cl):
    """Rows routed through one packed tree table give the same leaf
    values in both packages (the in-training validation margins)."""
    from h2o3_tpu.models.tree import device_tree as jdt
    from h2o3_tpu.models.tree.binning import BinSpec as JBinSpec

    jf, tf = both_frames(train_cols(seed=21, n=640))
    jspec = JBinSpec.build(jf, ["x", "g"])
    tspec = TBinSpec(jspec.names, jspec.is_cat, jspec.nbins, jspec.edges,
                     jspec.cards)
    binned = tspec.bin_columns(tf)
    rng = np.random.default_rng(3)
    z = torch.as_tensor(tf.col("x").to_numpy()
                        + rng.standard_normal(tf.nrows).astype(np.float32))
    packed, leaf4, row_leaf = tdt.grow_tree_device(
        binned, torch.ones(tf.nrows), z, tspec, max_depth=4, min_rows=5.0,
        min_split_improvement=1e-5)
    vals = torch.linspace(-1, 1, leaf4.shape[0])
    maxB = int(tspec.nbins.max())
    got = tdt.apply_packed(binned, packed, vals, 4, maxB)
    ref = np.asarray(jdt.apply_packed(jspec.bin_columns(jf), packed.numpy(),
                                      vals.numpy(), 4, maxB))[: tf.nrows]
    assert got.numpy().tobytes() == ref.tobytes()
    # the training rows land where the grower put them
    assert torch.equal(got, vals[row_leaf.long()])


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

_CASES = {
    "multinomial": (lambda: class_cols(), {}),
    "multinomial_k4_sampled": (lambda: class_cols(seed=8, K=4),
                               {"sample_rate": 0.8, "col_sample_rate": 0.7,
                                "ntrees": 2}),
    "bernoulli_sampled": (lambda: train_cols(n=640),
                          {"sample_rate": 0.7, "col_sample_rate": 0.6,
                           "col_sample_rate_per_tree": 0.8, "ntrees": 4}),
    "gaussian_tree_sampled": (lambda: train_cols(n=640, gaussian=True),
                              {"col_sample_rate_per_tree": 0.5,
                               "sample_rate": 0.5}),
    "poisson_offset": (lambda: reg_cols("count"),
                       {"distribution": "poisson", "offset_column": "o"}),
    "quasibinomial": (lambda: reg_cols("binary"),
                      {"distribution": "quasibinomial"}),
    "gamma": (lambda: reg_cols("positive"), {"distribution": "gamma"}),
    "tweedie": (lambda: reg_cols("count"),
                {"distribution": "tweedie", "tweedie_power": 1.4}),
    "laplace": (lambda: reg_cols(), {"distribution": "laplace",
                                     "max_depth": 2}),
    "quantile": (lambda: reg_cols(), {"distribution": "quantile",
                                      "quantile_alpha": 0.8}),
    "huber": (lambda: reg_cols(), {"distribution": "huber"}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_gbm_matches_jax(cl, monkeypatch, case):
    make, extra = _CASES[case]
    kw = dict(ntrees=3, max_depth=3, seed=3) | extra
    jm, tm, jf, tf = fit_both(monkeypatch, make(), **kw)
    assert_models_match(jm, tm, jf, tf)
    if "offset_column" in kw:
        assert "o" not in tm._output.names


@pytest.mark.parametrize("make", [lambda s: train_cols(n=640, seed=s),
                                  lambda s: class_cols(n=640, seed=s)],
                         ids=["bernoulli", "multinomial"])
def test_validation_frame_and_early_stopping_match_jax(cl, monkeypatch,
                                                       make):
    kw = dict(ntrees=30, max_depth=3, seed=3, learn_rate=0.3,
              stopping_rounds=2, stopping_tolerance=0.01, sample_rate=0.9)
    valid = make(2)
    valid = {k: (v[:320], c) for k, (v, c) in valid.items()}
    jm, tm, jf, tf = fit_both(monkeypatch, make(1), valid=valid, **kw)
    assert_models_match(jm, tm, jf, tf)
    ntrees = tm.forest.n_trees // tm.forest.n_margins
    assert ntrees < 30, "the fixture should stop early"
    hist = tm._output.scoring_history
    assert len(hist) == ntrees
    assert any(k.startswith("validation_") for k in hist[-1])
    assert_metrics_close(jm._output.validation_metrics,
                         tm._output.validation_metrics,
                         tm._output.model_category)


def test_laplace_splits_on_rounding_noise(cl, monkeypatch):
    """Laplace residuals are +-1, so a node whose rows all share one sign
    has a split gain of exactly 0; f32 cancellation leaves ~1e-5 of
    noise, above min_split_improvement, and the two packages split such
    a node at different thresholds. Every node where the forests differ
    carries a noise-level gain in both (ROADMAP C5)."""
    jm, tm, _, _ = fit_both(monkeypatch, reg_cols(), ntrees=3, max_depth=3,
                            seed=3, distribution="laplace")
    a, b = forest_arrays(jm.forest), forest_arrays(tm.forest)
    differ = np.zeros(a["feat"].shape, bool)
    for k in ("feat", "thresh_bin", "na_left", "left", "right"):
        differ |= a[k] != b[k]
    assert differ.any(), "this fixture shows the divergence"
    real = np.asarray(jm.forest.gain)[a["feat"] >= 0]
    assert np.median(real) > 1.0
    assert (np.asarray(jm.forest.gain)[differ] < 1e-4).all()
    assert (tm.forest.gain[differ] < 1e-4).all()


def _jax_stage_probs(jm, jf, n_trees):
    """Class probabilities of the JAX model's first n_trees trees, from
    the JAX package's own traversal of a truncated forest."""
    import jax

    from h2o3_tpu.models.tree.compressed import CompressedForest as JForest

    fo = jm.forest
    cut = [np.asarray(getattr(fo, k))[:n_trees] for k in
           ("feat", "thresh_bin", "na_left", "left", "right", "leaf_val",
            "cat_split")]
    part = JForest(*cut, np.asarray(fo.cat_table),
                   np.asarray(fo.tree_class)[:n_trees],
                   np.asarray(fo.na_bins), max_depth=fo.max_depth,
                   init_f=fo.init_f, nclasses=fo.nclasses)
    part.init_class = fo.init_class
    f = part.predict_binned(jm.spec.bin_columns(jf))
    if fo.init_class is None:
        return np.asarray(jm._distribution.linkinv(f))[:, None]
    return np.asarray(jax.nn.softmax(f, axis=-1))


@pytest.mark.parametrize("make", [lambda: train_cols(n=640),
                                  lambda: class_cols()],
                         ids=["bernoulli", "multinomial"])
def test_staged_predict_proba_matches_jax(cl, monkeypatch, make):
    """Stage t of the port's staged probabilities against the JAX
    package scoring its forest cut after t trees (per class: t tree
    groups); binomial stages carry p0."""
    jm, tm, jf, tf = fit_both(monkeypatch, make(), ntrees=3, max_depth=2,
                              seed=4)
    ts = tm.staged_predict_proba(tf)
    K = tm.forest.n_margins
    multi = K > 1
    stages = tm.forest.n_trees // K
    assert len(ts.names) == stages * (K if multi else 1)
    n = tf.nrows
    for g in range(stages):
        ref = _jax_stage_probs(jm, jf, (g + 1) * K)[:n]
        for k in range(ref.shape[1]):
            col = ts.col(f"T{g + 1}.C{k + 1}").to_numpy()
            want = ref[:, k] if multi else 1.0 - ref[:, 0]
            np.testing.assert_allclose(col, want, atol=1e-5)


def test_jax_multinomial_forest_carried_across_scores_bitwise(cl):
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    jf, tf = both_frames(class_cols(seed=6, K=4))
    jm = JGBM(ntrees=3, max_depth=3, seed=2).train(y="y", training_frame=jf)
    tm = convert.gbm_model_from_numpy(carry(jm))
    n = tf.nrows
    jmarg = np.asarray(jm.forest.predict_binned(jm.spec.bin_columns(jf)))[:n]
    tmarg = tm.forest.predict_binned(tm.spec.bin_columns(tf)).numpy()
    assert tmarg.shape == (n, 4)
    assert tmarg.tobytes() == jmarg.tobytes(), "margins differ"
    assert tm._margin(tm.adapt_test(tf)).numpy().tobytes() == jmarg.tobytes()
    jp, tp = jm.predict(jf), tm.predict(tf)
    np.testing.assert_array_equal(tp.col("predict").to_numpy(),
                                  jp.col("predict").to_numpy()[:n])
    for k in ("k0", "k3"):
        np.testing.assert_allclose(tp.col(k).to_numpy(),
                                   jp.col(k).to_numpy()[:n], atol=1e-6)


def carry(jm):
    """A JAX-trained tree model's state as numpy arrays and plain values
    (the input of convert.*_model_from_numpy)."""
    fo, sp, o = jm.forest, jm.spec, jm._output
    forest = {k: np.asarray(getattr(fo, k)) for k in
              ("feat", "thresh_bin", "na_left", "left", "right", "leaf_val",
               "cat_split", "cat_table", "tree_class", "na_bins")}
    forest |= {"max_depth": fo.max_depth, "init_f": fo.init_f,
               "nclasses": fo.nclasses, "init_class": fo.init_class}
    return {
        "forest": forest,
        "spec": {"names": list(sp.names), "is_cat": np.asarray(sp.is_cat),
                 "nbins": np.asarray(sp.nbins),
                 "edges": [np.asarray(e) for e in sp.edges],
                 "cards": np.asarray(sp.cards)},
        "output": {"names": list(o.names), "domains": dict(o.domains),
                   "response_domain": o.response_domain,
                   "model_category": o.model_category,
                   "response_name": o.response_name},
    }


# ---------------------------------------------------------------------------
# parameters the port now takes, checked in the port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [lambda: train_cols(n=256),
                                  lambda: class_cols(n=256)],
                         ids=["single", "multinomial"])
def test_max_runtime_secs_keeps_the_trees_built(make):
    """A budget that has run out after the first iteration keeps that
    iteration's trees."""
    th.init(device="cpu")
    _, tf = both_frames(make())
    m = th.GBM(ntrees=10, max_depth=2, max_runtime_secs=1e-9).train(
        y="y", training_frame=tf)
    assert m.forest.n_trees == m.forest.n_margins
    assert m._output.training_metrics is not None


def test_seed_zero_and_minus_one_draw_a_random_seed():
    seeds = {th.GBM(seed=s)._seed() for s in (0, 0, -1, -1)}
    assert len(seeds) > 1
    assert all(0 <= s < 2 ** 31 for s in seeds)
    assert th.GBM(seed=7)._seed() == 7
    th.init(device="cpu")
    _, tf = both_frames(train_cols(n=256))
    kw = dict(ntrees=2, max_depth=2, sample_rate=0.5, seed=11)
    a = th.GBM(**kw).train(y="y", training_frame=tf)
    b = th.GBM(**kw).train(y="y", training_frame=tf)
    assert np.array_equal(a.forest.leaf_val, b.forest.leaf_val)
