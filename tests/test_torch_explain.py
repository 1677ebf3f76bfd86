"""The port's explanation suite (explain.py) and its TreeSHAP walk
(csrc/treeshap.cpp in the port's host library) against the JAX
package's.

The forests are trained by the JAX package (its tests/test_explain.py
fixtures: a 10-tree depth-3 bernoulli GBM on 3 features with an enum,
and a 5-tree depth-4 DRF regression) and carried across with
convert.py, gains and covers included, so both packages explain one
forest. Bars:
- partial dependence (1-D, 2-D, ICE, weighted): grids equal, mean and
  stddev of the response within 1e-6 (predictions, ROADMAP C2);
- contributions within rtol 1e-5, atol 1e-7, the reference's own
  native-vs-Python bar (tests/test_explain.py:197): the port's library
  is built with -ffp-contract=off and the reference's without it, so
  fused multiply-adds may part them in the last bits; BiasTerm bit for
  bit; every row's contributions plus BiasTerm equal its margin within
  2e-3 (tests/test_explain.py:76);
- the native walk equals its plain version `_shap_one_tree` at the same
  bar;
- feature interactions and the varimp matrix equal; the model
  correlation matrix within 1e-6;
- the error cases raise the reference's messages.
A failed host-library build raises; nothing explains another way. The
gpu-marked tests hold the card to the CPU: contributions bit for bit
(the same host walk on the same bin matrix) and a MOJO written and read
on the card predicting bit for bit.
"""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert, explain, native

from torch_port_support import assert_bitwise, both_frames, carry_forest


def _setup_cols(n=832, seed=5):
    rng = np.random.default_rng(seed)
    x1, x2 = rng.standard_normal(n), rng.standard_normal(n)
    g = np.array(["a", "b"], object)[rng.integers(0, 2, n)]
    logit = 2.0 * x1 + 0.5 * x2 * (g == "a")
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "Y", "N")
    w = rng.uniform(0.5, 2.0, n)
    return {"x1": (x1, None), "x2": (x2, None), "g": (g, "enum"),
            "y": (y, "enum"), "w": (w, None)}


def _reg_cols(n=384, seed=9):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 3))
    yv = 3 * X[:, 0] - X[:, 1] + rng.normal(0, 0.1, n)
    return {"a": (X[:, 0], None), "b": (X[:, 1], None),
            "c": (X[:, 2], None), "y": (yv, None)}


@pytest.fixture(scope="module")
def gbm():
    """(JAX frame, port frame, JAX GBM, the port's copy)."""
    from h2o3_tpu.models.tree.gbm import GBM

    cols = _setup_cols()
    jf, tf = both_frames(cols)
    jm = GBM(ntrees=10, max_depth=3, seed=1).train(
        x=["x1", "x2", "g"], y="y", training_frame=jf)
    tm = convert.gbm_model_from_numpy(carry_forest(jm))
    tm._output.variable_importances = dict(jm.varimp())
    return jf, tf, jm, tm


@pytest.fixture(scope="module")
def drf():
    from h2o3_tpu.models.tree.drf import DRF

    jf, tf = both_frames(_reg_cols())
    jm = DRF(ntrees=5, max_depth=4, seed=2, sample_rate=1.0,
             mtries=3).train(y="y", training_frame=jf)
    tm = convert.drf_model_from_numpy(carry_forest(jm))
    tm._output.variable_importances = dict(jm.varimp())
    return jf, tf, jm, tm


def _assert_tables(want, got, ctx):
    assert len(want) == len(got), ctx
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b), ctx
        for k in a:
            if k in ("mean_response", "stddev_response"):
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6,
                                           err_msg=f"{ctx} {k}")
            elif k == "rows":
                assert [r[:2] for r in a[k]] == [r[:2] for r in b[k]], ctx
                np.testing.assert_allclose(
                    [r[2:] for r in a[k]], [r[2:] for r in b[k]], rtol=0,
                    atol=1e-6, err_msg=ctx)
            else:
                assert list(a[k]) == list(b[k]), (ctx, k)


PDP = {
    "one_d": dict(cols=["x1", "g"], nbins=8),
    "ice": dict(cols=["x1", "x2"], nbins=5, row_index=3),
    "weighted": dict(cols=["x2", "g"], nbins=6, weight_column="w"),
    "two_d": dict(col_pairs_2dpdp=[("x1", "g"), ("x2", "x1")], nbins=4),
}


@pytest.mark.parametrize("case", sorted(PDP))
def test_partial_dependence_matches_reference(gbm, case):
    jf, tf, jm, tm = gbm
    kw = PDP[case]
    want = jm.partial_plot(jf, **kw)
    got = tm.partial_plot(tf, **kw)
    _assert_tables(want, got, case)
    if case == "ice":
        assert all(s == 0.0 for t in got for s in t["stddev_response"])


def test_partial_dependence_regression_matches_reference(drf):
    jf, tf, jm, tm = drf
    _assert_tables(explain_ref().partial_dependence(jm, jf, nbins=5),
                   explain.partial_dependence(tm, tf, nbins=5), "drf")


def explain_ref():
    from h2o3_tpu import explain as jexplain

    return jexplain


def _mat(fr, n):
    return np.stack([np.asarray(fr.col(c).to_numpy())[:n]
                     for c in fr.names], 1)


@pytest.mark.parametrize("which", ["gbm", "drf"])
def test_contributions_match_reference(which, request):
    jf, tf, jm, tm = request.getfixturevalue(which)
    n = tf.nrows
    want = jm.predict_contributions(jf)
    got = tm.predict_contributions(tf, key="contribs_1")
    assert got.names == want.names and got.names[-1] == "BiasTerm"
    assert str(got.key) == "contribs_1"
    a, b = _mat(want, n), _mat(got, n)
    assert_bitwise(a[:, -1], b[:, -1], "BiasTerm")
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
    margin = tm.forest.predict_binned(
        tm.spec.bin_columns(tm.adapt_test(tf))).numpy()
    np.testing.assert_allclose(b.sum(1, dtype=np.float64), margin,
                               atol=2e-3)


@pytest.mark.parametrize("which", ["gbm", "drf"])
def test_native_walk_equals_its_plain_version(which, request):
    _, tf, _, tm = request.getfixturevalue(which)
    binned = tm.spec.bin_columns(tm.adapt_test(tf)).numpy()[:40]
    phi = native.native_treeshap(binned, tm.forest)
    F = binned.shape[1]
    plain = np.zeros((40, F + 1), np.float64)
    for t in range(tm.forest.n_trees):
        for r in range(40):
            explain._shap_one_tree(binned[r], t, tm.forest, plain[r])
    np.testing.assert_allclose(phi, plain, rtol=1e-5, atol=1e-7)
    assert (phi[:, -1] == 0).all()


@pytest.mark.parametrize("which", ["gbm", "drf"])
def test_feature_interactions_match_reference(which, request):
    _, _, jm, tm = request.getfixturevalue(which)
    for depth in (1, 2):
        want = jm.feature_interaction(max_interaction_depth=depth)
        got = tm.feature_interaction(max_interaction_depth=depth)
        assert got == want, (which, depth)
    rows = tm.feature_interaction()
    f = tm.forest
    names = tm._output.names
    expect = {}
    for t in range(f.n_trees):
        for node in range(f.feat.shape[1]):
            if f.feat[t, node] >= 0:
                nm = names[f.feat[t, node]]
                expect[nm] = expect.get(nm, 0.0) + float(f.gain[t, node])
    got = {r["interaction"]: r["gain"] for r in rows if r["depth"] == 0}
    assert got == pytest.approx(expect, rel=1e-12)


def test_varimp_matrix_and_model_correlation_match(gbm):
    from h2o3_tpu.models.glm import GLM

    jf, tf, jm, tm = gbm
    jg = GLM(family="binomial", lambda_=0.0).train(
        x=["x1", "x2", "g"], y="y", training_frame=jf)
    tg = th.GLM(family="binomial", lambda_=0.0).train(
        x=["x1", "x2", "g"], y="y", training_frame=tf)
    want = explain_ref().varimp_matrix([jm, jg])
    got = explain.varimp_matrix([tm, tg])
    assert got["features"] == want["features"]
    assert got["models"] == [str(tm.key), str(tg.key)]
    np.testing.assert_allclose(got["matrix"], want["matrix"], rtol=1e-5)
    cw = explain_ref().model_correlation([jm, jg], jf)["matrix"]
    cg = explain.model_correlation([tm, tg], tf)["matrix"]
    np.testing.assert_allclose(cg, cw, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.diag(cg), 1.0, atol=1e-6)


def _multinomial_gbm_pair():
    from h2o3_tpu.models.tree.gbm import GBM

    cols = _setup_cols(n=256)
    rng = np.random.default_rng(0)
    cols["y"] = (np.array(["p", "q", "r"])[rng.integers(0, 3, 256)],
                 "enum")
    jf, tf = both_frames(cols)
    jm = GBM(ntrees=2, max_depth=2, seed=1).train(
        x=["x1", "x2", "g"], y="y", training_frame=jf)
    return jf, tf, jm, convert.gbm_model_from_numpy(carry_forest(jm))


@pytest.mark.parametrize("case", ["multinomial", "no_covers", "not_a_tree",
                                  "no_gains"])
def test_errors_match_reference(case, gbm):
    from h2o3_tpu.models import mojo as jmojo

    from h2o3_tpu_torch.models import mojo

    jf, tf, jm, tm = gbm
    if case == "multinomial":
        jf, tf, jm, tm = _multinomial_gbm_pair()
    elif case in ("no_covers", "no_gains"):
        # a forest read from a MOJO carries neither covers nor gains
        blob = jmojo.export_mojo_bytes(jm)
        jm, tm = jmojo.read_mojo(blob), mojo.read_mojo(blob)
    elif case == "not_a_tree":
        from h2o3_tpu.models.glm import GLM

        jm = GLM(family="binomial").train(x=["x1", "x2", "g"], y="y",
                                          training_frame=jf)
        tm = th.GLM(family="binomial").train(x=["x1", "x2", "g"], y="y",
                                             training_frame=tf)
    call = ((lambda m, f: m.feature_interaction()) if case == "no_gains"
            else (lambda m, f: m.predict_contributions(f)))
    with pytest.raises(ValueError) as ref_err:
        call(jm, jf)
    with pytest.raises(ValueError) as port_err:
        call(tm, tf)
    assert str(port_err.value) == str(ref_err.value)


def test_failed_host_build_raises(gbm, tmp_path, monkeypatch):
    """With the compiler replaced by `false`, predict_contributions raises
    the build's error: there is no Python fallback."""
    _, tf, _, tm = gbm
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="treeshap.cpp failed"):
        tm.predict_contributions(tf)


def test_a_forest_deeper_than_the_walk_raises(gbm):
    _, tf, _, tm = gbm
    binned = tm.spec.bin_columns(tm.adapt_test(tf)).numpy()[:2]
    deep = convert.forest_from_numpy(
        {**carry_forest(gbm[2])["forest"],
         "max_depth": native.TREESHAP_MAX_DEPTH + 1})
    with pytest.raises(ValueError, match="up to depth"):
        native.native_treeshap(binned, deep)


@pytest.mark.gpu
def test_card_contributions_and_pdp_equal_the_cpu(gbm):
    """The same forest on the card and on the CPU: contributions bit for
    bit (the same host walk over the same bin matrix), PDP tables
    within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, tf, jm, tm = gbm
    cols = _setup_cols()
    card = th.Frame()
    for k, (a, c) in cols.items():
        card.add(k, th.Column.from_numpy(a, ctype=c, device="cuda"))
    a = _mat(tm.predict_contributions(tf), tf.nrows)
    b = _mat(tm.predict_contributions(card), tf.nrows)
    assert_bitwise(a, b, "contributions card vs cpu")
    _assert_tables(tm.partial_plot(tf, cols=["x1", "g"], nbins=8),
                   tm.partial_plot(card, cols=["x1", "g"], nbins=8),
                   "pdp card vs cpu")
