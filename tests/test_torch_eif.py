"""Extended Isolation Forest in the port (on the CPU) against the JAX
package on the same numpy fixtures.

Tolerances: on NA-free fixtures the packed arrays (normals, offsets,
children, leaf path lengths) are bitwise: the design matrix is bitwise
there and every host draw is the same numpy call. Scores and
`mean_length` agree to 1e-6 (the port sums each dot product and the
mean path length in float64, the JAX package in float32, so a row that
lies within rounding of a hyperplane could route apart; none does on
these fixtures). With NAs, imputation reads the column means, whose
float32 sums differ in order; what still holds is written below."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.models import extended_isofor as eif
from h2o3_tpu_torch.models.extended_isofor import score_packed

from torch_port_support import both_frames

_PACKED = ("normals", "offsets", "lefts", "rights", "values")


def eif_cols(n=640, seed=0, na=False, outliers=0.0):
    """Four normals (NaN-laced with `na`) and a 3-level categorical (one
    hot: d = 7); with `outliers`, that share of rows 6 sigma out."""
    rng = np.random.default_rng(seed)
    moved = rng.random(n) < outliers
    cols = {}
    for i in range(4):
        x = rng.standard_normal(n) + 6.0 * moved
        if na:
            x[rng.random(n) < 0.05] = np.nan
        cols[f"n{i}"] = (x, None)
    cols["g"] = (np.array(list("abc"), object)[rng.integers(0, 3, n)],
                 "enum")
    return cols, moved


def fit_both(cols, **kw):
    from h2o3_tpu.models.extended_isofor import \
        ExtendedIsolationForest as JEIF

    jf, tf = both_frames(cols)
    jm = JEIF(**kw).train(training_frame=jf)
    tm = th.ExtendedIsolationForest(**kw).train(training_frame=tf)
    return jm, tm, jf, tf


def assert_scores_close(jm, tm, jf, tf, rtol=1e-6):
    n = tf.nrows
    jp, tp = jm.predict(jf), tm.predict(tf)
    assert tp.names == jp.names == ["predict", "mean_length"]
    for c in tp.names:
        np.testing.assert_allclose(tp.col(c).to_numpy(),
                                   jp.col(c).to_numpy()[:n], rtol=rtol,
                                   atol=1e-6, err_msg=c)
    return tp


@pytest.mark.parametrize("ext", [0, 6])
def test_packed_arrays_bitwise_and_scores(cl, ext):
    jm, tm, jf, tf = fit_both(eif_cols(seed=ext + 1)[0], ntrees=20,
                              seed=ext + 1, extension_level=ext)
    for k in _PACKED:
        a, b = np.asarray(getattr(jm, k)), getattr(tm, k)
        assert b.dtype == a.dtype and b.shape == a.shape, k
        assert b.tobytes() == a.tobytes(), k
    assert (tm.max_depth, tm.cnorm) == (jm.max_depth, jm.cnorm) == (
        8, jm.cnorm)
    nnz = (tm.normals != 0).sum(-1)[tm.lefts >= 0]
    assert (nnz == ext + 1).all(), "extension_level + 1 nonzero coordinates"
    assert tm._output.model_category == "AnomalyDetection"
    assert tm._output.training_metrics is None
    assert_scores_close(jm, tm, jf, tf)


def test_chunked_scoring_equals_one_piece(cl, monkeypatch):
    cols, moved = eif_cols(n=1280, seed=8, outliers=0.02)
    _, tf = both_frames(cols)
    m = th.ExtendedIsolationForest(ntrees=25, seed=8,
                                   extension_level=6).train(training_frame=tf)
    whole = m.predict(tf)
    # 100 rows a chunk: 13 chunks
    monkeypatch.setattr(eif, "DEFAULT_CHUNK_BYTES", 25 * 7 * 8 * 100)
    parts = m.predict(tf)
    for c in ("predict", "mean_length"):
        assert parts.col(c).to_numpy().tobytes() == \
            whole.col(c).to_numpy().tobytes()
    s = whole.col("predict").to_numpy()
    assert s[moved].mean() > s[~moved].mean() + 0.1
    # the packed scorer by hand, row by row in chunks of one
    X = m.data_info.expand(*(c.data for c in m.data_info.cols(tf)))[:5]
    s1, _ = score_packed(X, m.normals, m.offsets, m.lefts, m.rights,
                         m.values, m.max_depth, m.cnorm, chunk_bytes=1)
    assert s1.numpy().tobytes() == s[:5].tobytes()


def carry_eif(jm):
    di = jm.data_info
    state = {k: getattr(di, k) for k in
             ("standardize", "cat_names", "num_names", "domains", "cards",
              "use_all_factor_levels", "num_means", "num_sigmas",
              "cat_modes", "impute_values")}
    o = jm._output
    return {**{k: np.asarray(getattr(jm, k)) for k in _PACKED},
            "max_depth": jm.max_depth, "cnorm": jm.cnorm,
            "data_info": state,
            "output": {"names": list(o.names), "domains": dict(o.domains),
                       "model_category": o.model_category}}


def test_jax_eif_carried_across(cl):
    """A JAX-trained model scores in the port as in the JAX package, on
    a frame with NAs (imputed with the carried means and modes)."""
    from h2o3_tpu.models.extended_isofor import \
        ExtendedIsolationForest as JEIF

    jf, tf = both_frames(eif_cols(seed=31, na=True)[0])
    jm = JEIF(ntrees=15, seed=31, extension_level=3).train(training_frame=jf)
    tm = convert.eif_model_from_numpy(carry_eif(jm))
    assert tm.data_info.coef_names() == jm.data_info.coef_names()
    assert_scores_close(jm, tm, jf, tf)


def test_na_fixture_structure_equal_offsets_close(cl):
    """With NAs the imputed means differ from the reference's in the last
    bits. Normals, children and path lengths stay bitwise (every draw is
    the same call); an offset moves only where a node's bounding box is
    set by an imputed value, by float32 rounding."""
    jm, tm, jf, tf = fit_both(eif_cols(seed=3, na=True)[0], ntrees=20,
                              seed=3, extension_level=5)
    np.testing.assert_allclose(tm.data_info.num_means,
                               jm.data_info.num_means, rtol=1e-6, atol=1e-7)
    for k in ("normals", "lefts", "rights", "values"):
        assert getattr(tm, k).tobytes() == np.asarray(getattr(jm, k)).tobytes()
    np.testing.assert_allclose(tm.offsets, jm.offsets, rtol=1e-6, atol=1e-6)
    assert_scores_close(jm, tm, jf, tf)


def test_eif_takes_no_response(cl):
    _, tf = both_frames(eif_cols(n=256, seed=2)[0])
    m = th.ExtendedIsolationForest(ntrees=3, seed=2).train(
        x=["n0", "n1"], training_frame=tf)
    assert m.normals.shape[2] == 2
    assert torch.isfinite(m.predict(tf).col("predict").data).all()
