"""The port's MOJO (models/mojo.py) and Generic model (models/generic.py)
against the JAX package's, and the h2o3_genmodel standalone contract.

Every family the format covers is trained by the port on the CPU and
exported. The same model then reaches the JAX package through its own
MOJO reader, so each package holds one model, and:
- each package writes it back out: `scorer.json` and every
  `data/*.npy` equal bit for bit, `model.ini` equal but for `uuid`,
  `h2o_version` and `timestamp`;
- the MOJO the port wrote scores in the JAX package, and the one the
  JAX package wrote scores in the port, within the family's bar
  (tests/test_mojo.py, tests/test_mojo_families.py): tree margins bit
  for bit (their probabilities to 1e-6: the packages' exp differ in the
  last bits, ROADMAP C2), GLM/DL/KMeans predictions to 1e-5 (C2), PCA
  1e-5, GLRM 1e-4, Word2Vec exact, StackedEnsemble 1e-5, TargetEncoder
  1e-10, CoxPH 1e-4.
Models the JAX package trains itself (GBM, GLM, KMeans, DeepLearning)
load in the port and score within the same bars. Within the port an
export and import predicts bit for bit. `h2o3_genmodel.load_mojo` (numpy
only, not edited) scores a port-written MOJO equal to the port's predict
within tests/test_genmodel.py's atol 1e-5, rtol 1e-5.
"""

import io
import json
import zipfile

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch.models import mojo

from torch_port_support import (assert_bitwise, both_frames, family_cols,
                                mojo_parts, model_outputs)



def _num_only(cols):
    return {k: v for k, v in cols.items() if v[1] is None}


def _se(fr, y):
    base = [th.GBM(ntrees=3, max_depth=3, seed=1, nfolds=2,
                   keep_cross_validation_predictions=True).train(
                y=y, training_frame=fr),
            th.GLM(family="binomial", nfolds=2, lambda_=0.0, seed=1,
                   keep_cross_validation_predictions=True).train(
                y=y, training_frame=fr)]
    return th.StackedEnsemble(base_models=base, seed=1).train(
        y=y, training_frame=fr)


# family -> (data kind, train(port frame), what to compare, bar);
# bar None: bitwise
FAMILIES = {
    "gbm": ("bin", lambda fr: th.GBM(ntrees=3, max_depth=3, seed=1).train(
        y="y", training_frame=fr), "predict", 1e-6),
    "gbm_multinomial": ("multi", lambda fr: th.GBM(
        ntrees=2, max_depth=3, seed=1).train(y="y", training_frame=fr),
        "predict", 1e-6),
    "gbm_poisson": ("count", lambda fr: th.GBM(
        ntrees=3, max_depth=3, seed=1, distribution="poisson").train(
        y="y", training_frame=fr), "predict", 1e-6),
    "drf_double_trees": ("bin", lambda fr: th.DRF(
        ntrees=3, max_depth=4, seed=1, binomial_double_trees=True).train(
        y="y", training_frame=fr), "predict", 1e-6),
    "drf_regression": ("reg", lambda fr: th.DRF(
        ntrees=3, max_depth=4, seed=1).train(y="y", training_frame=fr),
        "predict", 1e-6),
    "isolationforest": ("none", lambda fr: th.IsolationForest(
        ntrees=5, seed=1).train(training_frame=fr), "predict", 1e-6),
    "xgboost": ("bin", lambda fr: th.XGBoost(
        ntrees=2, max_depth=3, seed=1, nbins=16).train(
        y="y", training_frame=fr), "predict", 1e-6),
    "glm": ("bin", lambda fr: th.GLM(family="binomial").train(
        y="y", training_frame=fr), "predict", 1e-5),
    "glm_multinomial": ("multi", lambda fr: th.GLM(
        family="multinomial").train(y="y", training_frame=fr), "predict",
        1e-5),
    "kmeans": ("none", lambda fr: th.KMeans(k=3, seed=1).train(
        training_frame=fr), "predict", 1e-5),
    "deeplearning": ("bin", lambda fr: th.DeepLearning(
        hidden=[8], epochs=1, seed=1).train(y="y", training_frame=fr),
        "predict", 1e-5),
    "pca": ("num", lambda fr: th.PCA(
        k=2, transform="STANDARDIZE", seed=1).train(training_frame=fr),
        "predict", 1e-5),
    "glrm": ("num", lambda fr: th.GLRM(
        k=2, loss="Quadratic", max_iterations=20, seed=1).train(
        training_frame=fr), "predict", 1e-4),
    "word2vec": ("words", lambda fr: th.Word2Vec(
        vec_size=8, epochs=1, min_word_freq=2, window_size=2,
        seed=1).train(training_frame=fr), "transform", None),
    "stackedensemble": ("bin", lambda fr: _se(fr, "y"), "predict", 1e-5),
    "targetencoder": ("bin", lambda fr: th.TargetEncoder(
        noise=0.0, blending=True, columns_to_encode=["c0"]).train(
        y="y", training_frame=fr), "transform", 1e-10),
    "coxph": ("surv", lambda fr: th.CoxPH(
        stop_column="time", ties="efron").train(
        y="event", training_frame=fr), "predict", 1e-4),
}


def _frames(kind):
    cols = family_cols("bin" if kind == "num" else kind)
    if kind == "num":
        cols = _num_only(cols)
    return both_frames(cols)


def _assert_outputs(a, b, bar, ctx):
    assert sorted(a) == sorted(b), (ctx, sorted(a), sorted(b))
    for nm in a:
        x, y = np.asarray(a[nm]), np.asarray(b[nm])
        if bar is None or x.dtype.kind not in "f":
            assert_bitwise(x.astype(y.dtype), y, (ctx, nm))
        else:
            np.testing.assert_allclose(x.astype(np.float64),
                                       y.astype(np.float64), rtol=0,
                                       atol=bar, err_msg=str((ctx, nm)))


_VARYING = ("uuid", "h2o_version", "timestamp")


def _nested(npy: bytes) -> bytes:
    return np.load(io.BytesIO(npy), allow_pickle=False).tobytes()


def assert_same_container(a, b, ctx=""):
    """Two MOJOs hold the same model: the same entries, scorer.json and
    data/*.npy equal bit for bit, model.ini equal but for the lines
    that name the writer and the moment. A StackedEnsemble's nested
    MOJOs (its base models and metalearner, stored as uint8 arrays) are
    compared the same way, as containers."""
    pa, pb = mojo_parts(a), mojo_parts(b)
    assert sorted(pa) == sorted(pb), (ctx, sorted(pa), sorted(pb))
    nested = json.loads(pa["scorer.json"])["algo"] == "stackedensemble"
    for name in pa:
        if nested and name.startswith(("data/base", "data/metalearner")):
            assert_same_container(_nested(pa[name]), _nested(pb[name]),
                                  (ctx, name))
        elif name == "model.ini":
            la = [ln for ln in pa[name].decode().splitlines()
                  if ln.split(" = ")[0] not in _VARYING]
            lb = [ln for ln in pb[name].decode().splitlines()
                  if ln.split(" = ")[0] not in _VARYING]
            assert la == lb, (ctx, set(la) ^ set(lb))
        else:
            assert pa[name] == pb[name], (ctx, name)


def _margins(model, fr, n):
    """Tree models: the forest margins of the adapted frame."""
    binned = model.spec.bin_columns(model.adapt_test(fr))
    f = model.forest.predict_binned(binned)
    return (f.cpu().numpy() if hasattr(f, "cpu") else np.asarray(f))[:n]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_mojo_cross_loads_between_the_packages(family):
    """A port-trained model's MOJO: both packages read it and write it
    back out equal; each package's MOJO scores in the other within the
    family's bar."""
    from h2o3_tpu.models import mojo as jmojo

    kind, train, what, bar = FAMILIES[family]
    jf, tf = _frames(kind)
    pm = train(tf)
    pb = mojo.export_mojo_bytes(pm)
    rm = jmojo.read_mojo(pb)                    # the reference's model
    rb = jmojo.export_mojo_bytes(rm)            # written by the reference
    qb = mojo.export_mojo_bytes(mojo.read_mojo(pb))
    assert_same_container(rb, qb, family)

    want = model_outputs(rm, jf, what, tf.nrows)
    from_ref = mojo.read_mojo(rb)               # the port reads the ref's
    _assert_outputs(want, model_outputs(from_ref, tf, what, tf.nrows), bar,
                    (family, "reference MOJO in the port"))
    _assert_outputs(model_outputs(pm, tf, what, tf.nrows), want, bar,
                    (family, "port MOJO in the reference"))
    if hasattr(pm, "forest"):
        assert_bitwise(_margins(rm, jf, tf.nrows),
                       _margins(from_ref, tf, tf.nrows), family)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_round_trip_is_bitwise(family, tmp_path):
    """download_mojo -> read_mojo -> predict: every column bit for bit."""
    kind, train, what, _ = FAMILIES[family]
    _, tf = _frames(kind)
    pm = train(tf)
    path = pm.download_mojo(str(tmp_path))
    assert path.endswith(f"{pm.key}.zip")
    back = mojo.read_mojo(path)
    assert type(back) is type(pm)
    _assert_outputs(model_outputs(pm, tf, what, tf.nrows),
                    model_outputs(back, tf, what, tf.nrows), None, family)


# models the JAX package trains itself, and the port's bar for each
REFERENCE_TRAINED = {
    "gbm": ("bin", "h2o3_tpu.models.tree.gbm", "GBM",
            dict(ntrees=4, max_depth=3, seed=1), 1e-6),
    "glm": ("bin", "h2o3_tpu.models.glm", "GLM",
            dict(family="binomial", lambda_=0.0), 1e-5),
    "kmeans": ("none", "h2o3_tpu.models.kmeans", "KMeans",
               dict(k=3, seed=6), 1e-5),
    "deeplearning": ("bin", "h2o3_tpu.models.deeplearning", "DeepLearning",
                     dict(hidden=[8, 8], epochs=2, seed=7), 1e-5),
}


@pytest.mark.parametrize("family", sorted(REFERENCE_TRAINED))
def test_reference_trained_mojo_scores_in_the_port(family):
    import importlib

    from h2o3_tpu.models import mojo as jmojo

    kind, mod, cls, parms, bar = REFERENCE_TRAINED[family]
    jf, tf = _frames(kind)
    builder = getattr(importlib.import_module(mod), cls)(**parms)
    jm = (builder.train(training_frame=jf) if kind == "none"
          else builder.train(y="y", training_frame=jf))
    pm = mojo.read_mojo(jmojo.export_mojo_bytes(jm))
    _assert_outputs(model_outputs(jm, jf, "predict", tf.nrows),
                    model_outputs(pm, tf, "predict", tf.nrows), bar, family)
    if family == "gbm":
        assert_bitwise(_margins(jm, jf, tf.nrows), _margins(pm, tf, tf.nrows))
        thr = jm._output.training_metrics.auc_data.max_f1_threshold
        assert pm._output.training_metrics.auc_data.max_f1_threshold == thr


def test_import_puts_device_tensors_on_the_runtime_device():
    """GLM's beta and DeepLearning's weights land on the runtime's device
    (the CPU here); every .npy is read without pickle."""
    _, tf = _frames("bin")
    glm = FAMILIES["glm"][1](tf)
    dl = FAMILIES["deeplearning"][1](tf)
    g = mojo.read_mojo(mojo.export_mojo_bytes(glm))
    d = mojo.read_mojo(mojo.export_mojo_bytes(dl))
    assert isinstance(g.beta, torch.Tensor) and g.beta.device.type == "cpu"
    assert all(isinstance(W, torch.Tensor) for W, _ in d.params_tree)
    parts = mojo_parts(mojo.export_mojo_bytes(glm))
    assert json.loads(parts["scorer.json"])["algo"] == "glm"
    info = dict(ln.split(" = ") for ln in parts["model.ini"].decode()
                .splitlines() if " = " in ln)
    assert info["h2o_version"] == "h2o3_tpu_torch"
    assert float(info["mojo_version"]) == mojo.MOJO_VERSION


def test_not_a_mojo_raises():
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("x.txt", "nothing")
    with pytest.raises(ValueError, match="not a MOJO"):
        mojo.read_mojo(buf.getvalue())
    _, tf = _frames("bin")
    m = th.GAM(gam_columns=["n0"], bs=[0]).train(y="y", training_frame=tf)
    with pytest.raises(ValueError, match="not supported"):
        mojo.export_mojo_bytes(m)


# ---------------------------------------------------------------------------
# H2OGenericEstimator
# ---------------------------------------------------------------------------

def test_generic_estimator_round_trip(tmp_path):
    """H2OGenericEstimator(path=...).train(): predictions bit for bit,
    the inner algo named, metrics computed, the model under its
    model_id in the DKV."""
    _, tf = _frames("bin")
    m = FAMILIES["gbm"][1](tf)
    path = m.download_mojo(str(tmp_path / "for_generic.zip"))
    gm = th.H2OGenericEstimator(path=path, model_id="gen_1").train()
    assert th.H2OGenericEstimator is th.Generic
    assert "generic" in th.BUILDERS and gm.algo_name == "generic"
    assert gm.inner_algo == "gbm"
    assert th.get_model("gen_1") is gm
    _assert_outputs(model_outputs(m, tf, "predict", tf.nrows),
                    model_outputs(gm, tf, "predict", tf.nrows), None, "generic")
    mm = gm.model_performance(tf)
    assert np.isfinite(mm.auc)
    again = mojo.read_mojo(mojo.export_mojo_bytes(gm))   # re-exports inner
    _assert_outputs(model_outputs(m, tf, "predict", tf.nrows),
                    model_outputs(again, tf, "predict", tf.nrows), None, "again")
    with pytest.raises(ValueError, match="path"):
        th.Generic().train()


def _calibrated_java_mojo(model, beta, icept):
    """The port's Java-format export of `model` with a Platt calibration
    added to model.ini as h2o-3 writes it (calib_method, calib_glm_beta
    = [beta, intercept])."""
    from h2o3_tpu_torch.models.mojo_java import export_java_mojo_bytes

    parts = mojo_parts(export_java_mojo_bytes(model))
    ini = parts["model.ini"].decode().replace(
        "[columns]", f"calib_method = platt\ncalib_glm_beta = "
                     f"[{beta!r}, {icept!r}]\n\n[columns]", 1)
    parts["model.ini"] = ini.encode()
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, data in parts.items():
            z.writestr(name, data)
    return buf.getvalue()


def test_generic_calibrated_columns_match_the_reference(tmp_path):
    """A reference-format MOJO with a Platt calibration gives cal_N and
    cal_Y columns in the Generic model, as the JAX package's Generic
    gives them on the same artifact (1e-6: float32 exp)."""
    from h2o3_tpu.models.generic import Generic as JGeneric

    jf, tf = _frames("bin")
    m = FAMILIES["gbm"][1](tf)
    path = tmp_path / "calibrated.zip"
    path.write_bytes(_calibrated_java_mojo(m, -2.5, 1.25))
    gm = th.Generic(path=str(path)).train()
    jg = JGeneric(path=str(path)).train()
    got = model_outputs(gm, tf, "predict", tf.nrows)
    want = model_outputs(jg, jf, "predict", tf.nrows)
    assert {"cal_N", "cal_Y"} <= set(got)
    _assert_outputs(want, got, 1e-6, "calibrated generic")
    p0 = got["N"].astype(np.float64)
    np.testing.assert_allclose(got["cal_Y"],
                               1 / (1 + np.exp(-(-2.5 * p0 + 1.25))),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the genmodel standalone contract
# ---------------------------------------------------------------------------

GENMODEL = {
    "gbm_binomial": ("bin", FAMILIES["gbm"][1]),
    "gbm_multinomial": ("multi", FAMILIES["gbm_multinomial"][1]),
    "gbm_poisson": ("count", FAMILIES["gbm_poisson"][1]),
    "drf_double_trees": ("bin", FAMILIES["drf_double_trees"][1]),
    "drf_binomial": ("bin", lambda fr: th.DRF(ntrees=3, max_depth=4,
                                              seed=2).train(
        y="y", training_frame=fr)),
    "isolationforest": ("none", FAMILIES["isolationforest"][1]),
    "xgboost": ("bin", FAMILIES["xgboost"][1]),
    "glm_binomial": ("bin", FAMILIES["glm"][1]),
    "glm_multinomial": ("multi", FAMILIES["glm_multinomial"][1]),
    "glm_gaussian": ("reg", lambda fr: th.GLM(family="gaussian").train(
        y="y", training_frame=fr)),
    "kmeans": ("none", FAMILIES["kmeans"][1]),
    "deeplearning": ("bin", FAMILIES["deeplearning"][1]),
}


def _raw(cols):
    return {k: v[0] for k, v in cols.items() if k != "y"}


@pytest.mark.parametrize("family", sorted(GENMODEL))
def test_genmodel_scores_port_mojo_as_the_port(family):
    """h2o3_genmodel.load_mojo(port bytes).score(raw columns) equals the
    port's predict: labels equal, numbers within atol 1e-5, rtol 1e-5."""
    import h2o3_genmodel as gm

    kind, train = GENMODEL[family]
    cols = family_cols(kind)
    _, tf = both_frames(cols)
    m = train(tf)
    got = gm.load_mojo(mojo.export_mojo_bytes(m)).score(_raw(cols))
    want = m.predict(tf)
    compared = 0
    for name in want.names:
        if name not in got:
            continue
        col = want.col(name)
        a = col.to_numpy()
        if col.domain:
            a = np.asarray(col.domain, object)[a.astype(int)]
            assert (a.astype(str) == np.asarray(got[name]).astype(str)
                    ).all(), (family, name)
        else:
            np.testing.assert_allclose(a.astype(float),
                                       np.asarray(got[name], float),
                                       atol=1e-5, rtol=1e-5,
                                       err_msg=f"{family} {name}")
        compared += 1
    assert compared == len(want.names), (family, want.names, sorted(got))


@pytest.mark.parametrize("row", [{"n0": 0.1, "c0": "NEVER_SEEN"},
                                 {"n0": 0.1}],
                         ids=["unseen_level", "missing_columns"])
def test_genmodel_scores_unseen_levels_and_missing_columns_as_na(row):
    """An unseen level and absent columns score through the NA path, as
    the port scores the same row with those cells NA."""
    import h2o3_genmodel as gm

    cols = family_cols("bin")
    _, tf = both_frames(cols)
    m = FAMILIES["gbm"][1](tf)
    one = gm.load_mojo(mojo.export_mojo_bytes(m)).predict(dict(row))
    full = {k: (np.asarray([row[k]], object if k in ("c0", "c1")
                           else float), "enum" if k in ("c0", "c1")
                else None) for k in row}
    _, rf = both_frames(full)
    p = m.predict(rf)
    assert one.label in ("Y", "N")
    assert one.label == p.col("predict").values()[0]
    np.testing.assert_allclose(one.class_probabilities[1],
                               float(p.col("Y").to_numpy()[0]), atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["gbm", "glm", "deeplearning",
                                    "kmeans"])
def test_card_round_trip_is_bitwise(family, tmp_path):
    """On the card: train, download_mojo, H2OGenericEstimator, predict:
    every column bit for bit; the restored tensors on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kind, train, what, _ = FAMILIES[family]
    th.init()
    try:
        fr = th.Frame()
        for k, (a, c) in family_cols(kind).items():
            fr.add(k, th.Column.from_numpy(a, ctype=c, device="cuda"))
        m = train(fr)
        g = th.H2OGenericEstimator(
            path=m.download_mojo(str(tmp_path))).train()
        _assert_outputs(model_outputs(m, fr, what, fr.nrows),
                        model_outputs(g, fr, what, fr.nrows), None, family)
        if family == "glm":
            assert g._inner.beta.device.type == "cuda"
    finally:
        th.init(device="cpu")
