"""The port's reference-format (Java) MOJO reader and writer
(models/mojo_java.py) against the JAX package's.

The reference's own Java-MOJO tests (tests/test_java_mojo.py) need h2o-3's
fixture artifacts and skip without them; these hold the port to the JAX
package's writer and reader directly. Each model is trained by the port
on the CPU and reaches the JAX package through the native MOJO (the same
forest or the same coefficients, bit for bit, tests/test_torch_mojo.py),
so both packages hold one model. Then:
- the port's Java export equals the JAX package's byte for byte: every
  trees/t*.bin, model.ini and every domain file;
- the port reads the JAX package's Java bytes and its forest walk scores
  the same rows bit for bit as the JAX package's reader (the raw (n, K)
  tree sums, and the genmodel rows they walk); the probabilities and
  values after the link agree to 1e-6 (float32 exp, ROADMAP C2), GLM's
  float64 ones to 1e-12;
- the port's own round trip (export, read, predict) is within the
  reference's bar, atol 2e-5, with labels agreeing on more than 99.5% of
  rows (tests/test_java_mojo.py:160-178);
- the GLM gates raise as the reference's do.
"""

import io
import zipfile

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch.models import mojo, mojo_java

from torch_port_support import (assert_bitwise, both_frames, family_cols,
                                mojo_parts, model_outputs)


def _tweedie_cols(n=256, seed=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    mu = np.exp(0.8 * X[:, 0] - 0.3 * X[:, 1] + 1.0)
    return {"a": (X[:, 0], None), "b": (X[:, 1], None),
            "y": (rng.poisson(mu).astype(np.float64), None)}


FAMILIES = {
    "gbm_binomial": (lambda: family_cols("bin"), lambda fr: th.GBM(
        ntrees=4, max_depth=4, seed=1).train(y="y", training_frame=fr)),
    "gbm_regression": (lambda: family_cols("reg"), lambda fr: th.GBM(
        ntrees=3, max_depth=3, seed=2).train(y="y", training_frame=fr)),
    "gbm_multinomial": (lambda: family_cols("multi"), lambda fr: th.GBM(
        ntrees=3, max_depth=3, seed=3).train(y="y", training_frame=fr)),
    "drf_binomial": (lambda: family_cols("bin"), lambda fr: th.DRF(
        ntrees=4, max_depth=5, seed=4).train(y="y", training_frame=fr)),
    "drf_regression": (lambda: family_cols("reg"), lambda fr: th.DRF(
        ntrees=3, max_depth=4, seed=5).train(y="y", training_frame=fr)),
    "drf_double_trees": (lambda: family_cols("bin"), lambda fr: th.DRF(
        ntrees=3, max_depth=4, seed=9, binomial_double_trees=True).train(
        y="y", training_frame=fr)),
    "glm_binomial": (lambda: family_cols("bin"), lambda fr: th.GLM(
        family="binomial", lambda_=0.0, seed=1).train(
        y="y", training_frame=fr)),
    "glm_gaussian": (lambda: family_cols("reg"), lambda fr: th.GLM(
        family="gaussian", lambda_=0.0, seed=1).train(
        y="y", training_frame=fr)),
    "glm_tweedie": (_tweedie_cols, lambda fr: th.GLM(
        family="tweedie", lambda_=0.0, seed=1).train(
        y="y", training_frame=fr)),
}


def _pair(family):
    """(JAX frame, port frame, port model, the JAX package's copy)."""
    from h2o3_tpu.models import mojo as jmojo

    make, train = FAMILIES[family]
    jf, tf = both_frames(make())
    pm = train(tf)
    return jf, tf, pm, jmojo.read_mojo(mojo.export_mojo_bytes(pm))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_java_export_equals_the_reference(family):
    from h2o3_tpu.models.mojo_java import export_java_mojo_bytes

    _, _, pm, rm = _pair(family)
    a = mojo_parts(export_java_mojo_bytes(rm))
    b = mojo_parts(mojo_java.export_java_mojo_bytes(pm))
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for name in a:
        assert a[name] == b[name], (family, name)
    if family.startswith(("gbm", "drf")):
        assert any(n.startswith("trees/t00_") for n in b)
    if family == "drf_double_trees":
        ini = b["model.ini"].decode()
        assert "binomial_double_trees = true" in ini
        assert "n_trees_per_class = 2" in ini
        assert any(n.startswith("trees/t01_") for n in b)


def _inner(model, module):
    """The JavaTreeModel a tree model read from a Java MOJO scores with
    (its _predict_raw closes over it in both packages)."""
    return next(c.cell_contents for c in model._predict_raw.__closure__
                if isinstance(c.cell_contents, module.JavaTreeModel))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_reads_reference_java_mojo_bit_for_bit(family):
    from h2o3_tpu.models import mojo as jmojo
    from h2o3_tpu.models import mojo_java as jjava

    jf, tf, _, rm = _pair(family)
    blob = jjava.export_java_mojo_bytes(rm)
    ref, port = jmojo.read_mojo(blob), mojo.read_mojo(blob)
    n = tf.nrows
    Xr = jjava._frame_matrix(ref, ref.adapt_test(jf))[:n]
    Xp = mojo_java._frame_matrix(port, port.adapt_test(tf))
    assert_bitwise(Xr, Xp.numpy(), (family, "genmodel rows"))
    if family.startswith(("gbm", "drf")):
        assert_bitwise(_inner(ref, jjava).raw_scores(Xr),
                       _inner(port, mojo_java).raw_scores(Xp).numpy(),
                       (family, "forest scores"))
    want = model_outputs(ref, jf, "predict", n)
    got = model_outputs(port, tf, "predict", n)
    assert sorted(want) == sorted(got)
    bar = 1e-12 if family.startswith("glm") else 1e-6
    for name in want:
        a, b = np.asarray(want[name]), np.asarray(got[name])
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=0,
                                       atol=bar, err_msg=f"{family} {name}")
        else:
            assert (a == b).all(), (family, name)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_java_round_trip(family):
    """export_java_mojo_bytes -> read_mojo -> predict against the model's
    own predictions: atol 2e-5, labels on more than 99.5% of rows."""
    make, train = FAMILIES[family]
    _, tf = both_frames(make())
    pm = train(tf)
    back = mojo.read_mojo(mojo_java.export_java_mojo_bytes(pm))
    assert mojo_java.is_java_mojo(mojo_java.export_java_mojo_bytes(pm))
    want = pm.predict(tf)
    got = back.predict(tf)
    assert want.names == got.names
    for name in want.names:
        a, b = want.col(name).to_numpy(), got.col(name).to_numpy()
        if want.col(name).domain:
            assert want.col(name).domain == got.col(name).domain
            assert (a == b).mean() > 0.995, (family, name)
        else:
            np.testing.assert_allclose(a.astype(float), b.astype(float),
                                       atol=2e-5, err_msg=family)


def test_generic_reads_a_java_mojo_directory(tmp_path):
    """An exploded reference MOJO (a directory) goes to the Java reader,
    through read_mojo and Generic alike."""
    _, tf = both_frames(family_cols("bin"))
    pm = FAMILIES["gbm_binomial"][1](tf)
    with zipfile.ZipFile(io.BytesIO(
            mojo_java.export_java_mojo_bytes(pm))) as z:
        z.extractall(tmp_path)
    assert mojo_java.is_java_mojo(str(tmp_path))
    g = th.Generic(path=str(tmp_path)).train()
    assert g.inner_algo == "gbm"
    np.testing.assert_allclose(g.predict(tf).col("Y").to_numpy(),
                               pm.predict(tf).col("Y").to_numpy(), atol=2e-5)


GATES = {
    "offset": lambda fr: th.GLM(family="poisson", lambda_=0.0,
                                offset_column="off", seed=1).train(
        y="y", training_frame=fr),
    "multinomial": lambda fr: th.GLM(family="multinomial").train(
        y="ym", training_frame=fr),
    "ordinal": lambda fr: th.GLM(family="ordinal").train(
        y="ym", training_frame=fr),
    "interaction": lambda fr: th.GLM(family="gaussian", lambda_=0.0,
                                     interactions=["a", "b"]).train(
        y="y", training_frame=fr),
    "kmeans": lambda fr: th.KMeans(k=2, seed=1).train(
        training_frame=fr, x=["a", "b"]),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_unsupported_models_raise_as_the_reference(gate):
    """GLM offsets, multinomial and ordinal GLMs, interaction columns and
    algorithms other than gbm/drf/glm raise ValueError with the
    reference's message."""
    from h2o3_tpu.models import mojo as jmojo
    from h2o3_tpu.models import mojo_java as jjava

    cols = _tweedie_cols()
    rng = np.random.default_rng(3)
    cols["off"] = (np.ones(256), None)
    cols["ym"] = (np.asarray(["p", "q", "r"])[rng.integers(0, 3, 256)],
                  "enum")
    _, tf = both_frames(cols)
    pm = GATES[gate](tf)
    with pytest.raises(ValueError) as port_err:
        mojo_java.export_java_mojo_bytes(pm)
    if gate == "interaction":
        # the native MOJO keeps only plain parameters, so it cannot carry
        # the interaction list to the reference: the reference's text
        assert "does not cover interaction columns" in str(port_err.value)
        return
    rm = jmojo.read_mojo(mojo.export_mojo_bytes(pm))
    with pytest.raises(ValueError) as ref_err:
        jjava.export_java_mojo_bytes(rm)
    assert str(port_err.value) == str(ref_err.value)
