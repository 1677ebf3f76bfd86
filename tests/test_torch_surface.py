"""The h2o-py surface of the port (h2o3_tpu_torch/__init__.py,
estimators.py, extensions.py, assembly.py, bindings.py) against the JAX
package's, on the CPU.

Tolerances: estimator names resolve to the builder of the same class
name as the reference's; an exported CSV re-imports through both
packages to frames equal bit for bit (torch_port_support.
assert_frames_match), and to the exported values; an assembly's output
frames agree to abs 1e-6 + rel 1e-6: the same float32 ops in torch and
in jax.numpy or the Rapids prims, whose log, cos and pow may differ in
the last ulp (ROADMAP C2), and the scaler's statistics are the same
numpy sums in both."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th

from torch_port_support import assert_frames_match, both_frames, \
    flagship_cols


def test_estimator_names_resolve_to_the_ports_builders(cl):
    import h2o3_tpu as ref

    names = set(ref._ESTIMATORS) - {"start_server", "exec_rapids"}
    assert set(th._ESTIMATORS) == names
    for name in sorted(names - {"H2OAutoML", "H2OGridSearch",
                                "H2OAssembly"}):
        got, want = getattr(th, name), getattr(ref, name)
        assert got.__name__ == want.__name__, name
        assert got.__module__.startswith("h2o3_tpu_torch."), name
        assert got.algo_name == want.algo_name, name
        if name != "H2OAutoEncoderEstimator":
            assert th.BUILDERS[got.algo_name] is got, name
    assert th.H2OAutoEncoderEstimator().params["autoencoder"] is True
    assert th.H2OAutoML.__module__ == "h2o3_tpu_torch.automl.automl"
    assert th.H2OGridSearch.__module__ == "h2o3_tpu_torch.grid"
    assert th.H2OAssembly.__module__ == "h2o3_tpu_torch.assembly"
    assert th.H2OGenericEstimator is th.Generic
    with pytest.raises(AttributeError, match="no attribute"):
        th.H2ONoSuchEstimator
    assert "H2OAutoML" in dir(th)
    from h2o3_tpu_torch.models import drf, gbm, isofor

    assert gbm.H2OGradientBoostingEstimator is th.GBM
    assert drf.H2ORandomForestEstimator is th.DRF
    assert isofor.H2OIsolationForestEstimator is th.IsolationForest


def test_top_level_helpers():
    _, tf = both_frames(flagship_cols(128))
    tf.install()
    assert th.get_frame(tf.key) is th.frame(tf.key) is tf
    m = th.GLM(family="binomial").train(y="y", training_frame=tf)
    assert th.get_model(m.key) is m and str(m.key) in th.ls()
    th.remove(m.key)
    with pytest.raises(KeyError, match="No model"):
        th.get_model(m.key)
    with pytest.raises(KeyError, match="No frame"):
        th.get_frame("no_such_frame")
    from h2o3_tpu_torch.utils import log

    th.no_progress()
    assert log.PROGRESS is False
    th.show_progress()
    assert log.PROGRESS is True
    assert log.get_logger() is log.get_logger()
    keep = {k: th.DKV.get(k) for k in th.DKV.keys()}
    try:
        th.remove_all()
        assert th.ls() == []
    finally:
        for k, v in keep.items():
            th.DKV.put(k, v)


def test_export_file_round_trips_through_both_packages(cl, tmp_path):
    from h2o3_tpu.ingest.parser import import_file as jimport

    rng = np.random.default_rng(4)
    n = 128
    real = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)
    real[[3, 77]] = np.nan
    ints = rng.integers(-50, 50, n).astype(float)
    ints[5] = np.nan
    lab = np.array(["lo", "mid", "hi,comma", 'q"uote'], object)[
        rng.integers(0, 4, n)]
    lab[9] = None
    cols = {"real": (real, None), "ints": (ints, "int"),
            "lab": (lab, "enum")}
    _, tf = both_frames(cols)
    path = str(tmp_path / "out.csv")
    assert th.export_file(tf, path) == path
    with pytest.raises(FileExistsError):
        th.export_file(tf, path)
    th.export_file(tf, path, force=True)
    jf2, tf2 = jimport(path), th.import_file(path)
    assert_frames_match(jf2, tf2, "exported csv")
    assert tf2.names == ["real", "ints", "lab"]
    np.testing.assert_array_equal(tf2.col("real").data.numpy(),
                                  tf.col("real").data.numpy())
    np.testing.assert_array_equal(tf2.col("ints").data.numpy(),
                                  tf.col("ints").data.numpy())
    assert list(tf2.col("lab").values()) == list(tf.col("lab").values())


# -- extensions ---------------------------------------------------------------

@pytest.fixture()
def fresh_extensions(monkeypatch):
    from h2o3_tpu_torch import extensions

    monkeypatch.setattr(extensions, "_EXTENSIONS", {})
    monkeypatch.setattr(extensions, "_INITIALIZED", [])
    return extensions


def test_extension_hooks_run_once_at_boot(fresh_extensions, monkeypatch):
    from h2o3_tpu_torch.core import runtime

    ext = fresh_extensions
    seen = []
    monkeypatch.setattr(runtime, "_CLUSTER", None)
    ext.register_extension("probe", lambda c: seen.append(c.device))
    ext.register_extension("broken", lambda c: 1 / 0)
    assert seen == []
    th.init(device="cpu")
    th.init(device="cpu")
    assert seen == [torch.device("cpu")]
    assert ext.extensions() == ["broken", "probe"]
    ext.register_extension("late", lambda c: seen.append("late"))
    assert seen[-1] == "late"


# -- assembly -----------------------------------------------------------------

def _asm_frames(seed=0, n=256):
    rng = np.random.default_rng(seed)
    return both_frames({"a": (rng.uniform(1, 10, n), None),
                        "b": (rng.standard_normal(n) * 5 + 20, None),
                        "junk": (rng.standard_normal(n), None)})


def _assert_same(jf, tf):
    assert tf.names == jf.names
    for nm in jf.names:
        np.testing.assert_allclose(tf.col(nm).data.numpy(),
                                   np.asarray(jf.col(nm).data)[:jf.nrows],
                                   atol=1e-6, rtol=1e-6, err_msg=nm)


def test_assembly_fit_and_apply_match_reference(cl, tmp_path):
    import h2o3_tpu.assembly as ja

    import h2o3_tpu_torch.assembly as ta

    def steps(m):
        return [("select", m.H2OColSelect(["a", "b"])),
                ("log_a", m.H2OColOp("log", col="a", inplace=True)),
                ("cos_b", m.H2OColOp("cos", col="b", inplace=False)),
                ("scale", m.H2OScaler()),
                ("sum", m.H2OBinaryOp("+", "a", "b", new_col_name="ab")),
                ("div", m.H2OBinaryOp("/", "ab", "cos_b"))]

    jf, tf = _asm_frames()
    jasm, tasm = ja.H2OAssembly(steps(ja)), th.H2OAssembly(steps(ta))
    _assert_same(jasm.fit(jf), tasm.fit(tf))
    assert tasm.names == jasm.names
    for stat in ("means", "sds"):
        assert getattr(tasm.steps[3][1], stat) == pytest.approx(
            getattr(jasm.steps[3][1], stat), rel=1e-6)
    jf2, tf2 = _asm_frames(seed=1)
    _assert_same(jasm.transform(jf2), tasm.transform(tf2))
    p = str(tmp_path / "asm.bin")
    tasm.save(p)
    _assert_same(jasm.transform(jf2),
                 th.H2OAssembly.load(p).transform(tf2))
    with pytest.raises(RuntimeError, match="not fitted"):
        th.H2OAssembly([("s", ta.H2OScaler())]).transform(tf)
    with pytest.raises(ValueError, match="unknown op"):
        ta.H2OColOp(lambda x: x, col="a")
    assert ta.H2OColOp(torch.cos, col="a").op == "cos"
    from h2o3_tpu_torch.artifact import ArtifactError

    with pytest.raises(ArtifactError, match="not a fused-path"):
        tasm.export_pipeline(None, tf, str(tmp_path))


def test_assembly_wire_steps_match_reference(cl):
    """Steps decoded from the REST wire format run their Rapids
    expression over the frame and splice the result in."""
    import h2o3_tpu.assembly as ja

    wire = ["logx__H2OColOp__(log (cols_py dummy 'a'))__false__loga",
            "sq__H2OColOp__(^ (cols_py dummy 'b') 2)__true__",
            "sel__H2OColSelect__(cols_py dummy ['a' 'b' 'loga'])__true__"]
    jf, tf = _asm_frames(seed=2)
    jasm, tasm = (ja.H2OAssembly.from_steps(wire),
                  th.H2OAssembly.from_steps(wire))
    _assert_same(jasm.fit(jf), tasm.fit(tf))
    assert tasm.describe() == jasm.describe()
    assert tasm.to_source().splitlines()[1:] == \
        jasm.to_source().splitlines()[1:]


# -- bindings -----------------------------------------------------------------

def test_bindings_generate_estimators_that_train(tmp_path):
    from h2o3_tpu_torch import bindings

    src = bindings.generate_python()
    assert "class H2OGradientBoostingEstimator" in src
    assert "from h2o3_tpu_torch.models.model_builder import BUILDERS" in src
    classes = bindings.load_generated()
    assert len(classes) == len(th.BUILDERS)
    _, tf = both_frames(flagship_cols(128))
    est = classes["H2OGradientBoostingEstimator"](ntrees=3, max_depth=3,
                                                  seed=1)
    m = est.train(y="y", training_frame=tf)
    assert float(m._output.training_metrics.auc) > 0.5
    assert est.predict(tf).nrows == 128      # delegated to the model
    xgb = classes["H2OXGBoostEstimator"](n_estimators=2, eta=0.3)
    assert xgb._builder.params["ntrees"] == 2
    p = bindings.write_python(str(tmp_path / "estimators_gen.py"))
    text = open(p).read()
    assert "__all__" in text and "H2OKMeansEstimator" in text
