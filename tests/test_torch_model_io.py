"""The model framework's remaining surface in the port: save/load, model
keys and export, leaf-node assignment, gains/lift and KS, and the
forest compile-check entry, against the JAX package on the CPU where it
has a counterpart.

Tolerances: save/load round trips bitwise (every prediction column);
leaf assignment (Path and Node_ID) bitwise on a forest carried over
from the JAX package; gains/lift cells and KS to 1e-6 (the same
400-bin histograms, summed in float32 in different orders); the
forest_predict_fn margins bitwise (the same forest, leaf values added in
tree order)."""

import pickle
import struct

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.models.model import Model

from torch_port_support import (both_frames, carry_forest, dl_cols,
                                flagship_cols, train_cols)


def _frame(cols):
    th.init(device="cpu")
    return both_frames(cols)[1]


def _preds(m, fr):
    if hasattr(m, "autoencoder") and m.autoencoder:
        return {"mse": m.anomaly(fr).col("Reconstruction.MSE").to_numpy()}
    p = m.predict(fr)
    return {c: p.col(c).to_numpy() for c in p.names}


MODELS = {
    "gbm": lambda: (th.GBM(ntrees=3, max_depth=3, seed=1), "bin"),
    "gbm_multinomial": lambda: (th.GBM(ntrees=2, max_depth=3, seed=1),
                                "multi"),
    "drf": lambda: (th.DRF(ntrees=3, max_depth=5, seed=1), "bin"),
    "xgboost": lambda: (th.XGBoost(ntrees=2, max_depth=3, seed=1,
                                   nbins=16), "reg"),
    "isolationforest": lambda: (th.IsolationForest(ntrees=5, seed=1),
                                "none"),
    "extended_if": lambda: (th.ExtendedIsolationForest(ntrees=5, seed=1),
                            "none"),
    "glm": lambda: (th.GLM(family="binomial"), "bin"),
    "gam": lambda: (th.GAM(gam_columns=["n0"], bs=[0]), "reg"),
    "rulefit": lambda: (th.RuleFit(rule_generation_ntrees=3, seed=1),
                        "bin"),
    "deeplearning": lambda: (th.DeepLearning(hidden=[8], epochs=1, seed=1),
                             "multi"),
    "dl_autoencoder": lambda: (th.DeepLearning(hidden=[8], epochs=1, seed=1,
                                               autoencoder=True), "none"),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_save_load_round_trip_is_bitwise(tmp_path, name):
    builder, kind = MODELS[name]()
    cols = dl_cols({"bin": "binomial", "multi": "multinomial",
                    "reg": "regression", "none": "autoencoder"}[kind],
                   n=256, seed=2)
    fr = _frame(cols)
    y = None if kind == "none" else "y"
    m = builder.train(y=y, training_frame=fr)
    path = m.save(str(tmp_path / "m.bin"))
    with open(path, "rb") as f:
        head = f.read(10)
    assert head[:8] == b"H2OTORCH"
    assert struct.unpack("<H", head[8:])[0] == Model._SAVE_VERSION
    back = th.load_model(path)
    assert type(back) is type(m) and back.key == m.key
    assert back._output.names == m._output.names
    a, b = _preds(m, fr), _preds(back, fr)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    tm = m._output.training_metrics
    if tm is not None:
        assert back._output.training_metrics.mse == tm.mse


def _write(path, payload: bytes, version=Model._SAVE_VERSION):
    with open(path, "wb") as f:
        f.write(Model._SAVE_MAGIC + struct.pack("<H", version) + payload)


def test_load_refuses_foreign_newer_and_other_files(tmp_path):
    class Evil:
        def __reduce__(self):
            return (print, ("this would run",))

    p = tmp_path / "evil.bin"
    _write(p, pickle.dumps((Model, {"x": Evil()})))
    with pytest.raises(ValueError, match="disallowed"):
        th.load_model(str(p))
    # a pickled torch tensor names torch's rebuild callables: refused
    _write(p, pickle.dumps((Model, {"t": torch.zeros(3)})))
    with pytest.raises(ValueError, match="disallowed"):
        th.load_model(str(p))
    # a class of the port that is not a model
    _write(p, pickle.dumps((th.Frame, {})))
    with pytest.raises(ValueError, match="not a model"):
        th.load_model(str(p))
    m = th.GBM(ntrees=1).train(y="y", training_frame=_frame(train_cols(
        n=64)))
    good = m.save(str(tmp_path / "good.bin"))
    raw = open(good, "rb").read()
    _write(p, raw[10:], version=Model._SAVE_VERSION + 1)
    with pytest.raises(ValueError, match="newer"):
        th.load_model(str(p))
    p.write_bytes(b"PK\x03\x04 not a model")
    with pytest.raises(ValueError, match="not an h2o3_tpu_torch model"):
        th.load_model(str(p))


@pytest.mark.parametrize("module,name", [
    ("h2o3_tpu_torch.native", "subprocess.Popen"),
    ("h2o3_tpu_torch.native", "ctypes.CDLL"),
    ("h2o3_tpu_torch.native", "subprocess"),
    ("h2o3_tpu_torch.native", "Path"),
])
def test_load_refuses_names_reached_through_the_port(tmp_path, module,
                                                     name):
    """A protocol-4 file may name `module` / `name` where `name` is
    dotted (pickle then follows attributes) or a class the port only
    imports: both are refused before anything is called."""
    def glob(mod, nm):
        out = b""
        for s in (mod, nm):
            b = s.encode()
            out += pickle.SHORT_BINUNICODE + bytes([len(b)]) + b
        return out + pickle.STACK_GLOBAL

    body = (pickle.PROTO + bytes([4])
            + glob("h2o3_tpu_torch.models.model", "Model")
            + glob(module, name)
            + pickle.SHORT_BINUNICODE + b"\x04echo" + pickle.TUPLE1
            + pickle.REDUCE + pickle.TUPLE2 + pickle.STOP)
    p = tmp_path / "evil.bin"
    _write(p, body)
    with pytest.raises(ValueError, match="disallowed"):
        th.load_model(str(p))


def test_model_keys_and_export(tmp_path):
    fr = _frame(train_cols(n=128))
    m = th.GBM(ntrees=1, model_id="my_gbm",
               export_checkpoints_dir=str(tmp_path / "ck")).train(
        y="y", training_frame=fr)
    assert m.key == "my_gbm"
    back = th.load_model(str(tmp_path / "ck" / "my_gbm.bin"))
    assert back.forest.leaf_val.tobytes() == m.forest.leaf_val.tobytes()
    a = th.GBM(ntrees=1).train(y="y", training_frame=fr)
    b = th.GBM(ntrees=1).train(y="y", training_frame=fr)
    assert a.key.startswith("GBMModel_") and a.key != b.key
    assert "GBMModel_" in repr(a)


# --- leaf assignment -------------------------------------------------------

@pytest.mark.parametrize("multi", [False, True])
def test_leaf_assignment_bitwise_vs_jax(cl, monkeypatch, multi):
    """The reference's eager branch (spec.bin_columns + forest.leaf_index,
    which it holds bitwise equal to its fused serving path; that path
    does not run on this JAX, ROADMAP "Known env limits")."""
    from h2o3_tpu import scoring
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    monkeypatch.setattr(scoring, "supports", lambda model: False)

    cols = dl_cols("multinomial" if multi else "binomial", n=320, seed=6)
    jf, tf = both_frames(cols)
    jm = JGBM(ntrees=3, max_depth=4, seed=2).train(y="y", training_frame=jf)
    tm = convert.gbm_model_from_numpy(carry_forest(jm))
    n = tf.nrows
    for kind in ("Path", "Node_ID"):
        ja = jm.predict_leaf_node_assignment(jf, type=kind)
        ta = tm.predict_leaf_node_assignment(tf, type=kind)
        assert ta.names == ja.names
        assert len(ta.names) == (9 if multi else 3)
        for nm in ta.names:
            a, b = ja.col(nm), ta.col(nm)
            if kind == "Path":
                assert list(b.values()) == list(a.values()[:n]), nm
                assert b.domain == a.domain
            else:
                np.testing.assert_array_equal(b.to_numpy(),
                                              a.to_numpy()[:n])
    with pytest.raises(ValueError, match="Path or Node_ID"):
        tm.predict_leaf_node_assignment(tf, type="Depth")


# --- gains/lift and KS -------------------------------------------------------

def test_gains_lift_and_ks_match_jax(cl, monkeypatch):
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    jf, tf = both_frames(flagship_cols(2048, seed=4))
    jm = JGBM(ntrees=3, max_depth=3, seed=1).train(y="y", training_frame=jf)
    tm = th.GBM(ntrees=3, max_depth=3, seed=1).train(y="y",
                                                     training_frame=tf)
    assert tm.kolmogorov_smirnov() == pytest.approx(
        jm.kolmogorov_smirnov(), abs=1e-6)
    for frame_j, frame_t in ((None, None), (jf, tf)):
        a, b = jm.gains_lift(frame_j), tm.gains_lift(frame_t)
        assert b.col_names == a.col_names and b.col_types == a.col_types
        assert len(b) == len(a) > 0
        for ra, rb in zip(a.rows, b.rows):
            assert rb[0] == ra[0]
            np.testing.assert_allclose(rb[1:], ra[1:], rtol=1e-6, atol=1e-6)
    assert th.GBM(ntrees=1).train(y="y", training_frame=_frame(
        train_cols(n=64, gaussian=True))).gains_lift() is None


def test_forest_predict_fn_matches_jax():
    from h2o3_tpu.models.tree.compressed import forest_predict_fn as jfn

    from h2o3_tpu_torch.models.tree.compressed import forest_predict_fn

    jf, jargs = jfn()
    tf, targs = forest_predict_fn(device="cpu")
    assert tuple(targs[0].shape) == tuple(jargs[0].shape) == (1024, 32)
    np.testing.assert_array_equal(targs[0].numpy(), np.asarray(jargs[0]))
    got = tf(*targs).numpy()
    assert got.tobytes() == np.asarray(jf(*jargs)).tobytes()
