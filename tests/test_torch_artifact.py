"""The port's scoring artifacts against the JAX package's
(h2o3_tpu/artifact): for forests carried across, ``forest.npz``'s
arrays and ``model_checksum`` are the reference's byte for byte; each
package's `load_model` reads the other's artifact with bitwise margins;
tampered payloads and future format versions raise ArtifactError; the
GLM artifact scores to ROADMAP C30's bound and refuses what the
reference refuses; the
standalone runner, started as a file path with ``--device cpu``, scores
bitwise equal to in-process serving without importing the package; a
second export on the same backend loads its programs from the compile
cache."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch import artifact, convert, scoring
from h2o3_tpu_torch.artifact import compile_cache, packer

from torch_port_support import (assert_bitwise, assert_close, both_frames,
                                carry_forest, frames_bitwise)

ROOT = Path(__file__).resolve().parents[1]
RUNNER = ROOT / "h2o3_tpu_torch" / "artifact" / "runner.py"


def _runner():
    """runner.py loaded by path, as its users run it."""
    spec = importlib.util.spec_from_file_location("artifact_runner", RUNNER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train_cols(n=512, classes=2, seed=11):
    """The reference's artifact fixture (tests/test_artifact.py)."""
    rng = np.random.default_rng(seed)
    cols, logit = {}, np.zeros(n)
    for i in range(4):
        x = rng.standard_normal(n)
        logit += x * ((-1) ** i) * 0.7
        cols[f"n{i}"] = (x, None)
    cols["c0"] = (np.array(["a", "b", "c"])[rng.integers(0, 3, n)], "enum")
    if classes == 2:
        y = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "Y", "N")
    else:
        y = np.array(["c%d" % (v % classes)
                      for v in rng.integers(0, classes, n)])
    cols["y"] = (y, "enum")
    return cols


def _test_cols(n=80, seed=13):
    rng = np.random.default_rng(seed)
    cols = {}
    for i in range(4):
        x = rng.standard_normal(n)
        x[i::9] = np.nan
        cols[f"n{i}"] = (x, None)
    c = np.array(["a", "b", "c", "zz"], object)[rng.integers(0, 4, n)]
    c[::13] = None
    cols["c0"] = (c, "enum")
    return cols


def _raw_columns(cols):
    """The runner's column input: numbers, level strings, None for NA."""
    out = {}
    for nm, (a, ct) in cols.items():
        if ct == "enum":
            out[nm] = [None if v is None else str(v) for v in a]
        else:
            out[nm] = [None if np.isnan(v) else repr(float(v)) for v in a]
    return out


@pytest.fixture(scope="module")
def forests(cl):
    """{kind: (JAX model, port model)} for a binomial and a 3-class GBM."""
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    out = {}
    for kind, classes, kw in (("binomial", 2, dict(ntrees=5, max_depth=3)),
                              ("multinomial", 3, dict(ntrees=3,
                                                      max_depth=3))):
        jf, _tf = both_frames(_train_cols(classes=classes, seed=9 + classes))
        jm = JGBM(seed=7, **kw).train(y="y", training_frame=jf)
        out[kind] = (jm, convert.gbm_model_from_numpy(carry_forest(jm)))
    return out


@pytest.mark.parametrize("kind", ["binomial", "multinomial"])
def test_forest_npz_and_checksum_are_the_references(forests, kind):
    from h2o3_tpu.artifact import packer as jpacker

    jm, tm = forests[kind]
    got = packer.pack_forest(tm.forest, tm.spec)
    want = jpacker.pack_forest(jm.forest, jm.spec)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.ascontiguousarray(got[k]), np.ascontiguousarray(want[k])
        assert (a.dtype, a.shape) == (b.dtype, b.shape), k
        assert a.tobytes() == b.tobytes(), k
    assert packer.forest_meta(tm.forest, tm.spec) == \
        jpacker.forest_meta(jm.forest, jm.spec)
    assert packer.model_checksum(tm.forest, tm.spec) == \
        jpacker.model_checksum(jm.forest, jm.spec)
    assert packer.load_npz(packer.dump_npz(got)).keys() == got.keys()


@pytest.mark.parametrize("kind", ["binomial", "multinomial"])
def test_artifacts_cross_load_between_the_packages(forests, kind, tmp_path):
    from h2o3_tpu import artifact as jartifact
    from h2o3_tpu import scoring as jscoring

    jm, tm = forests[kind]
    jf, tf = both_frames(_test_cols())
    n = tf.nrows
    want = tm._margin(tm.adapt_test(tf)).numpy()
    # the port's artifact, read by the reference
    man = artifact.export_model(tm, str(tmp_path / "port"), buckets=[64])
    assert man["executables"] == [] and man["stablehlo"] == []
    assert [e["bucket"] for e in man["programs"]] == [64]
    jl = jartifact.load_model(str(tmp_path / "port"), install=False)
    js = jscoring.ScoringSession(jl)
    got = np.asarray(js._margin_x(js._features(jl.adapt_test(jf), n)))[:n]
    assert_bitwise(got, want, "reference reads port")
    # the reference's artifact, read by the port
    jartifact.export_model(jm, str(tmp_path / "ref"), buckets=[64])
    tl = artifact.load_model(str(tmp_path / "ref"), install=False)
    assert_bitwise(tl._margin(tl.adapt_test(tf)).numpy(), want,
                   "port reads reference")
    got_p, want_p = tl.predict(tf), tm.predict(tf)
    for lvl in tm._output.response_domain:       # labels: the loaded
        assert_bitwise(got_p.col(lvl).data.numpy(),  # model keeps the
                       want_p.col(lvl).data.numpy())  # max-F1 threshold
    info = artifact.describe(str(tmp_path / "port"))
    assert info["buckets"] == [64] and info["n_features"] == 5
    assert info["programs"][0]["bucket"] == 64


@pytest.mark.parametrize("kind", ["binomial", "multinomial"])
def test_runner_in_process_bitwise(forests, kind, tmp_path):
    _jm, tm = forests[kind]
    art = str(tmp_path / "art")
    artifact.export_model(tm, art, buckets=[16, 64])
    cols = _test_cols(150, seed=17)
    _jf, tf = both_frames(cols)
    sess = scoring.session_for(tm)
    ref = sess._margin_x(sess._features(tm.adapt_test(tf)))
    s = _runner().load_artifact(art, "cpu")
    X = s.pack_features(_raw_columns(cols))
    assert_bitwise(X, sess._features(tm.adapt_test(tf)).numpy())
    assert_bitwise(s.margins(X), ref.numpy())
    probs = tm._margin_to_raw(ref)["probs"].numpy()
    assert_bitwise(s.raw_predict(X)["probs"], probs)
    out = s.score(_raw_columns(cols))
    pred = tm.predict(tf)
    for lvl in tm._output.response_domain:
        assert_bitwise(out[lvl], pred.col(lvl).data.numpy(), lvl)
    dom = pred.col("predict").domain
    assert list(out["predict"]) == [dom[i] for i in
                                    pred.col("predict").data.tolist()]


def test_programs_carry_no_tensors_and_load_without_unpickling(
        forests, tmp_path, monkeypatch):
    """The forest's arrays ride as inputs from forest.npz: a program's
    state dict and constants are empty, and loading it calls no
    unpickler (torch.load)."""
    _jm, tm = forests["multinomial"]
    man = artifact.export_model(tm, str(tmp_path / "art"), buckets=[64])
    data = (tmp_path / "art" / man["programs"][0]["name"]).read_bytes()
    loads = []
    real = torch.load
    monkeypatch.setattr(torch, "load", lambda *a, **k: loads.append(a)
                        or real(*a, **k))
    import io

    ep = torch.export.load(io.BytesIO(data))
    assert loads == [] and not ep.state_dict and not ep.constants
    assert ep.example_inputs is None


def _write_csv(cols, path):
    raw = _raw_columns(cols)
    names = list(raw)
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for i in range(len(raw[names[0]])):
            f.write(",".join("" if raw[nm][i] is None else raw[nm][i]
                             for nm in names) + "\n")


_MODULES_AFTER_RUN = r'''
import json, runpy, sys
sys.argv = [sys.argv[1]] + sys.argv[2:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
print(json.dumps(sorted(k for k in sys.modules if k.startswith("h2o3"))))
'''


def test_runner_as_a_file_path_scores_bitwise_without_the_package(
        forests, tmp_path):
    _jm, tm = forests["binomial"]
    art = str(tmp_path / "art")
    artifact.export_model(tm, art, buckets=[128])
    cols = _test_cols(100, seed=23)
    csv = str(tmp_path / "in.csv")
    _write_csv(cols, csv)
    _jf, tf = both_frames(cols)
    sess = scoring.session_for(tm)
    ref = sess._margin_x(sess._features(tm.adapt_test(tf)))
    args = ["--artifact", art, "--input", csv, "--output",
            str(tmp_path / "out.csv"), "--raw-npz", str(tmp_path / "raw.npz"),
            "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(RUNNER)] + args,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(str(tmp_path / "raw.npz")) as z:
        assert_bitwise(z["margins"], ref.numpy())
        assert_bitwise(z["probs"], tm._margin_to_raw(ref)["probs"].numpy())
    lines = open(tmp_path / "out.csv").read().splitlines()
    assert lines[0] == "predict,N,Y" and len(lines) == 101
    mods = subprocess.run(
        [sys.executable, "-c", _MODULES_AFTER_RUN, str(RUNNER)] + args,
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env)
    assert mods.returncode == 0, mods.stderr[-3000:]
    assert json.loads(mods.stdout.splitlines()[-1]) == []
    # no card and no --device cpu: the runner refuses
    if not torch.cuda.is_available():
        bad = subprocess.run([sys.executable, str(RUNNER)] + args[:-2],
                             capture_output=True, text=True, timeout=300,
                             cwd=str(tmp_path), env=env)
        assert bad.returncode != 0 and "--device cpu" in bad.stderr


def _tamper(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("what", ["forest", "program", "version",
                                  "traversal"])
def test_tampered_or_future_artifacts_are_refused(forests, tmp_path, what):
    from h2o3_tpu import artifact as jartifact

    _jm, tm = forests["binomial"]
    art = str(tmp_path / "art")
    artifact.export_model(tm, art, buckets=[32])
    mpath = os.path.join(art, "manifest.json")
    m = json.load(open(mpath))
    if what == "forest":
        _tamper(os.path.join(art, "forest.npz"))
    elif what == "program":
        _tamper(os.path.join(art, "program_b32.pt2"))
    elif what == "version":
        m["format_version"] = 2
    else:
        m["files"]["forest"]["name"] = "../forest.npz"
    json.dump(m, open(mpath, "w"))
    runner = _runner()
    X = np.zeros((4, 5), np.float32)
    if what == "program":
        artifact.load_model(art, install=False)       # arrays are intact
        with pytest.raises(runner.ArtifactError, match="checksum"):
            runner.load_artifact(art, "cpu").margins(X)
        return
    with pytest.raises(artifact.ArtifactError):
        artifact.load_model(art, install=False)
    with pytest.raises(jartifact.ArtifactError):
        jartifact.load_model(art, install=False)
    with pytest.raises(runner.ArtifactError):
        runner.load_artifact(art, "cpu").margins(X)


def _glm_cols(n, seed, test=False):
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal(n)
    x1[:: 5 if test else 9] = np.nan
    levels = ["a", "b", "c", "zz"] if test else ["a", "b", "c"]
    g = np.array(levels, object)[rng.integers(0, len(levels), n)]
    cols = {"x1": (x1, None), "x2": (rng.standard_normal(n), None),
            "g": (g, "enum")}
    if not test:
        z = np.nan_to_num(x1) + (g == "b") - 0.5 * cols["x2"][0]
        cols["yb"] = (np.where(rng.random(n) < 1 / (1 + np.exp(-z)), "Y",
                               "N"), "enum")
        cols["yr"] = (2 * z + rng.normal(0, 0.1, n), None)
        cols["ym"] = (np.array(["r", "s", "t"])[
            np.clip((z + 1.2).astype(int), 0, 2)], "enum")
    return cols


@pytest.mark.parametrize("family,y", [("binomial", "yb"),
                                      ("gaussian", "yr"),
                                      ("multinomial", "ym")])
def test_glm_artifact_scores_within_c30(family, y, tmp_path):
    """The runner's GLM response equals in-process predict to 1e-6
    relative, not bit for bit (ROADMAP C30): BLAS's gemv sums a row's
    dot product in an order that depends on where the row falls in the
    row count's blocking, and the runner pads requests to its buckets.
    The model `load_model` rebuilds predicts bit for bit."""
    th.init(device="cpu")
    cols = _glm_cols(640, seed=31)
    fr = th.Frame()
    for k, (a, ct) in cols.items():
        if k.startswith("y") and k != y:
            continue
        fr.add(k, th.Column.from_numpy(a, ctype=ct))
    m = th.GLM(family=family).train(y=y, training_frame=fr)
    art = str(tmp_path / "glm")
    man = artifact.export_model(m, art, buckets=[64, 256])
    assert man["model_type"] == "glm"
    tcols = _glm_cols(150, seed=37, test=True)
    tf = th.Frame()
    for k, (a, ct) in tcols.items():
        tf.add(k, th.Column.from_numpy(a, ctype=ct))
    ref = m.predict(tf)
    out = _runner().load_artifact(art, "cpu").score(_raw_columns(tcols))
    for nm in ref.names:
        if nm == "predict" and ref.col(nm).domain:
            dom = ref.col(nm).domain
            assert list(out[nm]) == [dom[i] for i in
                                     ref.col(nm).data.tolist()]
        else:
            assert_close(out[nm], ref.col(nm).data.numpy(), 1e-6, 1.0, nm)
    loaded = artifact.load_model(art, model_id="glm_art_loaded")
    frames_bitwise(loaded.predict(tf), ref)
    loaded.delete()
    m.delete()


def test_glm_scope_refusals_match_the_reference():
    from h2o3_tpu import artifact as jartifact
    from h2o3_tpu.models.glm import GLMModel as JGLMModel
    from h2o3_tpu.models.kmeans import KMeansModel as JKMeansModel

    from h2o3_tpu_torch.models.glm import GLMModel
    from h2o3_tpu_torch.models.kmeans import KMeansModel

    cases = [({}, "identity", True), ({"interactions": ["a", "b"]},
                                      "identity", True),
             ({"offset_column": "o"}, "log", True), ({}, "ordinal", True),
             ({}, "logit", False)]
    for parms, link, trained in cases:
        reasons = []
        for cls in (GLMModel, JGLMModel):
            mm = cls(parms=dict(parms))
            mm.linkname = link
            if trained:
                mm.beta = np.zeros(3, np.float32)
                mm.dinfo = object()
            mod = artifact if cls is GLMModel else jartifact
            reasons.append(mod.supports_export(mm))
            mm.delete()
        assert reasons[0] == reasons[1], (parms, link, reasons)
    th.init(device="cpu")
    for cls, mod in ((KMeansModel, artifact), (JKMeansModel, jartifact)):
        mm = cls(parms={})
        assert "SharedTree" in mod.supports_export(mm)
        with pytest.raises(mod.ArtifactError, match="SharedTree"):
            mod.export_model(mm, "/nonexistent-unused")
        mm.delete()


def test_second_export_loads_programs_from_the_compile_cache(
        forests, tmp_path, monkeypatch):
    _jm, tm = forests["binomial"]
    monkeypatch.setenv("H2O_TPU_COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    compile_cache.reset_stats()
    m1 = artifact.export_model(tm, str(tmp_path / "a1"), buckets=[16, 32])
    s1 = compile_cache.stats()
    assert (s1["compiles"], s1["stores"], s1["disk_hits"]) == (2, 2, 0)
    m2 = artifact.export_model(tm, str(tmp_path / "a2"), buckets=[16, 32])
    s2 = compile_cache.stats()
    assert (s2["compiles"], s2["disk_hits"]) == (2, 2)
    assert [e["sha256"] for e in m1["programs"]] == \
        [e["sha256"] for e in m2["programs"]]
    monkeypatch.delenv("H2O_TPU_COMPILE_CACHE_DIR")
    assert not compile_cache.enabled()
