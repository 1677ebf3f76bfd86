"""The port's munge→score pipeline (h2o3_tpu_torch/pipeline.py) and its
artifacts (artifact/pipeline.py) on the CPU, mirroring the reference's
tests/test_pipeline.py:

- a frame fed by a still-pending lazy Rapids feature pipeline scores
  through the pipeline with zero engineered Columns made, bit for bit
  with the port's staged flush→adapt→score path, for GBM (binomial and
  multinomial) and GLM (binomial, multinomial, regression), NA rows
  included; the same JAX-trained model (carried across) scores through
  the JAX package's pipeline within ROADMAP C2's 1e-5;
- a frame capture cannot hold (an unseen level) takes the staged path,
  counted under ``fallbacks``;
- an error inside a captured program raises (no staged result hides it);
- a pipeline artifact scores raw rows in a fresh process (the runner as
  a file path) bit for bit for a forest and within C30's 1e-6 for a GLM,
  imports as a PipelineModel, and refuses rewrite-boundary features with
  the reference's reason; an assembly's wire steps export the same way.
The `gpu` tests run the pipeline's graphs on the card."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch import convert, pipeline, scoring
from h2o3_tpu_torch.rapids import fusion, planner

from torch_port_support import (assert_close, both_frames, carry_forest,
                                carry_glm, install_both)

ROOT = Path(__file__).resolve().parents[1]
RUNNER = ROOT / "h2o3_tpu_torch" / "artifact" / "runner.py"


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _frames_bitwise(a, b, n):
    assert list(a.names) == list(b.names)
    for nm in a.names:
        x, y = a.col(nm).to_numpy()[:n], b.col(nm).to_numpy()[:n]
        assert np.array_equal(_bits(x), _bits(y)), nm


def _train_cols(seed, n=704, classes=2):
    """The reference's `_train_frame` (tests/test_pipeline.py)."""
    rng = np.random.default_rng(seed)
    x1, x2 = rng.standard_normal(n), rng.standard_normal(n)
    g = np.array(["a", "b", "c"])[rng.integers(0, 3, n)]
    cols = {"x1": (x1, None), "x2": (x2, None), "g": (g, "enum")}
    if classes == 0:
        y = 1.3 * x1 - x2 + (g == "a") + 0.1 * rng.standard_normal(n)
        cols["y"] = (y, None)
    elif classes == 2:
        logit = 1.2 * x1 - x2 + (g == "a") * 0.5
        cols["y"] = (np.where(rng.random(n) < 1 / (1 + np.exp(-logit)),
                              "Y", "N"), "enum")
    else:
        score = np.stack([x1, -x2, 0.5 * x1 + x2 + (g == "b")], axis=-1)
        cols["y"] = (np.array(["c0", "c1", "c2"])[np.argmax(
            score + rng.gumbel(size=score.shape), axis=-1)], "enum")
    return cols


def _raw_cols(seed, m=257, levels=("a", "b", "c")):
    """Raw serving rows: NaNs in r1, every level of g present."""
    rng = np.random.default_rng(seed + 1000)
    r1 = rng.standard_normal(m)
    r1[::9] = np.nan
    g = np.array(levels)[rng.integers(0, len(levels), m)]
    g[:len(levels)] = levels
    return {"r1": (r1, None), "r2": (rng.standard_normal(m), None),
            "g": (g, "enum")}


def _engineer(exec_rapids, sess, p, rawkey, variant):
    """The reference's lazy engineered frame x1/x2/g over the raw
    columns; variant 1 holds a multiply feeding a subtract (a rewrite
    boundary, its own sub-program)."""
    if variant == 0:
        exec_rapids(f"(tmp= {p}_x1 (+ (cols {rawkey} [0]) 0.5))", sess)
        exec_rapids(f"(tmp= {p}_x2 (ifelse (> (cols {rawkey} [1]) 0) "
                    f"(cols {rawkey} [1]) (cols {rawkey} [0])))", sess)
    else:
        exec_rapids(f"(tmp= {p}_x1 (- (* (cols {rawkey} [0]) 2) "
                    f"(cols {rawkey} [1])))", sess)
        exec_rapids(f"(tmp= {p}_x2 (+ (cols {rawkey} [1]) 1))", sess)
    return exec_rapids(
        f'(tmp= {p}_pf (colnames= (cbind {p}_x1 {p}_x2 '
        f'(cols {rawkey} [2])) [0 1 2] ["x1" "x2" "g"]))', sess)


def _jax_pipeline(jm, seed, variant, predict):
    """The JAX package's pipeline predictions over the same raw rows."""
    from h2o3_tpu import pipeline as jpipeline
    from h2o3_tpu.rapids import Session as JSession
    from h2o3_tpu.rapids import exec_rapids as jexec
    from h2o3_tpu.rapids import fusion as jfusion
    from h2o3_tpu.rapids import planner as jplanner

    key = f"plraw_j{seed}"
    install_both(key, _raw_cols(seed))
    with jplanner.force(True), jfusion.force(True), jpipeline.force(True):
        s = JSession(f"plj{seed}")
        pf = _engineer(jexec, s, f"pj{seed}", key, variant)
        c0 = jpipeline.counters()["captures"]
        out = predict(pf)
        assert jpipeline.counters()["captures"] == c0 + 1
        s.end()
    return out


def _port_pipeline(tm, seed, variant, predict, device=None):
    """(fused, staged) port predictions over the raw rows (installed in
    both packages, or on `device` in the port only), with the counters of
    the fused run checked."""
    key = f"plraw_t{seed}"
    if device is None:
        install_both(key, _raw_cols(seed))
    else:
        fr = th.Frame(key=key)
        for nm, (a, ct) in _raw_cols(seed).items():
            fr.add(nm, th.Column.from_numpy(a, ctype=ct, device=device))
        fr.install()
    with planner.force(True), fusion.force(True), pipeline.force(True):
        s = th.Session(f"plt{seed}")
        pf = _engineer(th.exec_rapids, s, f"pt{seed}", key, variant)
        before = pipeline.counters()
        fused = predict(pf)
        after = pipeline.counters()
        assert after["captures"] == before["captures"] + 1
        assert after["fused_dispatches"] > before["fused_dispatches"]
        assert after["spliced_nodes"] >= before["spliced_nodes"] + 2
        assert after["materialized_columns"] == \
            before["materialized_columns"], \
            "an engineered Column was made on the pipeline path"
        assert pf.col("x1")._data is None, "capture observed the DAG"
        with pipeline.force(False):
            staged = predict(pf)
        s.end()
    return fused, staged


@pytest.mark.parametrize("seed,classes", [(0, 2), (1, 2), (6, 3)])
def test_gbm_pipeline_bitwise_vs_staged_and_near_reference(cl, seed,
                                                           classes):
    from h2o3_tpu import scoring as jscoring
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    jf, _tf = both_frames(_train_cols(seed, classes=classes))
    jm = JGBM(ntrees=3, max_depth=3, seed=seed + 1).train(
        y="y", training_frame=jf)
    tm = convert.gbm_model_from_numpy(carry_forest(jm))
    ssn = scoring.session_for(tm)
    fused, staged = _port_pipeline(tm, seed, seed % 2, ssn.predict)
    _frames_bitwise(fused, staged, fused.nrows)
    ref = _jax_pipeline(jm, seed, seed % 2,
                        jscoring.session_for(jm).predict)
    for nm in fused.names[1:]:
        assert_close(np.asarray(ref.col(nm).data)[:fused.nrows],
                     fused.col(nm).to_numpy(), 1e-5, 1.0, nm)


@pytest.mark.parametrize("seed,classes", [(10, 2), (13, 3), (15, 0)])
def test_glm_pipeline_bitwise_vs_staged_and_near_reference(cl, seed,
                                                           classes):
    from h2o3_tpu.models.glm import GLM as JGLM

    fam = {2: "binomial", 3: "multinomial", 0: "gaussian"}[classes]
    jf, _tf = both_frames(_train_cols(seed, classes=classes))
    jm = JGLM(family=fam, lambda_=0.0).train(y="y", training_frame=jf)
    tm = convert.glm_model_from_numpy(carry_glm(jm))
    fused, staged = _port_pipeline(tm, seed, seed % 2, tm.predict)
    _frames_bitwise(fused, staged, fused.nrows)
    ref = _jax_pipeline(jm, seed, seed % 2, jm.predict)
    for nm in fused.names[1:] if classes else fused.names:
        assert_close(np.asarray(ref.col(nm).data)[:fused.nrows],
                     fused.col(nm).to_numpy(), 1e-5, 1.0, nm)


@pytest.fixture(scope="module")
def gbm(cl):
    _jf, tf = both_frames(_train_cols(21))
    return th.GBM(ntrees=3, max_depth=3, seed=3).train(
        y="y", training_frame=tf)


def test_unseen_level_falls_back_to_staged_and_is_counted(gbm):
    """A raw enum whose domain differs from training (an unseen level)
    cannot splice: the predict takes the staged path, counted as a
    fallback with its pending columns made, and stays correct."""
    install_both("plraw_unseen", _raw_cols(21, m=120,
                                       levels=("a", "b", "c", "zz")))
    ssn = scoring.session_for(gbm)
    with planner.force(True), fusion.force(True), pipeline.force(True):
        s = th.Session("pl_unseen")
        pf = _engineer(th.exec_rapids, s, "pu", "plraw_unseen", 0)
        before = pipeline.counters()
        got = ssn.predict(pf)
        after = pipeline.counters()
        assert after["captures"] == before["captures"]
        assert after["fallbacks"] == before["fallbacks"] + 1
        assert after["materialized_columns"] == \
            before["materialized_columns"] + 2
        with pipeline.force(False):
            ref = ssn.predict(pf)
        _frames_bitwise(got, ref, 120)
        s.end()


def test_program_failure_raises_instead_of_staging(gbm, monkeypatch):
    install_both("plraw_fail", _raw_cols(22))
    ssn = scoring.session_for(gbm)

    def boom(*a, **k):
        raise RuntimeError("forced pipeline failure")

    with planner.force(True), fusion.force(True), pipeline.force(True):
        s = th.Session("pl_fail")
        pf = _engineer(th.exec_rapids, s, "pfl", "plraw_fail", 0)
        monkeypatch.setattr(ssn, "_dispatch", boom)
        monkeypatch.setattr(fusion.GraphProgram, "run", boom)
        f0 = pipeline.counters()["fallbacks"]
        with pytest.raises(RuntimeError, match="forced pipeline"):
            ssn.predict(pf)
        assert pipeline.counters()["fallbacks"] == f0
        s.end()


def _raw_csv(path, cols):
    r1, r2, g = (cols[k][0] for k in ("r1", "r2", "g"))
    with open(path, "w") as f:
        f.write("r1,r2,g\n")
        for a, b, c in zip(r1, r2, g):
            a = "" if np.isnan(a) else repr(float(np.float32(a)))
            f.write(f"{a},{float(np.float32(b))!r},{c}\n")


def _run_runner(art, csv_path, out_npz):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(RUNNER), "--artifact", str(art), "--input",
         str(csv_path), "--output", str(out_npz) + ".csv", "--raw-npz",
         str(out_npz), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(out_npz.parent))
    assert proc.returncode == 0, proc.stderr[-2000:]
    with np.load(out_npz, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_pipeline_artifact_scores_raw_rows_in_fresh_process(gbm, tmp_path):
    """export_pipeline for a GBM and a GLM over the same pending feature
    DAG; the runner, started as a file path in a fresh process, scores
    the raw CSV like in-process serving (bit for bit for the forest,
    within C30 for the GLM), and load_model imports the artifact as a
    PipelineModel scoring raw frames the same way."""
    from h2o3_tpu_torch.artifact import export_pipeline, load_model
    from h2o3_tpu_torch.artifact.pipeline import PipelineModel

    _jf, tf = both_frames(_train_cols(41))
    glm = th.GLM(family="binomial", lambda_=0.0).train(
        y="y", training_frame=tf)
    cols = _raw_cols(41)
    _raw_csv(tmp_path / "raw.csv", cols)
    for tag, model in (("gbm", gbm), ("glm", glm)):
        _jraw, raw = install_both(f"plraw_art_{tag}", cols)
        with planner.force(True), fusion.force(True), pipeline.force(True):
            s = th.Session(f"pl_art_{tag}")
            pf = _engineer(th.exec_rapids, s, f"pa{tag}",
                           f"plraw_art_{tag}", 0)
            m = export_pipeline(model, pf, str(tmp_path / tag),
                                buckets=[512])
            ref = (scoring.session_for(model).predict(pf) if tag == "gbm"
                   else model.predict(pf))
            s.end()
        assert m["model_type"] == "pipeline"
        assert sorted(m["names"]) == ["g", "r1", "r2"]
        got = _run_runner(tmp_path / tag, tmp_path / "raw.csv",
                          tmp_path / f"out_{tag}.npz")
        for k, lvl in enumerate(("N", "Y")):
            want = ref.col(lvl).to_numpy()
            if tag == "gbm":
                assert np.array_equal(_bits(got["probs"][:, k]),
                                      _bits(want)), lvl
            else:
                assert_close(want, got["probs"][:, k], 1e-6, 1.0, lvl)
        pm = load_model(str(tmp_path / tag), model_id=f"pl_imported_{tag}")
        assert isinstance(pm, PipelineModel)
        imported = pm.predict(raw)
        if tag == "gbm":
            _frames_bitwise(imported, ref, raw.nrows)
        else:
            assert_close(ref.col("Y").to_numpy(),
                         imported.col("Y").to_numpy(), 1e-6, 1.0, "Y")


def test_export_refuses_rewrite_boundary_features(gbm, tmp_path):
    from h2o3_tpu_torch.artifact import ArtifactError, export_pipeline

    install_both("plraw_refuse", _raw_cols(51))
    with planner.force(True), fusion.force(True), pipeline.force(True):
        s = th.Session("pl_refuse")
        pf = _engineer(th.exec_rapids, s, "pr", "plraw_refuse", 1)
        with pytest.raises(ArtifactError, match="rewrite"):
            export_pipeline(gbm, pf, str(tmp_path / "refuse"),
                            buckets=[512])
        s.end()


def test_assembly_export_pipeline_scores_raw_rows(gbm, tmp_path):
    """H2OAssembly.export_pipeline replays the wire steps lazily and
    exports them fused with the model; the runner's raw-row scores equal
    in-process scoring of the eagerly transformed frame."""
    wire = ["x1__H2OColOp__(+ (cols_py dummy 'r1') 0.5)__false__x1",
            "x2__H2OColOp__(ifelse (> (cols_py dummy 'r2') 0) "
            "(cols_py dummy 'r2') (cols_py dummy 'r1'))__false__x2"]
    asm = th.H2OAssembly.from_steps(wire)
    cols = _raw_cols(61)
    _jraw, raw = install_both("plraw_asm", cols)
    m = asm.export_pipeline(gbm, raw, str(tmp_path / "asm"), buckets=[512])
    assert m["names"] == ["r1", "r2", "g"]
    with planner.force(False):
        ref = gbm.predict(asm.fit(raw))
    _raw_csv(tmp_path / "raw.csv", cols)
    got = _run_runner(tmp_path / "asm", tmp_path / "raw.csv",
                      tmp_path / "out_asm.npz")
    assert np.array_equal(_bits(got["probs"][:, 1]),
                          _bits(ref.col("Y").to_numpy()))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_pipeline_graphs_bitwise_with_staged_on_card():
    th.init()
    try:
        for seed, algo in ((0, "gbm"), (1, "gbm"), (10, "glm"), (13, "glm")):
            tf = th.Frame()
            classes = 3 if seed == 13 else 2
            for nm, (a, ct) in _train_cols(seed, classes=classes).items():
                tf.add(nm, th.Column.from_numpy(a, ctype=ct))
            if algo == "gbm":
                m = th.GBM(ntrees=3, max_depth=3, seed=1).train(
                    y="y", training_frame=tf)
                predict = scoring.session_for(m).predict
            else:
                fam = "multinomial" if classes == 3 else "binomial"
                m = th.GLM(family=fam, lambda_=0.0).train(
                    y="y", training_frame=tf)
                predict = m.predict
            fused, staged = _port_pipeline(m, 100 + seed, seed % 2, predict,
                                           "cuda")
            _frames_bitwise(fused, staged, fused.nrows)
            again, _ = _port_pipeline(m, 100 + seed, seed % 2, predict,
                                      "cuda")
            _frames_bitwise(again, staged, fused.nrows)   # a replay
    finally:
        th.init(device="cpu")
