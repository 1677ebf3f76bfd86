"""Smoke test of the PyTorch/CUDA port (h2o3_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA kernels from h2o3_tpu_torch/csrc, holds every
kernel against its plain PyTorch version bit for bit (at the level
shapes of every path below: the flagship's, depth-20 DRF's up to a
4096-slot frontier, XGBoost's 257-bin int16 levels and IsolationForest's
ragged 256-slot levels with 256 live rows), and drives these paths
through the port's public entry points:
- the flagship GBM (1M rows, 8 numeric + 2 categorical features,
  bernoulli, 20 trees, depth 5);
- the reference's deep DRF stage (200k rows, 6 numeric features,
  binomial, 5 trees, depth 20);
- a multinomial GBM (the flagship's features, a 4-class response,
  sampling, a validation frame and early stopping);
- XGBoost on the flagship frame at the reference's XGBoost defaults (eta
  0.3, depth 6, 256 bins, lambda 1), booster gbtree and booster dart;
- IsolationForest (50 trees, depth 8, sample_size 256, 64 uniform bins)
  and Extended Isolation Forest (100 trees, full extension) on the
  flagship's features with 1% of the rows moved 6 sigma out;
- DeepLearning at the reference's defaults (hidden [200, 200],
  Rectifier, ADADELTA, mini_batch_size 32) for one epoch of the
  flagship frame, its step loop a CUDA graph held bit for bit to the
  eager loop, and an autoencoder on the outlier frame below;
- the model framework on the flagship: 5-fold cross-validation,
  Platt and isotonic calibration, checkpoint continuation (GBM and
  DeepLearning), save/load, leaf assignment, gains/lift and KS;
- the GLM family: a binomial GLM at the reference bench's width (1M
  rows, 32 features, IRLS); lambda search (ADMM), p-values, multinomial
  and ordinal (L-BFGS) GLMs and XGBoost gblinear on the flagship's
  frames; GAM (one column per basis type) and RuleFit at its defaults
  (50 DRF trees of depth 3, so the kernel runs, then a lasso lambda
  search) on 200k flagship rows;
- Rapids and the frame ops: the reference benchmark's three eager
  Rapids statements over its 2M-row frame (held bit for bit to a numpy
  float32 evaluation), a sort of that frame, the dryrun's joins at 1M
  left rows, a group-by of the flagship frame and the verify recipe's
  H2OFrame surface on an imported CSV; this path launches no kernel;
- the remaining builders (phase 3p): a StackedEnsemble over the 5-fold
  CV GBM and a GLM on the same folds; KMeans (k=10, Furthest) on the
  flagship and estimate_k on 200k rows of seeded blobs; PCA (GramSVD,
  Randomized), SVD and NaiveBayes on the flagship; Word2Vec on a seeded
  1M-token Zipf corpus with a planted synonym pair; TargetEncoder (5-fold
  KFold on both enums); GLRM, CoxPH (seeded survival rows, Efron ties),
  Aggregator and IsotonicRegression on 200k rows, PSVM on 20k; GLM
  segment models per level of one enum and GBM segment models (which
  run the kernel) per level of the other;
- search (phase 3q): the reference dryrun's H2OAutoML(max_models=2,
  seed=1) on the 1M-row flagship (a lambda-search GLM and a 50-tree GBM,
  each 5-fold cross-validated, then two stacked ensembles), a Cartesian
  GBM grid, a RandomDiscrete GLM grid walked sequentially and with
  parallelism 3, and a GBM train cancelled from another thread;
- export and explanation (phase 3r) over the flagship GBM, the
  DeepLearning model and a binomial GLM: MOJO round trips through
  H2OGenericEstimator (bitwise), Java-format MOJOs scored by the torch
  walk, POJO sources, TreeSHAP contributions on 100k rows (the host
  library's walk), partial dependence of all 10 columns on 1M rows and
  an ICE curve, feature interactions and the varimp and correlation
  matrices; this path launches no kernel;
- serving (phase 3s) over the flagship GBM and phase 3r's GLM: the
  scoring session's bucket ladder on CUDA graphs at run_scoring's
  request sizes and one 1M-row request, 4 rounds of 16 concurrent
  128-row requests through the micro-batcher, admission with a static
  cap of 1 and a queue of 2, the memory planner at a 2 MB budget, two
  injected OOMs and a real torch.cuda.OutOfMemoryError under a capped
  allocator (each recovered bit for bit), the cleaner's sweep, fault-in
  and spill, and standalone artifacts: export, load in process and the
  runner in a fresh process on the card; this path launches no kernel;
- statement fusion, lazy sessions and the munge→score pipeline (phase
  3t) at the reference bench's sizes: run_rapids' three statements on
  its 2M-row frame fused against eager, its chained session on 4M rows
  lazy against eager (CSE hits and dead temps counted as the JAX package
  counts them), and run_pipeline's shape (a 10-tree depth-5 GBM on 20k
  rows, which runs the kernel, scoring 200k raw rows through a lazy
  feature chain fused against staged, one 1M-row request, and a pipeline
  artifact scored from raw rows by the runner in a fresh process);
- crash-survivable training and search (phase 3v, with
  H2O_TPU_JOB_CKPT_ITERS set): the flagship GBM saving progress every 5
  trees, trained in a child process killed with SIGKILL after its save
  at tree 10 and resumed in this one from the progress file (bitwise
  with the uninterrupted forest, the resumed levels through the
  kernel); the deep DRF, the bench GLM (1M x 32), KMeans (k=10) and
  DeepLearning (200k rows, 3 epochs) interrupted and resumed; phase
  3q's GBM grid capped at 2 members with a recovery_dir, loaded back
  and finished; a REST train with durable progress and a REST grid
  with a recovery_dir; and s3:// import of phase 3l's flagship CSV from
  a loopback endpoint that checks the SigV4 signature;
- bf16 numeric storage (phase 3w, `numeric_dtype="bfloat16"`): the
  flagship frame stored at half the numeric bytes, the flagship GBM
  trained on it through the kernel, scored eagerly and by a scoring
  session on CUDA graphs of its own (bitwise), the bench GLM, phase 3l's
  run_parse file imported, a fused Rapids statement on bf16 leaves
  (bitwise with eager), and a 100k-row bf16 GBM card against CPU.
Before the build, phase 0b runs the port's invariant analyzer
(`python -m h2o3_tpu_torch.analysis --json`) and requires exit 0.
It checks the card's models and imports against the same port on the
CPU and times
the kernel at the level shapes of each configuration beside its memory
bound and a PyTorch library call, with the kernel's time split by pass.
Any failed check exits non-zero. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

FLAGSHIP = dict(n_rows=1_000_000, n_num=8, n_cat=2, ntrees=20, max_depth=5)
# h2o3_tpu/bench.py run_drf_deep, uncut
DRF_DEEP = dict(n_rows=200_000, n_num=6, ntrees=5, max_depth=20, seed=1)
# the flagship's features with a 4-class response
MULTINOMIAL = dict(n_rows=1_000_000, n_valid=200_000, classes=4, ntrees=20,
                   max_depth=5, sample_rate=0.8, col_sample_rate=0.8,
                   stopping_rounds=3, seed=1)
# the reference's XGBoost defaults (h2o3_tpu/models/xgboost.py:58-80)
# on the flagship frame; dart drops each earlier tree with chance 0.1
XGB = dict(ntrees=20, max_depth=6, seed=1, rate_drop=0.1)
# the reference's IsolationForest / Extended IF defaults on the
# flagship's 10 features, 1% of the rows moved 6 sigma out
ISOFOR = dict(n_rows=1_000_000, ntrees=50, max_depth=8, sample_size=256,
              nbins=64, seed=1, outlier_frac=0.01, shift=6.0)
EIF = dict(ntrees=100, sample_size=256, seed=1)
PRED_ATOL = 1e-5            # card vs CPU predictions of the same forest
# h2o3_tpu/bench.py run_glm: 1M rows, 32 standard-normal features; y is
# drawn Bernoulli(sigmoid(X b)) rather than thresholded, so the fit has a
# finite optimum, and b is run_glm's draw over sqrt(p): at run_glm's
# scale some |x.b| reach 23, where float32's logistic saturates and the
# reference's IRLS, which the port follows, diverges (ROADMAP C11)
GLM_BENCH = dict(n_rows=1_000_000, p=32, seed=0)
# |coef - b_true| <= this many standard errors for every coefficient
COEF_SE_BOUND = 5.0
GAM_RULEFIT_ROWS = 200_000
# h2o3_tpu/bench.py run_parse (:695): 400k rows, 6 numeric columns rounded
# to 6 decimals, 2 enum columns, seed 7; a 10k-row append with a new level
RUN_PARSE = dict(n_rows=400_000, n_num=6, n_cat=2, seed=7,
                 append_rows=10_000)
# card vs CPU (phase 4): cuBLAS and the CPU's BLAS sum in different
# orders, so GLM coefficients and predictions agree to rounding of
# well-conditioned float32 solves; GAM's spline designs and RuleFit's
# rule designs are ill-conditioned or rank-deficient (ROADMAP C10), so
# only their fitted values are held, and more loosely
GLM_COEF_TOL = dict(rtol=1e-4, atol=1e-4)
# DeepLearning at the reference's defaults (h2o3_tpu/models/deeplearning.py
# :175-201: hidden [200, 200], Rectifier, ADADELTA, mini_batch_size 32),
# one epoch; its warm-up and graph-vs-eager runs take 20k rows
DL = dict(seed=1, batch=32, small_rows=20_000)
# card vs CPU (phase 4): 2 epochs of 256 steps with dropout; cuBLAS and
# the CPU sum each step's matmuls in different orders, and 512 ADADELTA
# steps carry the rounding on, so weights and predictions agree to this
DL_CPU = dict(n_rows=8192, hidden=[32, 32], batch=32, epochs=2, seed=1,
              input_dropout=0.1, hidden_dropout=[0.2, 0.2])
DL_CARD_CPU_ATOL = 1e-5
# phase 3n: 5-fold CV of the flagship GBM, calibration on 200k rows
FRAMEWORK = dict(nfolds=5, calibration_rows=200_000)
GLM_PRED_ATOL = 1e-4
C10_PRED_ATOL = 5e-3
# phase 3o: h2o3_tpu/bench.py run_rapids' frame and statements (:264-297,
# 2M rows, seed 4, one warm pass then 5 timed ones); the dryrun's joins
# (__graft_entry__.py:176-184) at 1M left rows; phase 4 at 100k rows
RAPIDS = dict(n_rows=2_000_000, reps=5, seed=4, join_rows=1_000_000,
              join_right=200_000, cpu_rows=100_000)
# phase 3t: run_rapids' chained session (h2o3_tpu/bench.py:336-402, 4M
# rows, 3 warm-free interleaved A/B passes beyond run_rapids' 5) and
# run_pipeline (:803-890: 20k training rows, 10 trees of depth 5, 200k raw
# rows, 5 reps; one 1M-row request); the JAX package counts one CSE hit,
# one dead temp and two inlined intermediates per chained pass (its
# planner on the CPU over the same statements); phase 4 at 100k rows
FUSION = dict(chain_rows=4_000_000, chain_reps=8, pipe_train=20_000,
              pipe_rows=200_000, pipe_reps=5, pipe_ntrees=10,
              pipe_depth=5, pipe_1m=1_000_000, artifact_rows=4_096,
              ref_per_pass={"cse_hits": 1, "dead_temps_eliminated": 1,
                            "inlined_intermediates": 2},
              cvc_rows=100_000)
# phase 3p: k-means and PCA/SVD/GLRM widths; KMeans' estimate_k, GLRM,
# CoxPH, Aggregator and IsotonicRegression on 200k rows; Word2Vec on a
# seeded Zipf
# corpus of 1M tokens over a 10k vocabulary, vec_size 100; PSVM on 20k
# rows (its ICF rank is sqrt(n) + 1); phase 4 on 100k rows (100k tokens)
BUILDERS = dict(k=10, pca_k=5, aux_rows=200_000, w2v_tokens=1_000_000,
                vocab=10_000, vec_size=100, psvm_rows=20_000,
                cvc_rows=100_000, cvc_tokens=100_000)
# phase 3q: the dryrun's AutoML (__graft_entry__.py:188-191) on the
# full-width flagship; a Cartesian GBM grid; a RandomDiscrete GLM grid run
# with parallelism 1 and 3 (the same combos, the same AUCs to GRID_AUC_ATOL:
# the same fits, in another order); a GBM train cancelled after its second
# tree; phase 4 runs the AutoML with 3 folds on 20k rows
SEARCH = dict(aml_models=2, seed=1, grid_hyper={"max_depth": [3, 5],
                                                "learn_rate": [0.05, 0.2]},
              grid_ntrees=20, glm_hyper={"alpha": [0.0, 0.25, 0.5, 0.75, 1.0],
                                         "lambda_": [0.0, 1e-4, 1e-3, 1e-2]},
              glm_models=5, glm_seed=42, cancel_ntrees=50, cvc_rows=20_000,
              cvc_nfolds=3)
GRID_AUC_ATOL = 1e-6
# phase 3r: TreeSHAP on the flagship's first 100k rows (a host walk,
# linear in rows: all 1M would take tens of seconds), partial dependence
# of every flagship column over 20 grid values on all 1M rows; phase 4 on
# 100k rows. Bars: the reference's Java round trip (tests/
# test_java_mojo.py:160) and TreeSHAP's local accuracy (tests/
# test_explain.py:76)
EXPLAIN = dict(contrib_rows=100_000, nbins=20, cvc_rows=100_000)
JAVA_ATOL = 2e-5
CONTRIB_ATOL = 2e-3
# card vs CPU PDP tables: the same margins, but the card's and the CPU's
# float32 exp round the sigmoid apart in the last bits (7.45e-9 on the
# means of 100k rows on an H100 80GB HBM3; ROADMAP C29); C2's
# prediction bar
PDP_CVC_ATOL = 1e-6
# the members AutoML builds with max_models=2 and GLM and GBM among its
# algos: the reserve keeps one slot for exploitation, GLM has none, so
# the leftover pass builds the first GBM default, then both ensembles
AML_MEMBERS = ["def_glm", "def_gbm_1", "StackedEnsemble_BestOfFamily",
               "StackedEnsemble_AllModels"]
# CoxPH: 6 covariates; card vs CPU coefficients to 5e-3: the float32
# partial likelihood is flat to its last bit over sqrt(2 ulp(ll) / H) of
# each coefficient, ~1.3e-3 at 100k rows, and Newton may stop anywhere
# in it on either device (ROADMAP C23)
COXPH = dict(p=6, cvc_coef_atol=5e-3)
# Word2Vec card vs CPU: the card's index_add_ adds a step's updates of
# one row in the order its atomics land, the CPU in turn, so the vectors
# drift apart by rounding over the steps (1.9e-5 over one epoch of the
# 100k-token corpus, ROADMAP C24)
W2V_CVC_ATOL = 1e-4
# Aggregator card vs CPU at the flagship's full width: a target of 500
# exemplars (the CPU's passes stay short); the card's batch distances are
# cuBLAS's, so a row within rounding of the radius or of a tie may go
# another way on the card, and the passes part there (ROADMAP C25)
AGG_CVC_TARGET = 500
# GLRM's first step is init_step_size / ||Y||^2, ||Y||^2 the Gram's trace
# (n * p after STANDARDIZE: 6.25e-7 at 200k x 8), below the default
# min_step_size 1e-4, where the reference's loop stops before its first
# step; phase 3p lowers min_step_size so the loop runs
GLRM_MIN_STEP = 1e-9
# phase 3s: h2o3_tpu/bench.py run_scoring's request sizes (:180) and
# coalescing rounds (:212-246), run_oom_degrade's 2 MB budget (:899-990)
# and run_artifact's 256-row requests for 3 s (:593); the real OOM caps
# the allocator between the working sets of two buckets; phase 4 on 100k
# rows
SERVING = dict(sizes=(777, 3_000, 12_000, 16_384), passes=3, conc=16,
               rounds=4, small_rows=128, mem_budget_mb="2",
               oom_buckets=(262_144, 1_048_576),
               artifact_buckets=[256, 16_384], batch_rows=256,
               sustain_s=3.0, cvc_rows=100_000)
# the GLM artifact's runner vs in-process predict: BLAS sums a row's dot
# product in an order set by the row count's blocking, and the runner
# pads requests to its buckets (ROADMAP C30)
GLM_ARTIFACT_ATOL = 1e-6
# card vs CPU: libm's float32 functions differ in the last ulps between
# the card and the CPU, the gamma family's reflection subtracts terms of
# order 1, and cumulative sums scan in parallel on the card (ROADMAP C16)
UNARY_CVC = dict(rtol=1e-6, scale=0.1)
GAMMA_CVC = dict(rtol=4e-6, scale=1.0)
CUMSUM_CVC = 1e-5


class SmokeFailure(RuntimeError):
    pass


# phase 3w: bf16 storage; the card-vs-CPU GBM on 100k flagship rows
BF16 = dict(cvc_rows=100_000, cvc_trees=5, pred_atol=1e-6,
            glm_p=32)

# numbers one phase reads from another (phase 3's in-process
# gbm_train_s beside phase 3u's REST train)
RUN = {}


START = time.perf_counter()


def banner(msg: str) -> None:
    """A phase's heading, with the seconds since the script started."""
    print(f"== {msg} (at {time.perf_counter() - START:.1f} s)", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def metric(name: str, value, note: str = "") -> None:
    """One end-to-end metric of this PR's paths, with the card's name and
    power limit beside it."""
    print(f"{name} {value!r} [{nvidia_smi()}]{' ' + note if note else ''}")


def memory_rate(name: str) -> float:
    """Peak device-memory bytes/s of the card, from its name (NVIDIA's
    data sheets)."""
    n = name.upper()
    if "H200" in n:
        return 4.8e12
    if "H100" in n and "PCIE" in n:
        return 2.0e12
    if "H100" in n and "NVL" in n:
        return 3.9e12
    if "H100" in n:
        return 3.35e12          # H100 SXM, 80 GB HBM3
    raise SmokeFailure(f"no memory rate on record for {name!r}")


F32_PEAK = 67e12            # f32 FLOP/s outside the tensor cores (H100 SXM)


# ---------------------------------------------------------------------------
# data: the histogram fixture of the reference's kernel tests and the
# flagship frame of the reference's benchmark (same generators, seeded)
# ---------------------------------------------------------------------------

def hist_case(seed, n, F, maxB, S, *, dead_frac=0.15, zero_w_frac=0.1,
              ragged_bins=False):
    """Rows with an overweighted NA bin, dead rows (node -1), zero-weight
    live rows and optionally ragged per-feature bin counts."""
    rng = np.random.default_rng(seed)
    if ragged_bins:
        nbins = rng.integers(2, maxB + 1, F).astype(np.int64)
    else:
        nbins = np.full(F, maxB, np.int64)
    offsets = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int32)
    TB = int(nbins.sum())
    binned = np.stack([rng.integers(0, nbins[f], n) for f in range(F)],
                      axis=1).astype(np.int32)
    na_rows = rng.random(n) < 0.2
    binned[na_rows] = (nbins - 1)[None, :]
    node = rng.integers(0, S, n).astype(np.int32)
    node[rng.random(n) < dead_frac] = -1
    w = rng.random(n).astype(np.float32) + 0.25
    w[rng.random(n) < zero_w_frac] = 0.0
    y = rng.standard_normal(n).astype(np.float32)
    return binned, node, w, y, offsets, TB


def flagship_arrays(n_rows, n_num=8, n_cat=2, seed=0):
    """{name: (values, ctype)} of the reference's run_flagship frame."""
    rng = np.random.default_rng(seed)
    cols = {}
    logit = np.zeros(n_rows)
    for i in range(n_num):
        x = rng.standard_normal(n_rows)
        logit += x * rng.uniform(-1, 1)
        cols[f"n{i}"] = (x, None)
    doms = [np.array(["a", "b", "c", "d"]), np.array(["x", "y", "z"])]
    for i in range(n_cat):
        codes = rng.integers(0, len(doms[i % 2]), n_rows)
        logit += (codes - 1) * 0.3
        cols[f"c{i}"] = (doms[i % 2][codes], "enum")
    y = np.where(rng.random(n_rows) < 1 / (1 + np.exp(-logit)), "Y", "N")
    cols["y"] = (y, "enum")
    return cols


def flagship_frame(h2o, device, n_rows, n_num=8, n_cat=2, seed=0):
    fr = h2o.Frame()
    for name, (arr, ctype) in flagship_arrays(n_rows, n_num, n_cat,
                                              seed).items():
        fr.add(name, h2o.Column.from_numpy(arr, ctype=ctype, device=device))
    return fr


def drf_deep_frame(h2o, device, n_rows, seed=1, n_num=6):
    """The reference's run_drf_deep frame: n_num standard-normal features
    and a binomial response of a random linear logit."""
    rng = np.random.default_rng(seed)
    fr = h2o.Frame()
    logit = np.zeros(n_rows)
    for i in range(n_num):
        x = rng.standard_normal(n_rows)
        logit += x * rng.uniform(-1, 1)
        fr.add(f"n{i}", h2o.Column.from_numpy(x, device=device))
    y = np.where(rng.random(n_rows) < 1 / (1 + np.exp(-logit)), "Y", "N")
    fr.add("y", h2o.Column.from_numpy(y, ctype="enum", device=device))
    return fr


def multinomial_frames(h2o, device, n_train, n_valid, classes=4, seed=0):
    """The flagship's features over n_train + n_valid rows with a
    `classes`-level response: the flagship's logit plus logistic noise,
    cut at its quantiles. The first n_train rows train, the rest
    validate (None when n_valid is 0)."""
    n = n_train + n_valid
    rng = np.random.default_rng(seed)
    X, logit = {}, np.zeros(n)
    for i in range(FLAGSHIP["n_num"]):
        x = rng.standard_normal(n)
        logit += x * rng.uniform(-1, 1)
        X[f"n{i}"] = (x, None)
    doms = [np.array(["a", "b", "c", "d"]), np.array(["x", "y", "z"])]
    for i in range(FLAGSHIP["n_cat"]):
        codes = rng.integers(0, len(doms[i % 2]), n)
        logit += (codes - 1) * 0.3
        X[f"c{i}"] = (codes, doms[i % 2])
    u = logit + rng.logistic(size=n)
    cuts = np.quantile(u, np.arange(1, classes) / classes)
    X["y"] = (np.searchsorted(cuts, u),
              np.array([f"k{k}" for k in range(classes)]))

    def frame(rows):
        fr = h2o.Frame()
        for name, (v, dom) in X.items():
            if dom is None:
                col = h2o.Column.from_numpy(v[rows], device=device)
            else:
                col = h2o.Column.from_numpy(v[rows], ctype="enum",
                                            domain=list(dom), device=device)
            fr.add(name, col)
        return fr

    return (frame(slice(0, n_train)),
            frame(slice(n_train, n)) if n_valid else None)


def outlier_frame(h2o, device, n_rows, frac, shift, seed=0):
    """The flagship's 10 features (the same generator, no response) with
    a `frac` share of the rows moved `shift` standard deviations out on
    every numeric feature, each in a random direction. Returns the frame
    and the (n_rows,) bool mask of the moved rows."""
    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(FLAGSHIP["n_num"]):
        cols.append(rng.standard_normal(n_rows))
        rng.uniform(-1, 1)                       # the flagship's weight
    doms = [np.array(["a", "b", "c", "d"]), np.array(["x", "y", "z"])]
    cats = [doms[i % 2][rng.integers(0, len(doms[i % 2]), n_rows)]
            for i in range(FLAGSHIP["n_cat"])]
    moved = rng.random(n_rows) < frac
    fr = h2o.Frame()
    for i, x in enumerate(cols):
        sign = np.where(rng.random(n_rows) < 0.5, -1.0, 1.0)
        fr.add(f"n{i}", h2o.Column.from_numpy(
            np.where(moved, x + shift * sign, x), device=device))
    for i, c in enumerate(cats):
        fr.add(f"c{i}", h2o.Column.from_numpy(c, ctype="enum",
                                              device=device))
    return fr, moved


def glm_bench_frame(h2o, device, n_rows, p, seed=0):
    """run_glm's data (h2o3_tpu/bench.py:775-777): X standard normal,
    b_true standard normal over sqrt(p), then y ~ Bernoulli(sigmoid(X
    b_true)). Returns the frame and b_true."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_rows, p)).astype(np.float32)
    b_true = (rng.standard_normal(p) / np.sqrt(p)).astype(np.float32)
    eta = X.astype(np.float64) @ b_true.astype(np.float64)
    y = np.where(rng.random(n_rows) < 1 / (1 + np.exp(-eta)), "Y", "N")
    fr = h2o.Frame()
    for j in range(p):
        fr.add(f"x{j}", h2o.Column.from_numpy(X[:, j], device=device))
    fr.add("y", h2o.Column.from_numpy(y, ctype="enum", device=device))
    return fr, b_true


def regression_frame(h2o, device, n_rows, kind, seed=2):
    """The flagship's 10 features with a numeric response from a linear
    predictor of them: "real" (gaussian noise), "count" (Poisson) or
    "tweedie" (zero with chance 0.3, else gamma)."""
    rng = np.random.default_rng(seed)
    fr, eta = h2o.Frame(), np.zeros(n_rows)
    for i in range(FLAGSHIP["n_num"]):
        x = rng.standard_normal(n_rows)
        eta += x * rng.uniform(-0.3, 0.3)
        fr.add(f"n{i}", h2o.Column.from_numpy(x, device=device))
    doms = [np.array(["a", "b", "c", "d"]), np.array(["x", "y", "z"])]
    for i in range(FLAGSHIP["n_cat"]):
        codes = rng.integers(0, len(doms[i % 2]), n_rows)
        eta += (codes - 1) * 0.2
        fr.add(f"c{i}", h2o.Column.from_numpy(doms[i % 2][codes],
                                              ctype="enum", device=device))
    mu = np.exp(eta)
    y = {"real": eta + 0.5 * rng.standard_normal(n_rows),
         "count": rng.poisson(mu).astype(float),
         "tweedie": np.where(rng.random(n_rows) < 0.3, 0.0,
                             rng.gamma(2.0, mu / 2.0))}[kind]
    fr.add("y", h2o.Column.from_numpy(y, device=device))
    return fr


def small_frame(h2o, device, seed=7, n=600):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    g = np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)]
    yv = np.where(rng.random(n) < 1 / (1 + np.exp(-(2 * x + (g == "a")))),
                  "Y", "N")
    fr = h2o.Frame()
    fr.add("x", h2o.Column.from_numpy(x, device=device))
    fr.add("g", h2o.Column.from_numpy(g, ctype="enum", device=device))
    fr.add("y", h2o.Column.from_numpy(yv, ctype="enum", device=device))
    return fr


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from h2o3_tpu_torch import kernels

    print(nvidia_smi())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    out = subprocess.run([kernels.nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print("nvcc:", out[-1] if out else "?")
    from h2o3_tpu_torch import native

    t0 = time.perf_counter()
    names = kernels.build_all()
    print(f"build_s {time.perf_counter() - t0:.3f} kernels {names}")
    t0 = time.perf_counter()
    native.lib()
    print(f"host_lib_build_s {time.perf_counter() - t0:.3f} "
          f"({native.cxx()}, {native.lib_path().name})")
    cuobjdump = Path(kernels.nvcc()).with_name("cuobjdump")
    for name in names:
        for line in kernels.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(kernels.lib_path(name))],
                              capture_output=True, text=True).stdout
        atomics = sorted({tok for line in sass.splitlines()
                          for tok in line.replace(";", " ").split()
                          if tok.startswith(("ATOMS", "ATOMG", "RED"))})
        print(f"  sass {name}: atomic opcodes {atomics}")


def _to(dev, binned, node, w, y, offsets, bin_dtype):
    return (torch.as_tensor(binned.astype(bin_dtype), device=dev),
            torch.as_tensor(node, device=dev), torch.as_tensor(w, device=dev),
            torch.as_tensor(y, device=dev),
            torch.as_tensor(offsets, device=dev))


def flagship_level_shapes():
    """(n, F, maxB, S) of every histogram the flagship train launches."""
    n, F, maxB = FLAGSHIP["n_rows"], 10, 21
    return [(n, F, maxB, 2 ** d) for d in range(FLAGSHIP["max_depth"])]


def drf_level_shapes():
    """(n, F, maxB, S) of the distinct histograms the deep DRF launches:
    S = min(2**d, 4096) slots at levels d = 0..19 (levels 12..19 are all
    4096 wide); maxB = 19 quantile edges + 2."""
    n, F, maxB = DRF_DEEP["n_rows"], DRF_DEEP["n_num"], 21
    return [(n, F, maxB, 2 ** d) for d in range(13)]


def xgb_level_shapes():
    """(kind, n, S) of XGBoost's histograms on the flagship frame: 1M
    rows, 10 features of 257 bins (int16 bins), S = 1..32 at depth 6."""
    return [("xgboost", FLAGSHIP["n_rows"], 2 ** d)
            for d in range(XGB["max_depth"])]


def isofor_level_shapes():
    """(kind, n, S) of IsolationForest's histograms: 1M rows, ragged
    offsets of a 64-bin uniform spec, S = 1..256 at depth 8."""
    return [("isofor", ISOFOR["n_rows"], 2 ** d)
            for d in range(ISOFOR["max_depth"] + 1)]


def level_case(kind, seed, n, S):
    """Inputs of one histogram at the new paths' level shapes. "xgboost":
    10 features of 257 bins at offsets f*257 (the device grower's
    layout), every row live, weights and residuals random. "isofor": 8
    numerics of 65 bins and categoricals of 5 and 4 at ragged offsets (TB
    529), 256 live rows of n (node -1 elsewhere), w = 1 and y = 0 as the
    isolation trees count rows. Returns (binned, node, w, y, offsets, TB,
    bin dtype)."""
    rng = np.random.default_rng(seed)
    if kind == "xgboost":
        nbins = np.full(10, 257)
        live = np.ones(n, bool)
    else:
        nbins = np.array([65] * 8 + [5, 4])
        live = np.zeros(n, bool)
        live[rng.choice(n, min(ISOFOR["sample_size"], n), replace=False)] = 1
    offsets = np.concatenate([[0], np.cumsum(nbins)[:-1]]).astype(np.int32)
    binned = np.stack([rng.integers(0, b, n) for b in nbins], axis=1)
    node = np.where(live, rng.integers(0, S, n), -1).astype(np.int32)
    if kind == "xgboost":
        w = (rng.random(n) + 0.25).astype(np.float32)
        y = rng.standard_normal(n).astype(np.float32)
        bdt = np.int16
    else:
        w, y = live.astype(np.float32), np.zeros(n, np.float32)
        bdt = np.uint8
    return binned, node, w, y, offsets, int(nbins.sum()), bdt


def _bits(t):
    """int32 view of a float tensor with every NaN as one pattern."""
    return torch.where(torch.isnan(t), torch.nan, t).view(torch.int32)


def same_bits(a, b) -> bool:
    return torch.equal(_bits(a), _bits(b))


def phase_kernels(dev):
    """hist_gather against its plain version on the card, bit for bit:
    the ten geometries and a 32-byte-row one, run to run, tiled 1/2/4
    and with no shared tile, rows permuted, all-dead rows; then extreme
    magnitudes and a slot too large for shared memory."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    cases = [  # the reference's five kernel-test geometries
        (0, 1000, 5, 8, 12, False, np.int32),
        (1, 512, 3, 6, 7, True, np.int32),
        (2, 768, 8, 16, 16, False, np.int16),
        (3, 300, 2, 4, 3, True, np.int32),
        (4, 256, 1, 32, 5, False, np.uint8)]
    cases += [(10 + i, n, F, maxB, S, False, np.uint8)
              for i, (n, F, maxB, S) in enumerate(flagship_level_shapes())]
    # rows of 16 (int16, F=8, above) and 32 bytes take the vector loads
    cases.append((5, 4000, 8, 9, 6, True, np.int32))
    max_err = 0.0
    for seed, n, F, maxB, S, ragged, bdt in cases:
        *arrays, TB = hist_case(seed, n, F, maxB, S, ragged_bins=ragged)
        b, nd, w, y, off = _to(dev, *arrays, bin_dtype=bdt)
        kw = dict(offsets=off, TB=TB, S=S)
        got = hg.hist_gather(b, nd, w, y, **kw)
        ref = hg.hist_gather_ref(b, nd, w, y, **kw)
        err = float((got - ref).abs().max())
        check(same_bits(got, ref), f"hist_gather != plain at n={n} F={F} "
                                   f"maxB={maxB} S={S}: max err {err}")
        check(same_bits(hg.hist_gather(b, nd, w, y, **kw), got),
              f"hist_gather not run-to-run bitwise at n={n} S={S}")
        for tile_S in (0, 1, 2, 4):
            tiled = hg.hist_gather(b, nd, w, y, tile_S=tile_S, **kw)
            check(same_bits(tiled, got),
                  f"tile_S={tile_S} moved a bit at n={n} S={S}")
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(
            seed)).to(dev)
        shuffled = hg.hist_gather(b[perm], nd[perm], w[perm], y[perm], **kw)
        check(same_bits(shuffled, got), f"row order moved a bit at n={n}")
        dead = hg.hist_gather(b, torch.full_like(nd, -1), w, y, **kw)
        check(bool((dead == 0).all()), f"all-dead rows not zero at n={n}")
        if n == FLAGSHIP["n_rows"]:
            max_err = max(max_err, err)
        print(f"hist_gather n={n} F={F} maxB={maxB} S={S} "
              f"{np.dtype(bdt).name}: bitwise == plain (max_abs_err "
              f"{err!r}), repeat, tile_S 0/1/2/4, permuted, all-dead ok")

    n = 200_000
    *arrays, TB = hist_case(30, n, 10, 21, 8)
    spread = 10.0 ** np.random.default_rng(30).uniform(-20, 20, n)
    for label, scale, nan_channels in [("y x 1e20", 1e20, [2]),
                                       ("y x 1e-20", 1e-20, []),
                                       ("y x 1e-20..1e20", spread, [2])]:
        arr = list(arrays)
        arr[3] = (arr[3] * scale).astype(np.float32)
        b, nd, w, y, off = _to(dev, *arr, bin_dtype=np.uint8)
        kw = dict(offsets=off, TB=TB, S=8)
        got = hg.hist_gather(b, nd, w, y, **kw)
        ref = hg.hist_gather_ref(b, nd, w, y, **kw)
        check(same_bits(got, ref), f"hist_gather != plain at {label}")
        nan = [c for c in range(3) if bool(torch.isnan(got[:, c]).all())]
        check(nan == nan_channels, f"{label}: NaN channels {nan}, expected "
                                   f"{nan_channels}")
        print(f"hist_gather n={n} {label}: bitwise == plain, NaN channels "
              f"{nan} (where (w*y)*y overflows f32)")
    *arrays, TB = hist_case(31, n, 4, 3000, 3)
    check(hg.plan_tiles(TB, 3) is None, f"TB={TB} should not fit")
    b, nd, w, y, off = _to(dev, *arrays, bin_dtype=np.int16)
    kw = dict(offsets=off, TB=TB, S=3)
    got = hg.hist_gather(b, nd, w, y, **kw)
    check(same_bits(got, hg.hist_gather_ref(b, nd, w, y, **kw)),
          f"hist_gather != plain at the over-budget slot TB={TB}")
    print(f"hist_gather n={n} TB={TB} (one slot {24 * TB} B > shared "
          f"memory): bitwise == plain")
    return max_err


def phase_kernels_drf(dev):
    """hist_gather against its plain version at the deep DRF's level
    shapes (S up to 4096, so dozens of frontier tiles per launch), bit
    for bit, run to run, and at S = 4096 with other tilings."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    max_err = 0.0
    for i, (n, F, maxB, S) in enumerate(drf_level_shapes()):
        *arrays, TB = hist_case(40 + i, n, F, maxB, S)
        b, nd, w, y, off = _to(dev, *arrays, bin_dtype=np.uint8)
        kw = dict(offsets=off, TB=TB, S=S)
        got = hg.hist_gather(b, nd, w, y, **kw)
        ref = hg.hist_gather_ref(b, nd, w, y, **kw)
        err = float((got - ref).abs().max())
        max_err = max(max_err, err)
        check(same_bits(got, ref), f"hist_gather != plain at the DRF shape "
                                   f"S={S}: max err {err}")
        check(same_bits(hg.hist_gather(b, nd, w, y, **kw), got),
              f"hist_gather not run-to-run bitwise at the DRF shape S={S}")
        tile_S, n_tiles = hg.plan_tiles(TB, S)
        if S >= 128:
            check(n_tiles > 1, f"S={S} should take several tiles")
        extra = ""
        if S == 4096:
            for t in (0, 1, 16):
                check(same_bits(hg.hist_gather(b, nd, w, y, tile_S=t, **kw),
                                got), f"tile_S={t} moved a bit at S={S}")
            extra = ", tile_S 0/1/16"
        print(f"hist_gather DRF n={n} F={F} maxB={maxB} S={S} (tile_S="
              f"{tile_S}, {n_tiles} tiles): bitwise == plain (max_abs_err "
              f"{err!r}), repeat{extra} ok")
    return max_err


def phase_kernels_new(dev):
    """hist_gather against its plain version at XGBoost's and
    IsolationForest's level shapes, bit for bit, run to run, with tile_S
    0/1/2 and rows permuted."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    max_err = 0.0
    for i, (kind, n, S) in enumerate(xgb_level_shapes()
                                     + isofor_level_shapes()):
        *arrays, TB, bdt = level_case(kind, 80 + i, n, S)
        b, nd, w, y, off = _to(dev, *arrays, bin_dtype=bdt)
        kw = dict(offsets=off, TB=TB, S=S)
        got = hg.hist_gather(b, nd, w, y, **kw)
        ref = hg.hist_gather_ref(b, nd, w, y, **kw)
        err = float((got - ref).abs().max())
        max_err = max(max_err, err)
        check(same_bits(got, ref), f"hist_gather != plain at the {kind} "
                                   f"shape S={S}: max err {err}")
        check(same_bits(hg.hist_gather(b, nd, w, y, **kw), got),
              f"hist_gather not run-to-run bitwise at the {kind} shape "
              f"S={S}")
        for tile_S in (0, 1, 2):
            check(same_bits(hg.hist_gather(b, nd, w, y, tile_S=tile_S, **kw),
                            got), f"tile_S={tile_S} moved a bit at the "
                                  f"{kind} shape S={S}")
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(
            i)).to(dev)
        shuffled = hg.hist_gather(b[perm], nd[perm], w[perm], y[perm], **kw)
        check(same_bits(shuffled, got), f"row order moved a bit at the "
                                        f"{kind} shape S={S}")
        tile_S, n_tiles = hg.plan_tiles(TB, S)
        print(f"hist_gather {kind} n={n} TB={TB} S={S} "
              f"{np.dtype(bdt).name} (tile_S={tile_S}, {n_tiles} tiles): "
              f"bitwise == plain (max_abs_err {err!r}), repeat, tile_S "
              f"0/1/2, permuted ok")
    return max_err


def phase_flagship(h2o, dev):
    """The port's main path at full width: train and score the flagship."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    t0 = time.perf_counter()
    fr = flagship_frame(h2o, dev, FLAGSHIP["n_rows"])
    print(f"flagship frame {fr.nrows}x{fr.ncols} built in "
          f"{time.perf_counter() - t0:.1f}s")
    h2o.GBM(ntrees=2, max_depth=FLAGSHIP["max_depth"]).train(
        y="y", training_frame=fr)                    # warm-up
    torch.cuda.synchronize()
    hg.launches = 0
    t0 = time.perf_counter()
    m = h2o.GBM(ntrees=FLAGSHIP["ntrees"],
                max_depth=FLAGSHIP["max_depth"]).train(y="y",
                                                       training_frame=fr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = hg.launches
    auc = float(m._output.training_metrics.auc)
    rows_per_sec = FLAGSHIP["n_rows"] * FLAGSHIP["ntrees"] / dt
    RUN["gbm_train_s"] = dt
    print(f"gbm_train_s {dt!r}")
    print(f"gbm_rows_per_sec {rows_per_sec!r}")
    print(f"gbm_training_auc {auc!r} logloss "
          f"{m._output.training_metrics.logloss!r}")
    print(f"hist_gather launches {launches} "
          f"({launches / FLAGSHIP['ntrees']:.0f} per tree)")
    check(np.isfinite(auc) and auc > 0.5, f"training AUC {auc} not > 0.5")
    check(launches == FLAGSHIP["max_depth"] * FLAGSHIP["ntrees"],
          f"{launches} hist_gather launches, expected "
          f"{FLAGSHIP['max_depth'] * FLAGSHIP['ntrees']}")
    t0 = time.perf_counter()
    pred = m.predict(fr)
    p = pred.col("Y").data
    torch.cuda.synchronize()
    print(f"predict_s {time.perf_counter() - t0!r}")
    check(p.shape == (FLAGSHIP["n_rows"],), f"prediction shape {p.shape}")
    check(bool(torch.isfinite(p).all()) and bool(((p >= 0) & (p <= 1)).all()),
          "predicted probabilities not finite in [0, 1]")
    _retrain_bitwise("flagship GBM", m, h2o.GBM(
        ntrees=FLAGSHIP["ntrees"], max_depth=FLAGSHIP["max_depth"]).train(
            y="y", training_frame=fr))
    RUN["flagship_forest"] = _forest_bits(m)      # phase 3v's resumes
    # phase 3y's references: the one-process predictions, AUC and frame
    # bytes of the flagship
    RUN["flagship_pred"] = p.cpu().numpy()
    RUN["flagship_auc"] = auc
    RUN["flagship_frame_bytes"] = sum(_frame_bytes(fr))
    return launches, fr, m


def phase_drf_deep(h2o, dev):
    """The reference's second stage, uncut: DRF on 200k rows, 6 numeric
    features, binomial, 5 trees, depth 20, after a 1-tree warm-up; then a
    retrain that must give the same forest bit for bit."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    c = DRF_DEEP
    fr = drf_deep_frame(h2o, dev, c["n_rows"], seed=c["seed"])
    kw = dict(max_depth=c["max_depth"], seed=c["seed"])
    h2o.DRF(ntrees=1, **kw).train(y="y", training_frame=fr)     # warm-up
    torch.cuda.synchronize()
    hg.launches = 0
    t0 = time.perf_counter()
    m = h2o.DRF(ntrees=c["ntrees"], **kw).train(y="y", training_frame=fr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = hg.launches
    tm = m._output.training_metrics
    print(f"drf_train_s {dt!r}")
    print(f"drf_deep_rows_per_sec {c['n_rows'] * c['ntrees'] / dt!r}")
    print(f"drf_oob_auc {tm.auc!r} (out-of-bag rows {tm.nobs!r}), "
          f"nodes per tree up to {m.forest.feat.shape[1]}")
    print(f"hist_gather launches {launches} "
          f"({launches / c['ntrees']:.0f} per tree)")
    check(np.isfinite(tm.auc) and tm.auc > 0.5,
          f"DRF OOB AUC {tm.auc} not > 0.5")
    check(launches == c["ntrees"] * c["max_depth"],
          f"{launches} hist_gather launches, expected "
          f"{c['ntrees'] * c['max_depth']}")
    p = m.predict(fr).col("Y").data
    check(p.shape == (c["n_rows"],) and bool(torch.isfinite(p).all())
          and bool(((p >= 0) & (p <= 1)).all()),
          "DRF probabilities not finite in [0, 1]")
    _retrain_bitwise("DRF", m, h2o.DRF(ntrees=c["ntrees"], **kw).train(
        y="y", training_frame=fr))
    RUN["drf_deep"] = (_forest_bits(m), _oob_bits(m))   # phase 3v
    phase_profile("1-tree deep DRF train", lambda: h2o.DRF(
        ntrees=1, **kw).train(y="y", training_frame=fr))
    return launches


def phase_multinomial(h2o, dev):
    """A multinomial GBM on the flagship's features: 1M training rows, a
    4-class response, 20 iterations at depth 5, sample_rate and
    col_sample_rate 0.8, and a 200k-row validation frame with
    stopping_rounds 3."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    c = MULTINOMIAL
    t0 = time.perf_counter()
    tr, va = multinomial_frames(h2o, dev, c["n_rows"], c["n_valid"],
                                c["classes"])
    print(f"multinomial frames {tr.nrows} + {va.nrows} rows built in "
          f"{time.perf_counter() - t0:.1f}s")
    kw = dict(max_depth=c["max_depth"], sample_rate=c["sample_rate"],
              col_sample_rate=c["col_sample_rate"], seed=c["seed"])
    h2o.GBM(ntrees=2, **kw).train(y="y", training_frame=tr)     # warm-up
    torch.cuda.synchronize()
    hg.launches = 0
    t0 = time.perf_counter()
    m = h2o.GBM(ntrees=c["ntrees"], stopping_rounds=c["stopping_rounds"],
                **kw).train(y="y", training_frame=tr, validation_frame=va)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = hg.launches
    trees = m.forest.n_trees
    vm = m._output.validation_metrics
    hist = m._output.scoring_history
    print(f"gbm_multinomial_train_s {dt!r}")
    print(f"gbm_multinomial trees built {trees} ({trees // c['classes']} "
          f"iterations of {c['classes']}), validation logloss "
          f"{vm.logloss!r}, last scored {hist[-1]}")
    print(f"hist_gather launches {launches}")
    check(trees % c["classes"] == 0 and trees > 0, f"{trees} trees")
    check(launches == trees * c["max_depth"],
          f"{launches} hist_gather launches for {trees} trees")
    check(np.isfinite(vm.logloss) and vm.logloss < np.log(c["classes"]),
          f"validation logloss {vm.logloss} not below the prior's")
    check(abs(hist[-1]["validation_logloss"] - vm.logloss) < 1e-4,
          "in-training and final validation logloss disagree")
    pred = m.predict(va)
    P = torch.stack([pred.col(f"k{k}").data for k in range(c["classes"])], 1)
    check(bool(torch.isfinite(P).all())
          and float((P.sum(1) - 1).abs().max()) < 1e-5,
          "multinomial probabilities do not sum to 1")
    return launches


def _retrain_bitwise(label, m, again):
    a, b = _forest_arrays(m), _forest_arrays(again)
    for k in a:
        check(np.array_equal(a[k], b[k]), f"{label} retrain changed forest "
                                          f"{k}")
    check(np.array_equal(m.forest.leaf_val, again.forest.leaf_val),
          f"{label} retrain changed a leaf value")
    print(f"{label} retrain on the card: forest bitwise identical")


def phase_xgboost(h2o, dev, fr):
    """XGBoost gbtree on the flagship frame at the reference's XGBoost
    defaults (eta 0.3, depth 6, nbins 256 so 257-bin int16 features,
    lambda 1, gamma 0), 20 trees after a 2-tree warm-up, timed as the
    flagship GBM is; then a retrain that must give the same forest."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    c = XGB
    h2o.XGBoost(ntrees=2, seed=c["seed"]).train(y="y", training_frame=fr)
    torch.cuda.synchronize()
    hg.launches = 0
    t0 = time.perf_counter()
    m = h2o.XGBoost(ntrees=c["ntrees"], seed=c["seed"]).train(
        y="y", training_frame=fr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = hg.launches
    auc = float(m._output.training_metrics.auc)
    maxB = int(m.spec.nbins.max())
    print(f"xgb_train_s {dt!r}")
    print(f"xgb_rows_per_sec {fr.nrows * c['ntrees'] / dt!r}")
    print(f"xgb_training_auc {auc!r} logloss "
          f"{m._output.training_metrics.logloss!r}; maxB {maxB}, bins "
          f"{m.spec.bin_columns(fr).dtype}")
    print(f"hist_gather launches {launches} "
          f"({launches / c['ntrees']:.0f} per tree)")
    check(np.isfinite(auc) and auc > 0.5, f"XGBoost AUC {auc} not > 0.5")
    check(maxB == 257, f"XGBoost's widest feature has {maxB} bins, not 257")
    check(launches == c["max_depth"] * c["ntrees"],
          f"{launches} hist_gather launches, expected "
          f"{c['max_depth'] * c['ntrees']}")
    p = m.predict(fr).col("Y").data
    check(p.shape == (fr.nrows,) and bool(torch.isfinite(p).all())
          and bool(((p >= 0) & (p <= 1)).all()),
          "XGBoost probabilities not finite in [0, 1]")
    _retrain_bitwise("XGBoost", m, h2o.XGBoost(
        ntrees=c["ntrees"], seed=c["seed"]).train(y="y", training_frame=fr))
    RUN["xgb_ref"] = (_digest(m), dt)            # phase 3y
    return launches


def phase_xgboost_dart(h2o, dev, fr):
    """XGBoost booster dart (rate_drop 0.1) on the flagship frame, 20
    trees, every iteration scored so the history shows the drops; then a
    retrain that must give the same forest."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    c = XGB
    kw = dict(booster="dart", rate_drop=c["rate_drop"], seed=c["seed"],
              score_each_iteration=True)
    h2o.XGBoost(ntrees=2, **kw).train(y="y", training_frame=fr)
    torch.cuda.synchronize()
    hg.launches = 0
    t0 = time.perf_counter()
    m = h2o.XGBoost(ntrees=c["ntrees"], **kw).train(y="y", training_frame=fr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = hg.launches
    dropped = [e["dropped"] for e in m._output.scoring_history]
    auc = float(m._output.training_metrics.auc)
    print(f"xgb_dart_train_s {dt!r}")
    print(f"xgb_dart_training_auc {auc!r}; trees dropped per iteration "
          f"{dropped}")
    print(f"hist_gather launches {launches}")
    check(np.isfinite(auc) and auc > 0.5, f"dart AUC {auc} not > 0.5")
    check(len(dropped) == c["ntrees"] and sum(dropped) > 0,
          f"dart dropped no tree: {dropped}")
    check(launches == c["max_depth"] * c["ntrees"],
          f"{launches} hist_gather launches, expected "
          f"{c['max_depth'] * c['ntrees']}")
    _retrain_bitwise("XGBoost dart", m, h2o.XGBoost(
        ntrees=c["ntrees"], **kw).train(y="y", training_frame=fr))
    return launches


def _outlier_check(label, score, moved):
    s = score.double().cpu().numpy()
    out, rest = float(s[moved].mean()), float(s[~moved].mean())
    print(f"{label} mean score: moved rows {out!r}, the rest {rest!r}")
    check(np.isfinite(s).all() and ((s > 0) & (s <= 1)).all(),
          f"{label} scores not finite in (0, 1]")
    check(out > rest, f"{label}: moved rows do not score above the rest")


def phase_isofor(h2o, dev):
    """IsolationForest at the reference's defaults on the outlier frame
    (1M rows), after a 2-tree warm-up: train, score the 1M rows (the
    second of two predicts is timed), the moved rows must score higher,
    and one histogram per level grown."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    c = ISOFOR
    fr, moved = outlier_frame(h2o, dev, c["n_rows"], c["outlier_frac"],
                              c["shift"])
    kw = dict(max_depth=c["max_depth"], sample_size=c["sample_size"],
              nbins=c["nbins"], seed=c["seed"])
    h2o.IsolationForest(ntrees=2, **kw).train(training_frame=fr)
    torch.cuda.synchronize()
    hg.launches = 0
    t0 = time.perf_counter()
    m = h2o.IsolationForest(ntrees=c["ntrees"], **kw).train(
        training_frame=fr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = hg.launches
    levels = int((m.forest.depths() + 1).sum())
    m.predict(fr)                     # warm-up: time the second predict
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = m.predict(fr)
    score = pred.col("predict").data
    torch.cuda.synchronize()
    ds = time.perf_counter() - t0
    print(f"isofor_train_s {dt!r}")
    print(f"isofor_score_s {ds!r} ({fr.nrows} rows)")
    print(f"hist_gather launches {launches}, levels grown {levels} "
          f"(TB {m.spec.tot_bins}, deepest tree "
          f"{int(m.forest.depths().max())})")
    check(launches == levels, f"{launches} hist_gather launches for "
                              f"{levels} levels grown")
    check(score.shape == (fr.nrows,), f"score shape {score.shape}")
    _outlier_check("isofor", score, moved)
    again = h2o.IsolationForest(ntrees=c["ntrees"], **kw).train(
        training_frame=fr)
    _retrain_bitwise("IsolationForest", m, again)
    return launches, fr, moved, m


def phase_eif(h2o, dev, fr, moved):
    """Extended Isolation Forest (100 trees, sample_size 256, extension
    level d - 1) on the outlier frame after a 2-tree warm-up: train,
    score the 1M rows (the second of two predicts is timed), the moved
    rows must score higher."""
    c = EIF
    d = sum(max(fr.col(n).cardinality, 1) for n in fr.names)
    kw = dict(sample_size=c["sample_size"], extension_level=d - 1,
              seed=c["seed"])
    h2o.ExtendedIsolationForest(ntrees=2, **kw).train(training_frame=fr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = h2o.ExtendedIsolationForest(ntrees=c["ntrees"], **kw).train(
        training_frame=fr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(m.normals.shape[2] == d, f"EIF normals {m.normals.shape}, d={d}")
    m.predict(fr)                     # warm-up: time the second predict
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score = m.predict(fr).col("predict").data
    torch.cuda.synchronize()
    ds = time.perf_counter() - t0
    print(f"eif_train_s {dt!r}")
    print(f"eif_score_s {ds!r} ({fr.nrows} rows, packed trees "
          f"{tuple(m.normals.shape)}, depth {m.max_depth})")
    check(score.shape == (fr.nrows,), f"score shape {score.shape}")
    _outlier_check("eif", score, moved)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_glm_bench(h2o, dev):
    """The reference bench's GLM at its width: a binomial GLM (lambda 0,
    IRLS) on 1M rows and 32 features, one warm-up train, then one on the
    clock; coefficients within COEF_SE_BOUND standard errors of b_true;
    a retrain with p-values must give the same coefficients bit for
    bit."""
    c = GLM_BENCH
    t0 = time.perf_counter()
    fr, b_true = glm_bench_frame(h2o, dev, c["n_rows"], c["p"], c["seed"])
    print(f"glm bench frame {fr.nrows}x{fr.ncols} built in "
          f"{time.perf_counter() - t0:.1f}s")
    kw = dict(family="binomial", lambda_=0.0)
    h2o.GLM(**kw).train(y="y", training_frame=fr)               # warm-up
    m, dt = _timed(lambda: h2o.GLM(**kw).train(y="y", training_frame=fr))
    it = m.iterations
    auc = float(m._output.training_metrics.auc)
    print(f"glm_train_s {dt!r}")
    print(f"iterations {it}")
    print(f"glm_irls_rows_per_sec {c['n_rows'] * it / dt!r}")
    print(f"glm_training_auc {auc!r} residual deviance "
          f"{m.residual_deviance!r} null deviance {m.null_deviance!r}")
    check(np.isfinite(auc) and auc > 0.5, f"GLM AUC {auc} not > 0.5")
    pv = h2o.GLM(compute_p_values=True, **kw).train(y="y", training_frame=fr)
    check(torch.equal(pv.beta, m.beta), "GLM retrain changed a coefficient")
    coef = m.coef()
    est = np.array([coef[f"x{j}"] for j in range(c["p"])])
    se = pv.std_errors[:c["p"]] / m.dinfo.num_sigmas.astype(np.float64)
    err = np.abs(est - b_true)
    worst = float(np.max(err / se))
    print(f"GLM retrain on the card: coefficients bitwise identical; "
          f"max |coef - b_true| {float(err.max())!r}, at most {worst:.2f} "
          f"standard errors (bound {COEF_SE_BOUND}); p-values finite "
          f"{bool(np.isfinite(pv.p_values).all())}")
    check(np.isfinite(se).all() and worst <= COEF_SE_BOUND,
          f"GLM coefficients {worst:.2f} standard errors from b_true")
    check(bool(np.isfinite(pv.p_values).all()), "GLM p-values not finite")
    RUN["glm_bench_beta"] = m.beta.cpu().numpy()      # phase 3y
    return fr


def _class_null_deviance(fr, y="y"):
    codes = fr.col(y).data.long()
    counts = torch.bincount(codes[codes >= 0]).double().cpu().numpy()
    counts = counts[counts > 0]
    return float(-2 * np.sum(counts * np.log(counts / counts.sum())))


def phase_glm_solvers(h2o, dev, fr):
    """GLM's other solvers on the flagship frame (1M rows; one-hot and
    standardisation both run): lambda search with alpha 0.5 (ADMM each
    step), p-values at lambda 0, multinomial and ordinal on the 4-class
    frame (L-BFGS), and XGBoost gblinear."""
    m, dt = _timed(lambda: h2o.GLM(lambda_search=True, alpha=0.5).train(
        y="y", training_frame=fr))
    print(f"glm_lambda_search_train_s {dt!r} lambdas fitted "
          f"{m.iterations}, AUC {m._output.training_metrics.auc!r}")
    check(m.iterations >= 2 and m._output.training_metrics.auc > 0.5,
          "lambda search fitted too few lambdas or lost the signal")
    m, dt = _timed(lambda: h2o.GLM(lambda_=0.0, compute_p_values=True
                                   ).train(y="y", training_frame=fr))
    print(f"glm_p_values_train_s {dt!r} iterations {m.iterations}, "
          f"p-values {np.array2string(m.p_values[:4], precision=3)}...")
    check(m.p_values is not None and bool(np.isfinite(m.p_values).all()),
          "p-values not finite")
    mfr, _ = multinomial_frames(h2o, dev, FLAGSHIP["n_rows"], 0,
                                MULTINOMIAL["classes"])
    null_dev = _class_null_deviance(mfr)
    for fam in ("multinomial", "ordinal"):
        m, dt = _timed(lambda: h2o.GLM(family=fam).train(
            y="y", training_frame=mfr))
        print(f"glm_{fam}_train_s {dt!r} iterations {m.iterations}, "
              f"deviance {m.residual_deviance!r} (null {null_dev!r})")
        check(np.isfinite(m.residual_deviance)
              and m.residual_deviance < null_dev,
              f"{fam} deviance not below the null deviance")
        P = m.predict(mfr)
        P = torch.stack([P.col(f"k{k}").data for k in range(4)], 1)
        check(float((P.sum(1) - 1).abs().max()) < 1e-5,
              f"{fam} probabilities do not sum to 1")
    m, dt = _timed(lambda: h2o.XGBoost(booster="gblinear").train(
        y="y", training_frame=fr))
    print(f"xgb_gblinear_train_s {dt!r} iterations {m.iterations}, AUC "
          f"{m._output.training_metrics.auc!r}")
    check(m._output.training_metrics.auc > 0.5, "gblinear AUC not > 0.5")


def phase_gam_rulefit(h2o, dev):
    """GAM with one gam column per basis type 0-3, and RuleFit at the
    reference's defaults, on 200k rows of the flagship frame; RuleFit's
    DRF rules run the histogram kernel, whose launches are counted."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    fr = flagship_frame(h2o, dev, GAM_RULEFIT_ROWS)
    m, dt = _timed(lambda: h2o.GAM(gam_columns=["n0", "n1", "n2", "n3"],
                                   bs=[0, 1, 2, 3]).train(
        y="y", training_frame=fr))
    auc = float(m._output.training_metrics.auc)
    print(f"gam_train_s {dt!r} (knots {sum(len(k) for k in m.knots.values())}"
          f", {m.glm_model.dinfo.fullN} design columns, "
          f"{m.glm_model.iterations} IRLS steps), AUC {auc!r}")
    check(np.isfinite(auc) and auc > 0.5, f"GAM AUC {auc} not > 0.5")
    hg.launches = 0
    m, dt = _timed(lambda: h2o.RuleFit(seed=1).train(y="y",
                                                     training_frame=fr))
    launches = hg.launches
    gen = m.tree_models[0]
    active = sum(1 for r in m.rules if r["coefficient"] != 0)
    auc = float(m._output.training_metrics.auc)
    print(f"rulefit_train_s {dt!r}")
    print(f"rulefit rules {len(m.rules)} ({active} with a nonzero "
          f"coefficient), lambdas fitted {m.glm_model.iterations}, AUC "
          f"{auc!r}; top rule {m.rules[0]['rule']!r}")
    print(f"hist_gather launches {launches} ({gen.forest.n_trees} trees of "
          f"depth {int(gen.forest.depths().max())})")
    check(np.isfinite(auc) and auc > 0.5, f"RuleFit AUC {auc} not > 0.5")
    check(launches == 3 * gen.forest.n_trees,
          f"{launches} hist_gather launches for {gen.forest.n_trees} trees "
          "of depth 3")
    check(len(m.rules) > 0 and active > 0, "RuleFit kept no rule")
    phase_profile("RuleFit train (200k rows)", lambda: h2o.RuleFit(
        seed=1).train(y="y", training_frame=fr))
    return launches


def write_csv(path, cols, fmt_num):
    """Write {name: (values, ctype)} as CSV with plain Python, 100k rows
    at a time: numeric values through `fmt_num` (an array -> list of
    str), enum values as their labels."""
    names = list(cols)
    n = len(cols[names[0]][0])
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for lo in range(0, n, 100_000):
            parts = [fmt_num(arr[lo:lo + 100_000]) if ctype is None
                     else arr[lo:lo + 100_000].tolist()
                     for arr, ctype in cols.values()]
            f.write("\n".join(map(",".join, zip(*parts))) + "\n")


def run_parse_arrays(n_rows, n_num, n_cat, seed, extra_level=False):
    """h2o3_tpu/bench.py run_parse's columns (:711-724): numbers rounded
    to 6 decimals, enums over alpha..delta and x/y/z; `extra_level`
    puts a level never seen in the base file into c0."""
    rng = np.random.default_rng(seed)
    cols = {f"n{i}": (np.round(rng.standard_normal(n_rows), 6), None)
            for i in range(n_num)}
    doms = [np.array(["alpha", "beta", "gamma", "delta"]),
            np.array(["x", "y", "z"])]
    for i in range(n_cat):
        dom = doms[i % 2]
        if extra_level and i == 0:
            dom = np.append(dom, "epsilon")
        cols[f"c{i}"] = (dom[rng.integers(0, len(dom), n_rows)], "enum")
    return cols


def _repr_f64(a):
    return list(map(repr, a.tolist()))


def _repr_f32(a):
    # each value as the float64 repr of its float32 value: the text
    # round-trips to the same float32 by construction
    return list(map(repr, np.asarray(a, np.float64).astype(np.float32)
                    .astype(np.float64).tolist()))


def same_frames(label, a, b):
    """Two port frames hold the same data bit for bit: names, types,
    domains, values and NA masks."""
    check(a.names == b.names and a.nrows == b.nrows,
          f"{label}: shapes differ ({a.nrows}x{a.ncols} vs "
          f"{b.nrows}x{b.ncols})")
    check(a.types == b.types, f"{label}: types differ")
    for nm in a.names:
        ca, cb = a.col(nm), b.col(nm)
        check((ca.domain or None) == (cb.domain or None),
              f"{label}: domain of {nm} differs")
        x, y = ca.data.cpu(), cb.data.cpu()
        check(x.dtype == y.dtype and same_bits(x, y),
              f"{label}: column {nm} differs")


def phase_ingest(h2o, dev, tmp, flagship_model):
    """The reference bench's run_parse file imported chunked and
    monolithic, a streaming append against a cold import, and the
    flagship trained from its CSV. Returns the imported train's kernel
    launches, the run_parse file's path (phase 4 imports it again), and
    the flagship CSV with its imported frame and model (phase 3u's
    reference)."""
    import os

    from h2o3_tpu_torch.ingest import chunked
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    rp = RUN_PARSE
    path = os.path.join(tmp, "bench_parse.csv")
    t0 = time.perf_counter()
    write_csv(path, run_parse_arrays(rp["n_rows"], rp["n_num"], rp["n_cat"],
                                     rp["seed"]), _repr_f64)
    size_mb = os.path.getsize(path) / 1e6
    print(f"run_parse file: {rp['n_rows']} rows, {size_mb:.3f} MB, written "
          f"in {time.perf_counter() - t0:.2f}s")
    warm = os.path.join(tmp, "warm.csv")
    with open(warm, "w") as f:
        f.write("a,b\n1,x\n2,y\n")
    h2o.import_file(warm)
    torch.cuda.synchronize()

    c0 = chunked.counters()
    t0 = time.perf_counter()
    fr = h2o.import_file(path)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c1 = chunked.counters()
    prof = dict(chunked.last_profile)
    coord = c1["coordinator_ingest_bytes"] - c0["coordinator_ingest_bytes"]
    print(f"parse_s {dt!r}")
    print(f"parse_mb_per_sec {size_mb / dt!r}")
    print(f"parse_chunks {c1['chunks'] - c0['chunks']} parse_workers "
          f"{prof['workers']} coordinator_ingest_bytes {coord}")
    print("parse stages (s): " + ", ".join(
        f"{k} {prof[k]:.4f}" for k in ("split_s", "parse_s", "parse_cpu_s",
                                        "resolve_s", "ship_s", "total_s")))
    check(fr.nrows == rp["n_rows"] and fr.ncols == rp["n_num"] + rp["n_cat"],
          f"run_parse frame {fr.nrows}x{fr.ncols}")
    check(fr.col("c0").domain == ["alpha", "beta", "delta", "gamma"]
          and fr.col("c1").domain == ["x", "y", "z"], "run_parse domains")
    check(all(fr.col(f"n{i}").data.device.type == "cuda"
              for i in range(rp["n_num"])), "columns not on the card")
    check(coord == 0, f"chunked import staged {coord} whole-column bytes")
    os.environ["H2O_TPU_INGEST_CHUNKED"] = "0"
    try:
        t0 = time.perf_counter()
        mono = h2o.import_file(path)
        torch.cuda.synchronize()
        print(f"parse_mono_s {time.perf_counter() - t0!r}")
    finally:
        os.environ.pop("H2O_TPU_INGEST_CHUNKED")
    same_frames("chunked vs monolithic", fr, mono)
    print("chunked == monolithic import: values, NA masks, domains bitwise")
    del mono
    phase_profile("chunked import (run_parse file)",
                  lambda: h2o.import_file(path))

    # streaming append of a batch with a level the file never had
    batch = run_parse_arrays(rp["append_rows"], rp["n_num"], rp["n_cat"],
                             rp["seed"] + 1, extra_level=True)
    bpath = os.path.join(tmp, "batch.csv")
    write_csv(bpath, batch, _repr_f64)
    with open(bpath) as f:
        text = f.read().split("\n", 1)[1]
    cold_path = os.path.join(tmp, "bench_parse_appended.csv")
    with open(cold_path, "w") as out, open(path) as base:
        out.write(base.read() + text)
    t0 = time.perf_counter()
    appended = chunked.append_csv(fr, text)
    torch.cuda.synchronize()
    print(f"append_s {time.perf_counter() - t0!r} ({appended} rows)")
    check(appended == rp["append_rows"], f"appended {appended} rows")
    check(fr.col("c0").domain == ["alpha", "beta", "delta", "epsilon",
                                  "gamma"], "append did not grow c0")
    same_frames("append vs cold import", fr, h2o.import_file(cold_path))
    print("streaming append == cold import of the concatenated file: "
          "bitwise")
    del fr

    # the flagship from CSV: the same forest as phase 3's frame
    fpath = os.path.join(tmp, "flagship.csv")
    t0 = time.perf_counter()
    write_csv(fpath, flagship_arrays(FLAGSHIP["n_rows"]), _repr_f32)
    fsize = os.path.getsize(fpath) / 1e6
    print(f"flagship file: {FLAGSHIP['n_rows']} rows, {fsize:.3f} MB, "
          f"written in {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    ifr = h2o.import_file(fpath)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"flagship_parse_s {dt!r}")
    RUN["flagship_parse_s"] = dt
    print(f"flagship_parse_mb_per_sec {fsize / dt!r}")
    same_frames("imported flagship vs phase 3's frame", ifr,
                flagship_frame(h2o, dev, FLAGSHIP["n_rows"]))
    hg.launches = 0
    t0 = time.perf_counter()
    m = h2o.GBM(ntrees=FLAGSHIP["ntrees"],
                max_depth=FLAGSHIP["max_depth"]).train(y="y",
                                                       training_frame=ifr)
    torch.cuda.synchronize()
    launches = hg.launches
    auc = float(m._output.training_metrics.auc)
    RUN["gbm_train_imported_s"] = time.perf_counter() - t0
    print(f"gbm_train_s (imported flagship) {RUN['gbm_train_imported_s']!r}")
    print(f"imported flagship AUC {auc!r}, phase 3 AUC "
          f"{float(flagship_model._output.training_metrics.auc)!r}; "
          f"hist_gather launches {launches}")
    check(launches == FLAGSHIP["max_depth"] * FLAGSHIP["ntrees"],
          f"{launches} hist_gather launches on the imported flagship")
    a, b = _forest_arrays(m), _forest_arrays(flagship_model)
    for k in a:
        check(np.array_equal(a[k], b[k]), f"imported flagship forest {k} "
                                          "differs from phase 3's")
    check(np.array_equal(m.forest.leaf_val, flagship_model.forest.leaf_val),
          "imported flagship leaf values differ from phase 3's")
    check(auc == float(flagship_model._output.training_metrics.auc),
          "imported flagship AUC differs from phase 3's")
    print("flagship from CSV: forest and AUC bitwise equal to phase 3's")
    return launches, path, fpath, ifr, m


# ---------------------------------------------------------------------------
# DeepLearning and the model framework (phases 3m, 3n)
# ---------------------------------------------------------------------------

def _dl_weights(m):
    return [t.detach().cpu().numpy() for W, b in m.params_tree
            for t in (W, b)]


def _prior_logloss(fr, y="y"):
    p = float(fr.col(y).data.float().mean())
    return float(-(p * np.log(p) + (1 - p) * np.log(1 - p)))


def phase_deeplearning(h2o, dev, fr):
    """DeepLearning at the reference's defaults (hidden [200, 200],
    Rectifier, ADADELTA, mini_batch_size 32) for one epoch of the
    flagship frame (31,250 steps through the CUDA graph), after a warm-up
    train on 20k rows; a retrain that must give the same weights bit for
    bit; the graph loop against the eager loop on 20k rows; and a warm
    1M-row predict."""
    from h2o3_tpu_torch.models import deeplearning as dl

    c = DL
    small = flagship_frame(h2o, dev, c["small_rows"], seed=1)
    h2o.DeepLearning(epochs=1, seed=c["seed"]).train(
        y="y", training_frame=small)                       # warm-up
    torch.cuda.synchronize()
    dl.graph_replays = dl.eager_steps = 0
    t0 = time.perf_counter()
    m = h2o.DeepLearning(epochs=1, seed=c["seed"]).train(y="y",
                                                         training_frame=fr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = -(-fr.nrows // c["batch"])
    replays, eager = dl.graph_replays, dl.eager_steps
    tm = m._output.training_metrics
    prior = _prior_logloss(fr)
    metric("dl_train_s", dt)
    metric("dl_steps_per_sec", steps / dt,
           f"({steps} steps of {c['batch']} rows, hidden "
           f"{m.params_tree[0][0].shape[1]}x{m.params_tree[1][0].shape[1]}, "
           f"fullN {m.data_info.fullN})")
    print(f"dl_training_auc {tm.auc!r} logloss {tm.logloss!r} (prior "
          f"{prior!r}); graph replays {replays}, eager steps {eager}")
    check(replays == steps and eager == 0,
          f"{replays} graph replays and {eager} eager steps for {steps} "
          "steps")
    check(np.isfinite(tm.auc) and tm.auc > 0.5, f"DL AUC {tm.auc}")
    check(tm.logloss < prior, f"DL logloss {tm.logloss} not below the "
                              f"prior's {prior}")
    again = h2o.DeepLearning(epochs=1, seed=c["seed"]).train(
        y="y", training_frame=fr)
    check(all(np.array_equal(a, b) for a, b in
              zip(_dl_weights(m), _dl_weights(again))),
          "DL retrain changed a weight")
    print("DL retrain on the card: weights bitwise identical")
    for kw in ({}, {"activation": "RectifierWithDropout",
                    "input_dropout_ratio": 0.2},
               {"adaptive_rate": False, "momentum_start": 0.9}):
        w, t = {}, {}
        for mode in ("graph", "eager"):
            b = h2o.DeepLearning(epochs=1, seed=c["seed"], **kw)
            b._force_eager = mode == "eager"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w[mode] = _dl_weights(b.train(y="y", training_frame=small))
            torch.cuda.synchronize()
            t[mode] = time.perf_counter() - t0
        check(all(np.array_equal(a, b) for a, b in
                  zip(w["graph"], w["eager"])),
              f"DL {kw}: the graph loop and the eager loop differ")
        print(f"DL {kw or 'defaults'} on {small.nrows} rows: graph loop == "
              f"eager loop bitwise; graph {t['graph']:.3f} s, eager "
              f"{t['eager']:.3f} s")
    m.predict(fr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = m.predict(fr).col("Y").data
    torch.cuda.synchronize()
    metric("dl_predict_s", time.perf_counter() - t0, f"({fr.nrows} rows)")
    check(p.shape == (fr.nrows,) and bool(torch.isfinite(p).all()),
          "DL probabilities not finite")
    small_steps = -(-small.nrows // c["batch"])
    _, small_ops = phase_profile(
        f"DeepLearning 1-epoch train ({small.nrows} rows, {small_steps} "
        "steps)", lambda: h2o.DeepLearning(epochs=1, seed=c["seed"]).train(
            y="y", training_frame=small))
    # the device-busy share of the 1M-row train itself: its device time
    # under the profiler over the wall of the unprofiled train timed above
    busy_us, n_ops = device_time(lambda: h2o.DeepLearning(
        epochs=1, seed=c["seed"]).train(y="y", training_frame=fr))
    # the profiler's activity buffers can fill and drop the rest of a
    # long trace: the smaller train's ops per step say what a whole trace
    # of this one holds
    if busy_us <= 0 or n_ops < 0.9 * steps * small_ops / small_steps:
        print(f"dl_train device-busy share: not measured (the profiler "
              f"kept {n_ops} device ops of the {fr.nrows}-row train, "
              f"{n_ops / steps:.1f} a step against "
              f"{small_ops / small_steps:.1f} a step at {small.nrows} rows)")
    else:
        print(f"dl_train device busy {busy_us / 1e3:.1f} ms = "
              f"{100 * busy_us / (dt * 1e6):.1f}% of its {dt:.3f} s wall "
              f"(profiled {fr.nrows}-row train, {n_ops} device ops, "
              f"{n_ops / steps:.1f} a step, {busy_us / steps:.1f} us a step)")
    return m


def phase_dl_autoencoder(h2o, dev, ofr, moved):
    """A DeepLearning autoencoder (hidden [200, 200], 1 epoch) on phase
    3g's frame: the moved rows reconstruct worse than the rest."""
    t0 = time.perf_counter()
    m = h2o.DeepLearning(autoencoder=True, epochs=1, seed=DL["seed"]).train(
        training_frame=ofr)
    torch.cuda.synchronize()
    metric("dl_autoencoder_train_s", time.perf_counter() - t0)
    err = m.anomaly(ofr).col("Reconstruction.MSE").data.cpu().numpy()
    hi, lo = float(err[moved].mean()), float(err[~moved].mean())
    print(f"autoencoder mean reconstruction MSE: moved rows {hi!r}, the "
          f"rest {lo!r}; training MSE {m._output.training_metrics.mse!r}")
    check(np.isfinite(err).all() and hi > lo,
          "moved rows do not reconstruct worse than the rest")
    df = m.deepfeatures(ofr, 1)
    check(df.ncols == 200 and df.nrows == ofr.nrows
          and df.names[0] == "DF.L2.C1",
          f"deepfeatures shape {df.nrows}x{df.ncols}")
    print(f"deepfeatures layer 2: {df.nrows}x{df.ncols}")


def _check_same_splits(label, fa, fb):
    """Two forests split alike: the node tables equal, and each
    categorical split sends the same levels left. The row numbers of the
    shared subset table may differ (a continued forest appends the new
    trees' subsets after the checkpoint's table, placeholder row
    included)."""
    for k in ("feat", "thresh_bin", "na_left", "left", "right"):
        check(np.array_equal(np.asarray(getattr(fa, k)),
                             np.asarray(getattr(fb, k))),
              f"{label}: forest {k} differs")
    ca, cb = np.asarray(fa.cat_split), np.asarray(fb.cat_split)
    check(np.array_equal(ca >= 0, cb >= 0), f"{label}: split kinds differ")
    ta, tb = np.asarray(fa.cat_table), np.asarray(fb.cat_table)
    w = min(ta.shape[1], tb.shape[1])
    check(np.array_equal(ta[ca[ca >= 0]][:, :w], tb[cb[cb >= 0]][:, :w]),
          f"{label}: a categorical split's levels differ")


def _forest_margin(m, fr):
    return m._margin(m.adapt_test(fr)).cpu().numpy()


def phase_framework(h2o, dev, fr, dl_model, tmp):
    """The model framework on the flagship: 5-fold CV of the flagship
    GBM, Platt and isotonic calibration on its last 200k rows (trained on
    the rest), a 10 + 10
    tree continuation against a fresh 20-tree train, a DeepLearning
    continuation, save/load, leaf assignment of the 1M rows, gains/lift
    and KS. Returns the kernel's launches per path."""
    import os

    from h2o3_tpu_torch.models.tree import hist_gather as hg

    launches = {}
    kw = dict(ntrees=FLAGSHIP["ntrees"], max_depth=FLAGSHIP["max_depth"])
    torch.cuda.synchronize()
    hg.launches = 0
    t0 = time.perf_counter()
    m = h2o.GBM(nfolds=FRAMEWORK["nfolds"], seed=1,
                keep_cross_validation_predictions=True, **kw).train(
        y="y", training_frame=fr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["gbm_cv"] = hg.launches
    out = m._output
    cvm, hp = out.cross_validation_metrics, out.cross_validation_holdout_predictions
    trains = FRAMEWORK["nfolds"] + 1
    metric("gbm_cv_train_s", dt, f"({trains} trains)")
    # phase 3y's sharded CV must equal this one bit for bit
    RUN["gbm_cv_train_s"] = dt
    RUN["cv_ref"] = {"forest": _digest(m), "folds": [
        _digest(f) for f in out.cross_validation_models],
        "auc": cvm.auc, "logloss": cvm.logloss,
        "fold_digest": out.fold_assignment_digest,
        "holdout": [_bytes_digest(hp[slice(*_blk(fr.nrows, r))])
                    for r in (0, 1)]}
    print(f"CV AUC {cvm.auc!r} logloss {cvm.logloss!r}, training AUC "
          f"{out.training_metrics.auc!r}; hist_gather launches "
          f"{launches['gbm_cv']}")
    check(launches["gbm_cv"] == trains * FLAGSHIP["ntrees"]
          * FLAGSHIP["max_depth"],
          f"{launches['gbm_cv']} launches for {trains} trains")
    check(hp.shape == (fr.nrows, 2)
          and np.allclose(hp.sum(axis=1), 1.0, atol=1e-5),
          "holdout predictions do not cover every row")
    check(cvm is not None and np.isfinite(cvm.auc) and cvm.auc > 0.5
          and len(out.cv_fold_metrics) == FRAMEWORK["nfolds"],
          "CV metrics missing")
    # the ensemble's path starts with its base GBM, the CV train above:
    # its count runs on through the GLM's CV and the stack, which launch
    # the kernel no more, so the path's count is the CV train's launches
    banner("phase 3p: StackedEnsemble (the CV GBM above and a GLM on the "
          "same folds)")
    phase_ensemble(h2o, dev, fr, m)
    launches["ensemble"] = hg.launches
    print(f"ensemble path: hist_gather launches {launches['ensemble']} "
          "(the base GBM's; the GLM and the stack add none)")
    check(launches["ensemble"] == launches["gbm_cv"] > 0,
          f"the ensemble's GLM or stack launched the kernel "
          f"{launches['ensemble'] - launches['gbm_cv']} times")
    # calibration: train on the first rows, calibrate on the last 200k
    from h2o3_tpu_torch.ops.filters import take_rows

    n_cal = FRAMEWORK["calibration_rows"]
    tr = take_rows(fr, np.arange(fr.nrows - n_cal))
    cal = take_rows(fr, np.arange(fr.nrows - n_cal, fr.nrows))
    hg.launches = 0
    for method in ("PlattScaling", "IsotonicRegression"):
        cm = h2o.GBM(calibrate_model=True, calibration_frame=cal,
                     calibration_method=method, **kw).train(
            y="y", training_frame=tr)
        pred = cm.predict(cal)
        p = pred.col("Y").data.cpu().numpy()
        pc = pred.col("cal_Y").data.cpu().numpy()
        check(np.isfinite(pc).all() and (pc >= 0).all() and (pc <= 1).all(),
              f"{method}: calibrated probabilities not in [0, 1]")
        o = np.argsort(p, kind="stable")
        check(bool((np.diff(pc[o]) >= -1e-6).all()),
              f"{method}: calibration is not monotone in p")
        kind, parms = cm._calibrator
        what = (f"a {parms[0]!r}, b {parms[1]!r}" if kind == "platt"
                else f"{len(parms[0])} knots")
        print(f"calibration {method} ({what}): mean p {p.mean():.6f}, "
              f"mean calibrated p {pc.mean():.6f}, observed "
              f"{float(cal.col('y').data.float().mean()):.6f}")
    launches["gbm_calibrated"] = hg.launches
    del tr, cal
    # 10 + 10 trees from a checkpoint against a fresh 20
    hg.launches = 0
    m10 = h2o.GBM(ntrees=10, max_depth=FLAGSHIP["max_depth"]).train(
        y="y", training_frame=fr)
    m20c = h2o.GBM(checkpoint=m10, **kw).train(y="y", training_frame=fr)
    launches["gbm_checkpoint"] = hg.launches
    m20 = h2o.GBM(**kw).train(y="y", training_frame=fr)
    _check_same_splits("checkpoint", m20.forest, m20c.forest)
    diff = float(np.abs(_forest_margin(m20, fr)
                        - _forest_margin(m20c, fr)).max())
    check(diff <= PRED_ATOL, f"checkpoint margins differ by {diff}")
    print(f"10 + 10 tree continuation == fresh 20-tree train: forest equal, "
          f"max margin diff {diff:.3e}; launches {launches['gbm_checkpoint']}")
    # DeepLearning continuing its epochs
    small = flagship_frame(h2o, dev, DL["small_rows"], seed=1)
    d1 = h2o.DeepLearning(epochs=1, seed=DL["seed"]).train(
        y="y", training_frame=small)
    d2 = h2o.DeepLearning(epochs=2, seed=DL["seed"], checkpoint=d1).train(
        y="y", training_frame=small)
    hist = [h["epoch"] for h in d2._output.scoring_history]
    check(d2.epochs_trained == 2 and hist == [2],
          f"DL continuation: {d2.epochs_trained} epochs, history {hist}")
    print(f"DL continuation 1 -> 2 epochs: training loss "
          f"{d1._output.scoring_history[-1]['training_loss']!r} -> "
          f"{d2._output.scoring_history[-1]['training_loss']!r}")
    # save/load
    for label, mod, col in (("GBM", m20, "Y"), ("DeepLearning", dl_model,
                                                "Y")):
        path = mod.save(os.path.join(tmp, f"{label}.bin"))
        back = h2o.load_model(path)
        pa = mod.predict(fr).col(col).data.cpu().numpy()
        pb = back.predict(fr).col(col).data.cpu().numpy()
        check(pa.tobytes() == pb.tobytes(), f"{label} save/load changed "
                                            "a prediction")
        print(f"{label} save/load ({os.path.getsize(path)} bytes): "
              f"{fr.nrows} predictions bitwise equal")
    # leaf assignment of the 1M rows, gains/lift and KS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    la = m20.predict_leaf_node_assignment(fr, type="Path")
    ln = m20.predict_leaf_node_assignment(fr, type="Node_ID")
    torch.cuda.synchronize()
    print(f"leaf_assignment_s {time.perf_counter() - t0!r} (Path and "
          f"Node_ID, {fr.nrows} rows x {la.ncols} trees)")
    check(la.ncols == ln.ncols == FLAGSHIP["ntrees"]
          and la.nrows == fr.nrows, "leaf assignment shape")
    leaf = m20.forest.leaf_index(m20.spec.bin_columns(
        m20.adapt_test(fr))).cpu().numpy()
    check(np.array_equal(ln.col("T1").to_numpy().astype(np.int64),
                         leaf[:, 0]), "Node_ID differs from the leaf walk")
    gl = m20.gains_lift()
    ks = m20.kolmogorov_smirnov()
    print(f"gains/lift {len(gl)} groups, top lift {float(gl.rows[0][4])!r}, "
          f"KS {ks!r}")
    check(len(gl) > 0 and 0 < ks <= 1, "gains/lift or KS missing")
    return launches


def phase_card_vs_cpu_framework(h2o, dev):
    """DeepLearning's draws, weights and predictions, and a GBM's
    cross-validation, on the card against the CPU."""
    import math

    from h2o3_tpu_torch import native
    from h2o3_tpu_torch.core import random as rnd
    from h2o3_tpu_torch.models import deeplearning as dl

    cpu = torch.device("cpu")
    c = DL_CPU
    steps = math.ceil(c["n_rows"] / c["batch"])
    sub, _ = native.split_chain(rnd.PRNGKey(c["seed"]), steps, 3)
    draws = []
    for d in (dev, cpu):
        rows = rnd.randint(sub[:, 0].to(d), (c["batch"],), 0, c["n_rows"])
        masks = dl.dropout_masks(sub[:, 1].to(d), c["batch"],
                                 [15] + c["hidden"], c["input_dropout"],
                                 c["hidden_dropout"])
        draws.append([rows.cpu()] + [m.cpu() for m in masks])
    check(all(torch.equal(a, b) for a, b in zip(*draws)),
          "DL batch rows or dropout masks differ between card and CPU")
    print(f"card vs cpu DL draws of {steps} steps: batch rows and "
          f"{len(draws[0]) - 1} dropout masks bitwise equal")
    models, preds = [], []
    for d in (dev, cpu):
        fr = flagship_frame(h2o, d, c["n_rows"], seed=3)
        m = h2o.DeepLearning(
            hidden=c["hidden"], epochs=c["epochs"], seed=c["seed"],
            mini_batch_size=c["batch"], activation="RectifierWithDropout",
            input_dropout_ratio=c["input_dropout"],
            hidden_dropout_ratios=c["hidden_dropout"]).train(
            y="y", training_frame=fr)
        models.append(_dl_weights(m))
        preds.append(m.predict(fr).col("Y").data.cpu().numpy())
    wdiff = max(float(np.abs(a - b).max()) for a, b in zip(*models))
    pdiff = float(np.abs(preds[0] - preds[1]).max())
    print(f"card vs cpu DL {c['n_rows']} rows, hidden {c['hidden']}, "
          f"{c['epochs']} epochs ({c['epochs'] * steps} steps): max weight "
          f"diff {wdiff:.3e}, max pred diff {pdiff:.3e} (bar "
          f"{DL_CARD_CPU_ATOL})")
    check(wdiff <= DL_CARD_CPU_ATOL and pdiff <= DL_CARD_CPU_ATOL,
          f"DL card vs CPU: weights differ by {wdiff}, predictions by "
          f"{pdiff}")
    cv = []
    for d in (dev, cpu):
        fr = flagship_frame(h2o, d, 50_000)
        cv.append(h2o.GBM(ntrees=5, max_depth=FLAGSHIP["max_depth"],
                          nfolds=3, seed=1,
                          keep_cross_validation_predictions=True).train(
            y="y", training_frame=fr)._output)
    a, b = cv
    check(a.fold_assignment_digest == b.fold_assignment_digest,
          "CV fold assignments differ between card and CPU")
    for ma, mb in zip(a.cross_validation_models, b.cross_validation_models):
        fa, fb = _forest_arrays(ma), _forest_arrays(mb)
        for k in fa:
            check(np.array_equal(fa[k], fb[k]),
                  f"CV fold model {k} differs between card and CPU")
    hdiff = float(np.abs(a.cross_validation_holdout_predictions
                         - b.cross_validation_holdout_predictions).max())
    mdiff = max(abs(getattr(a.cross_validation_metrics, k)
                    - getattr(b.cross_validation_metrics, k))
                for k in ("auc", "logloss", "rmse"))
    check(hdiff <= PRED_ATOL and mdiff <= PRED_ATOL,
          f"CV card vs CPU: holdout predictions differ by {hdiff}, "
          f"metrics by {mdiff}")
    print(f"card vs cpu GBM 3-fold CV 50k flagship rows: fold assignment "
          f"and fold forests equal, max holdout pred diff {hdiff:.3e}, max "
          f"CV metric diff {mdiff:.3e}")


# ---------------------------------------------------------------------------
# Rapids and the frame ops (phase 3o; phase 4's card-vs-CPU checks)
# ---------------------------------------------------------------------------

def rapids_arrays(n_rows, seed=4):
    """run_rapids' columns (h2o3_tpu/bench.py:264-271): a standard normal
    with 2% of the rows NA, b standard normal, c uniform in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n_rows)
    a[rng.integers(0, n_rows, n_rows // 50)] = np.nan
    b = rng.standard_normal(n_rows)
    c = rng.uniform(0.5, 2.0, n_rows)
    return a, b, c


def rapids_frame(h2o, device, key, n_rows, seed=4):
    fr = h2o.Frame(key=key)
    for name, v in zip("abc", rapids_arrays(n_rows, seed)):
        fr.add(name, h2o.Column.from_numpy(v, device=device))
    fr.install()
    return fr


def rapids_statements(key):
    """run_rapids' three statements (h2o3_tpu/bench.py:276-297)."""
    A, B, C = (f"(cols {key} [{i}])" for i in range(3))
    clip = f"(ifelse (> {A} 2) 2 (ifelse (< {A} -2) -2 {A}))"
    flags = (f"(& (| (> {B} 0.25) (< {C} 1)) "
             f"(& (== (is.na {A}) 0) (>= {B} -3)))")
    binned = (f"(ifelse (< {A} -1) 0 (ifelse (< {A} 0) 1 "
              f"(ifelse (< {A} 1) 2 (ifelse (< {A} 2) 3 4))))")
    return [f"(ifelse {flags} (+ {clip} {binned}) (- {binned} {clip}))",
            f"(- (+ (abs (- (* {A} 0.5) {C})) (* {B} 0.25)) (* {A} 0.125))",
            f"(sum (ifelse (> (+ {A} {B}) 0) (- {C} 0.5) (+ {C} 0.5)))"]


def _f32(v):
    return np.float32(v)


def _np_cmp(op, x, y):
    """H2O's comparison on float32 host arrays: NA on either side is NA."""
    r = op(x, y).astype(np.float32)
    return np.where(np.isnan(x) | np.isnan(y), _f32(np.nan), r)


def _np_ifelse(c, yes, no):
    return np.where(np.isnan(c), _f32(np.nan),
                    np.where(c != 0, yes, no)).astype(np.float32)


def _np_and(x, y):
    na = np.isnan(x) | np.isnan(y)
    return np.where((x == 0) | (y == 0), _f32(0),
                    np.where(na, _f32(np.nan), _f32(1)))


def _np_or(x, y):
    hit = ((x != 0) & ~np.isnan(x)) | ((y != 0) & ~np.isnan(y))
    return np.where(hit, _f32(1), np.where(np.isnan(x) | np.isnan(y),
                                           _f32(np.nan), _f32(0)))


def rapids_numpy(a, b, c):
    """The three statements evaluated in numpy float32 on the host, one
    float32 operation per prim, with H2O's NA semantics; the third as a
    float64 sum."""
    import operator as o

    A, B, C = (np.asarray(v, np.float64).astype(np.float32)
               for v in (a, b, c))
    clip = _np_ifelse(_np_cmp(o.gt, A, _f32(2)), _f32(2),
                      _np_ifelse(_np_cmp(o.lt, A, _f32(-2)), _f32(-2), A))
    isna = np.where(np.isnan(A), _f32(1), _f32(0))
    flags = _np_and(_np_or(_np_cmp(o.gt, B, _f32(0.25)),
                           _np_cmp(o.lt, C, _f32(1))),
                    _np_and(_np_cmp(o.eq, isna, _f32(0)),
                            _np_cmp(o.ge, B, _f32(-3))))
    binned = _f32(4)
    for cut in (2, 1, 0, -1):              # the innermost ifelse first
        binned = _np_ifelse(_np_cmp(o.lt, A, _f32(cut)), _f32(cut + 1),
                            binned)
    s1 = _np_ifelse(flags, clip + binned, binned - clip)
    s2 = (np.abs(A * _f32(0.5) - C) + B * _f32(0.25)) - A * _f32(0.125)
    s3 = _np_ifelse(_np_cmp(o.gt, A + B, _f32(0)), C - _f32(0.5),
                    C + _f32(0.5))
    return s1, s2, float(np.nansum(s3.astype(np.float64)))


def _host_bits_equal(t, want) -> bool:
    return same_bits(t.cpu(), torch.from_numpy(
        np.ascontiguousarray(want, np.float32)))


def _verify_recipe(h2o, tmp):
    """The H2OFrame surface of the repository's verify recipe on the
    card: a CSV written here, imported; no as_data_frame (the card's
    machine has no pandas)."""
    import os

    path = os.path.join(tmp, "recipe.csv")
    with open(path, "w") as f:
        f.write("g,x\n")
        f.writelines(f"g{i % 3},{i}\n" for i in range(1000))
    fr = h2o.import_file(path)
    check(isinstance(fr, h2o.H2OFrame) and h2o.DKV.get(fr.key) is fr,
          "import_file did not install an H2OFrame")
    check(fr.col("x").data.device == h2o.cluster().device,
          "imported columns not on the booted device")
    mean, med = fr["x"].mean(), fr["x"].median()
    check(mean == 499.5 and med == 499.5, f"mean {mean}, median {med}")
    gb = fr.group_by("g").count().mean("x").get_frame()
    check(list(gb.col("g").values()) == ["g0", "g1", "g2"]
          and gb.col("nrow").to_numpy().tolist() == [334, 333, 333]
          and gb.col("mean_x").to_numpy().tolist() == [499.5, 499.0, 500.0],
          "group_by count/mean wrong")
    tr, te = fr.split_frame([0.8], seed=1)
    n_tr = int((np.random.default_rng(1).random(1000) < 0.8).sum())
    check(tr.nrows == n_tr and te.nrows == 1000 - n_tr,
          f"split_frame sizes {tr.nrows}/{te.nrows}, expected {n_tr}")
    pos = fr[fr["x"] > 0]
    check(pos.nrows == 999 and pos["x"].min() == 1.0, "fr[fr['x'] > 0]")
    print(f"verify recipe: mean {mean!r} median {med!r}, 3 groups, split "
          f"{tr.nrows}/{te.nrows}, filter {pos.nrows} rows")


def phase_rapids(h2o, dev, tmp):
    """Rapids and the frame ops on the card: run_rapids' statements (eager
    rows/s, the device-busy share of one pass, device ops per
    statement), the sort, the dryrun's joins, a group-by of the flagship
    frame and the verify recipe. Returns the histogram kernel's launches
    over the phase (none: this path runs no kernel)."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from h2o3_tpu_torch.rapids import fusion, planner

    hg.launches = 0
    # the eager evaluator, as this phase has measured it since PR 9 (the
    # fused and lazy paths are phase 3t's)
    with fusion.force(False), planner.force(False):
        _phase_rapids_eager(h2o, dev, tmp)
    launches = hg.launches
    check(launches == 0, f"the frame ops launched hist_gather {launches} "
                         "times")
    return launches


def _phase_rapids_eager(h2o, dev, tmp):
    from h2o3_tpu_torch.ops.groupby import GroupBy
    from h2o3_tpu_torch.ops.merge import merge
    from h2o3_tpu_torch.ops.sort import sort_frame, sort_order

    n, reps = RAPIDS["n_rows"], RAPIDS["reps"]
    a, b, c = rapids_arrays(n, RAPIDS["seed"])
    fr = rapids_frame(h2o, dev, "rapids_bench", n, RAPIDS["seed"])
    stmts = rapids_statements("rapids_bench")
    sess = h2o.Session("bench")

    def run_pass():
        out = [h2o.exec_rapids(st, sess) for st in stmts]
        torch.cuda.synchronize()
        return out

    got = run_pass()                                      # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        run_pass()
    dt = time.perf_counter() - t0
    metric("rapids_eager_rows_per_sec", n * len(stmts) * reps / dt,
           f"({reps} passes of 3 statements over {n} rows in {dt!r} s)")
    s1, s2, s3 = rapids_numpy(a, b, c)
    check(_host_bits_equal(got[0].col(0).data, s1),
          "statement 1 differs from numpy float32")
    check(_host_bits_equal(got[1].col(0).data, s2),
          "statement 2 differs from numpy float32")
    rel = abs(got[2] - s3) / abs(s3)
    check(rel <= 1e-5, f"statement 3 sum {got[2]!r} vs {s3!r} ({rel:.2e})")
    print(f"statements 1, 2 bitwise equal to numpy float32; statement 3 "
          f"sum {got[2]!r} vs float64 {s3!r} (rel {rel:.2e})")
    for i, st in enumerate(stmts):
        t0 = time.perf_counter()
        for _ in range(reps):
            h2o.exec_rapids(st, sess)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
        busy, ops = device_time(
            lambda: [h2o.exec_rapids(st, sess) for _ in range(reps)])
        print(f"statement {i + 1}: wall {wall * 1e3:.3f} ms, {ops / reps} "
              f"device ops and {busy / reps / 1e3:.3f} ms device time a "
              f"run (mean of {reps})")
    phase_profile("one eager Rapids pass (3 statements, 2M rows)", run_pass)

    sort_frame(fr, ["a"])
    torch.cuda.synchronize()
    sort_reps = max(reps // 2, 2)
    t0 = time.perf_counter()
    for _ in range(sort_reps):
        srt = sort_frame(fr, ["a"])
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    metric("rapids_sort_rows_per_sec", n * sort_reps / dt,
           f"({sort_reps} sorts of {n} rows in {dt!r} s)")
    a32 = a.astype(np.float32)
    want = np.argsort(np.where(np.isnan(a32), np.inf, a32), kind="stable")
    perm = sort_order(fr, ["a"], [True]).cpu().numpy()
    check(np.array_equal(perm, want), "sort permutation differs from "
                                      "numpy's stable argsort")
    check(_host_bits_equal(srt.col("a").data, a32[want]),
          "sorted column differs")
    print("sort permutation bitwise equal to numpy's stable argsort of "
          "where(isnan, inf, a)")

    nl, nr = RAPIDS["join_rows"], RAPIDS["join_right"]
    rng = np.random.default_rng(RAPIDS["seed"])
    x1 = rng.standard_normal(nl)
    lk = (np.arange(nl) % 16).astype(np.float64)
    lfr = h2o.Frame.from_numpy(np.stack([lk, x1], 1), names=["id", "a"],
                               device=dev)
    rfr = h2o.Frame.from_numpy(np.stack([np.arange(16.0),
                                         np.arange(16.0) * 3.0], 1),
                               names=["id", "b"], device=dev)
    rk = rng.permutation(nr).astype(np.float64)
    mk = rng.integers(0, nr, nl).astype(np.float64)
    mlf = h2o.Frame.from_numpy(np.stack([mk, np.arange(nl, dtype=float)], 1),
                               names=["k", "lv"], device=dev)
    mrf = h2o.Frame.from_numpy(np.stack([rk, 2 * rk + 1], 1),
                               names=["k", "rv"], device=dev)
    merge(lfr, rfr), merge(mlf, mrf)                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    j1 = merge(lfr, rfr)
    j2 = merge(mlf, mrf)
    torch.cuda.synchronize()
    metric("merge_s", time.perf_counter() - t0,
           f"(the dryrun's {nl} x 16 join and a {nl} x {nr} many-to-one "
           "join)")
    check(j1.nrows == nl and j2.nrows == nl, "join row counts")
    check(_host_bits_equal(j1.col("b").data, lk * 3), "dryrun join: b != "
                                                      "3 id")
    check(_host_bits_equal(j1.col("id").data, lk)
          and _host_bits_equal(j1.col("a").data, x1),
          "dryrun join: pairs not in the left rows' order")
    check(_host_bits_equal(j2.col("lv").data, np.arange(nl))
          and _host_bits_equal(j2.col("rv").data, 2 * mk + 1),
          "many-to-one join: pairs differ from the host reference")
    print(f"joins: {j1.nrows} and {j2.nrows} rows, pairs in the host "
          "reference's order")

    ffr = flagship_frame(h2o, dev, FLAGSHIP["n_rows"])

    def groupby():
        out = GroupBy(ffr, ["c0", "c1"]).count().mean("n0").sd("n0") \
            .get_frame()
        torch.cuda.synchronize()
        return out

    groupby()
    t0 = time.perf_counter()
    g = groupby()
    metric("groupby_s", time.perf_counter() - t0,
           f"({FLAGSHIP['n_rows']} rows by c0 x c1: count, mean, sd)")
    cols = flagship_arrays(FLAGSHIP["n_rows"])
    code = (np.searchsorted(["a", "b", "c", "d"], cols["c0"][0]) * 3
            + np.searchsorted(["x", "y", "z"], cols["c1"][0]))
    x = cols["n0"][0].astype(np.float32).astype(np.float64)
    cnt = np.bincount(code, minlength=12)
    mean = np.bincount(code, x, 12) / cnt
    sd = np.sqrt((np.bincount(code, x * x, 12) - cnt * mean ** 2)
                 / (cnt - 1))
    check(np.array_equal(g.col("nrow").to_numpy(), cnt.astype(np.float32)),
          "group counts differ")
    dm = float(np.abs(g.col("mean_n0").to_numpy() - mean).max())
    ds = float(np.abs(g.col("sd_n0").to_numpy() / sd - 1).max())
    check(dm <= 1e-5 and ds <= 1e-5, f"group means {dm:.2e}, sds {ds:.2e} "
                                     "off numpy float64")
    again = groupby()
    check(all(same_bits(g.col(nm).data.cpu(), again.col(nm).data.cpu())
              for nm in ("nrow", "mean_n0", "sd_n0")),
          "group-by rerun differs")
    print(f"group-by: 12 groups, counts exact, means within {dm:.2e} and "
          f"sds within {ds:.2e} (relative) of numpy float64, rerun bitwise")
    _verify_recipe(h2o, tmp)
    sess.end()
    h2o.DKV.clear()


# ---------------------------------------------------------------------------
# statement fusion, lazy sessions and the pipeline (phase 3t; phase 4)
# ---------------------------------------------------------------------------

def chain_statements(key):
    """run_rapids' chained session (h2o3_tpu/bench.py:357-367)."""
    A, B, C = (f"(cols {key} [{i}])" for i in range(3))
    clip = f"(ifelse (> {A} 2) 2 (ifelse (< {A} -2) -2 {A}))"
    flags = (f"(& (| (> {B} 0.25) (< {C} 1)) "
             f"(& (== (is.na {A}) 0) (>= {B} -3)))")
    binned = (f"(ifelse (< {A} -1) 0 (ifelse (< {A} 0) 1 "
              f"(ifelse (< {A} 1) 2 (ifelse (< {A} 2) 3 4))))")
    return [f"(tmp= rb_clip {clip})", f"(tmp= rb_flags {flags})",
            f"(tmp= rb_bin {binned})", f"(tmp= rb_bin2 {binned})",
            "(tmp= rb_t (* rb_clip 2))", "(tmp= rb_t (+ rb_clip rb_bin))",
            "(tmp= rb_out (ifelse rb_flags rb_t (- rb_bin2 rb_clip)))",
            "(rm rb_clip)", "(rm rb_flags)", "(rm rb_t)"]


def chain_pass(h2o, key, sess):
    """One chained session: the statements, the observation of rb_out
    (its tensor), then the temps removed."""
    for st in chain_statements(key):
        h2o.exec_rapids(st, sess)
    out = h2o.exec_rapids("rb_out", sess).col(0).data
    for k in ("rb_out", "rb_bin", "rb_bin2"):
        h2o.exec_rapids(f"(rm {k})", sess)
    return out


def pipe_train_frame(h2o, device, n, seed=7):
    """run_pipeline's training frame: x1, x2 and y on the engineered
    names; returns (frame, the generator, continued for the raw rows)."""
    rng = np.random.default_rng(seed)
    x1, x2 = rng.standard_normal(n), rng.standard_normal(n)
    logit = 0.8 * x1 - 0.6 * x2
    fr = h2o.Frame()
    fr.add("x1", h2o.Column.from_numpy(x1, device=device))
    fr.add("x2", h2o.Column.from_numpy(x2, device=device))
    fr.add("y", h2o.Column.from_numpy(
        np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "Y", "N"),
        ctype="enum", device=device))
    return fr, rng


def pipe_raw_frame(h2o, device, key, n, rng):
    """run_pipeline's raw rows: r1 with every 97th row NA, r2."""
    r1 = rng.standard_normal(n)
    r1[::97] = np.nan
    r2 = rng.standard_normal(n)
    fr = h2o.Frame(key=key)
    fr.add("r1", h2o.Column.from_numpy(r1, device=device))
    fr.add("r2", h2o.Column.from_numpy(r2, device=device))
    fr.install()
    return fr, r1, r2


class _Engineer:
    """run_pipeline's feature chain with fresh temps every call."""

    def __init__(self, h2o, sess, rawkey, prefix="pb"):
        self.h2o, self.sess, self.raw, self.p = h2o, sess, rawkey, prefix
        self.seq = 0

    def __call__(self):
        self.seq += 1
        p, R1, R2 = (f"{self.p}{self.seq}", f"(cols {self.raw} [0])",
                     f"(cols {self.raw} [1])")
        ex = self.h2o.exec_rapids
        ex(f"(tmp= {p}_a (+ {R1} 0.5))", self.sess)
        ex(f"(tmp= {p}_b (ifelse (> {R2} 0) {R2} {p}_a))", self.sess)
        return ex(f'(tmp= {p}_pf (colnames= (cbind {p}_a {p}_b) [0 1] '
                  f'["x1" "x2"]))', self.sess)


def _fused_statements(h2o, dev, sess, key, reps):
    """run_rapids' per-statement A/B: (eager results, fused results,
    eager seconds, fused seconds) over `reps` timed passes each."""
    from h2o3_tpu_torch.rapids import fusion, planner

    stmts = rapids_statements(key)

    def run_pass():
        out = [h2o.exec_rapids(st, sess) for st in stmts]
        torch.cuda.synchronize()
        return out

    def timed(on):
        with fusion.force(on), planner.force(on):
            got = run_pass()                # warm (captures excluded)
            t0 = time.perf_counter()
            for _ in range(reps):
                run_pass()
            return got, time.perf_counter() - t0, run_pass

    return timed(False), timed(True)


def phase_fusion(h2o, dev, tmp):
    """Phase 3t: run_rapids' statements fused against eager on its 2M-row
    frame, its chained session lazy against eager on 4M rows, and
    run_pipeline's munge→score splice against the staged path, with a
    pipeline artifact scored by the runner in a fresh process. Returns
    (the histogram kernel's launches, the pipeline's GBM, the three
    fused statements' results)."""
    import os

    from h2o3_tpu_torch import artifact, pipeline, scoring
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from h2o3_tpu_torch.rapids import fusion, planner

    c = FUSION
    n, reps = RAPIDS["n_rows"], RAPIDS["reps"]
    rapids_frame(h2o, dev, "rapids_fused", n, RAPIDS["seed"])
    sess = h2o.Session("fused")
    fusion.reset_counters()
    (eager, dt_e, pass_e), (fused, dt_f, pass_f) = _fused_statements(
        h2o, dev, sess, "rapids_fused", reps)
    fc = fusion.counters()
    rows = n * 3 * reps
    metric("rapids_fused_rows_per_sec", rows / dt_f,
           f"({reps} passes of 3 statements over {n} rows in {dt_f!r} s)")
    metric("rapids_fused_vs_eager", dt_e / dt_f,
           f"(eager {rows / dt_e!r} rows/s in the same call)")
    for i in (0, 1):
        check(same_bits(fused[i].col(0).data, eager[i].col(0).data),
              f"fused statement {i + 1} differs from eager")
    check(fused[2] == eager[2], f"fused statement 3 sum {fused[2]!r} vs "
                                f"eager {eager[2]!r}")
    print(f"fused statements 1, 2 and the sum {fused[2]!r} bitwise equal "
          f"to eager; {fc['captures']} captures and "
          f"{fc['fused_programs_compiled']} programs built over "
          f"{reps + 1} passes, {fc['fused_programs']} program runs")
    for label, run in (("eager", pass_e), ("fused", pass_f)):
        mode = label == "fused"
        with fusion.force(mode), planner.force(mode):
            _, wall = _timed(run)
            c0 = fusion.counters()["captures"]
            busy, ops = device_time(run)
            caps = fusion.counters()["captures"] - c0
        print(f"one {label} pass (3 statements, {n} rows): wall "
              f"{wall * 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms = "
              f"{100 * busy / 1e3 / (wall * 1e3):.1f}%, {ops} device ops, "
              f"{caps} captures")
    with fusion.force(True), planner.force(True):
        phase_profile("one fused Rapids pass (3 statements, 2M rows)",
                      pass_f)
    sess.end()

    # run_rapids' chained session, interleaved A/B
    nc = c["chain_rows"]
    rapids_frame(h2o, dev, "rapids_chain", nc, RAPIDS["seed"] + 1)
    csess = h2o.Session("bench_chain")

    def chain_once(lazy):
        with planner.force(lazy), fusion.force(lazy):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = chain_pass(h2o, "rapids_chain", csess)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

    ref, _ = chain_once(False)
    got, _ = chain_once(True)                  # warm both modes
    check(same_bits(got, ref), "lazy rb_out differs from eager")
    dt_e = dt_l = 0.0
    planner.reset_counters()
    for _ in range(c["chain_reps"]):
        dt_e += chain_once(False)[1]
        out, dt = chain_once(True)
        dt_l += dt
        check(same_bits(out, ref), "lazy rb_out differs from eager")
    lz = planner.counters()
    chain_rows = nc * 7 * c["chain_reps"]
    metric("rapids_chained_rows_per_sec", chain_rows / dt_l,
           f"({c['chain_reps']} lazy passes of 7 statements over {nc} rows "
           f"in {dt_l!r} s)")
    metric("rapids_chained_vs_eager", dt_e / dt_l,
           f"(eager {dt_e!r} s in the same call)")
    metric("rapids_cse_hits", lz["cse_hits"])
    metric("rapids_dead_temps", lz["dead_temps_eliminated"])
    for k, per in c["ref_per_pass"].items():
        check(lz[k] == per * c["chain_reps"],
              f"planner {k}: {lz[k]} over {c['chain_reps']} passes, the "
              f"JAX package counts {per} a pass")
    print(f"chained session: rb_out bitwise equal to eager every pass; "
          f"per pass {json.dumps(c['ref_per_pass'])} as the JAX package")
    csess.end()
    h2o.DKV.clear()

    # run_pipeline: raw rows through a lazy feature chain into a GBM
    hg.launches = 0
    tr, rng = pipe_train_frame(h2o, dev, c["pipe_train"])
    model = h2o.GBM(ntrees=c["pipe_ntrees"], max_depth=c["pipe_depth"],
                    seed=7).train(y="y", training_frame=tr)
    launches = hg.launches
    check(launches > 0, "the pipeline's GBM launched no hist_gather")
    ssn = scoring.session_for(model)
    raw, _r1, _r2 = pipe_raw_frame(h2o, dev, "pipe_bench_raw",
                                   c["pipe_rows"], rng)
    psess = h2o.Session("bench_pipe")
    engineer = _Engineer(h2o, psess, "pipe_bench_raw")

    def timed(on):
        with planner.force(True), fusion.force(True), pipeline.force(on):
            ssn.predict(engineer())            # warm (captures excluded)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(c["pipe_reps"]):
                ssn.predict(engineer()).col(0).data
            torch.cuda.synchronize()
            return time.perf_counter() - t0

    dt_s = timed(False)
    pipeline.reset_counters()
    dt_p = timed(True)
    pc = pipeline.counters()
    prow = c["pipe_rows"] * c["pipe_reps"]
    metric("pipeline_rows_per_sec", prow / dt_p,
           f"({c['pipe_reps']} requests of {c['pipe_rows']} raw rows)")
    metric("pipeline_staged_rows_per_sec", prow / dt_s)
    metric("pipeline_vs_staged", dt_s / dt_p)
    metric("pipeline_materialized_columns", pc["materialized_columns"],
           f"({pc['fused_dispatches']} pipeline dispatches, "
           f"{pc['captures']} captures)")
    check(pc["materialized_columns"] == 0 and pc["fallbacks"] == 0,
          f"the pipeline made engineered columns: {pc}")
    with planner.force(True), fusion.force(True), pipeline.force(True):
        pf = engineer()
        cap = pipeline.try_capture(ssn, pf)
        check(cap is not None, "the engineered frame did not capture")
        mg, _ = pipeline.execute_margins(ssn, cap)
        staged = _margins_of(ssn, pf)          # flushes, then stages
    _same_bits("pipeline margins vs staged", mg, staged)
    big, _, _ = pipe_raw_frame(h2o, dev, "pipe_raw_1m", c["pipe_1m"], rng)
    big_eng = _Engineer(h2o, psess, "pipe_raw_1m", prefix="pm")
    with planner.force(True), fusion.force(True), pipeline.force(True):
        ssn.predict(big_eng())                 # warm the tail's bucket
        pf = big_eng()
        out, t_1m = _timed(lambda: ssn.predict(pf).col(0).data)
    metric("pipeline_1m_s", t_1m, f"({c['pipe_1m']} raw rows, one request)")
    with pipeline.force(False):
        ref = ssn.predict(pf).col(0).data
    _same_bits("pipeline 1M-row request vs staged", out, ref)

    # the pipeline artifact, scored from raw rows in a fresh process
    m = c["artifact_rows"]
    sub, r1, r2 = pipe_raw_frame(h2o, dev, "pipe_raw_art", m, rng)
    with planner.force(True), fusion.force(True), pipeline.force(True):
        pf = _Engineer(h2o, psess, "pipe_raw_art", prefix="pa")()
        art = os.path.join(tmp, "pipeline_artifact")
        man = artifact.export_pipeline(model, pf, art, buckets=[m])
        cap = pipeline.try_capture(ssn, pf)
        want, _ = pipeline.execute_margins(ssn, cap)
    check(man["model_type"] == "pipeline" and
          sorted(man["names"]) == ["r1", "r2"], "pipeline manifest")
    csv_path = os.path.join(tmp, "pipe_raw.csv")
    with open(csv_path, "w") as f:
        f.write("r1,r2\n")
        for a, b in zip(r1.astype(np.float32), r2.astype(np.float32)):
            f.write(f"{'' if np.isnan(a) else repr(float(a))},"
                    f"{float(b)!r}\n")
    runner = Path(__file__).resolve().parent / "h2o3_tpu_torch" / \
        "artifact" / "runner.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc, t_run = _timed(lambda: subprocess.run(
        [sys.executable, str(runner), "--artifact", art, "--input",
         csv_path, "--output", os.path.join(tmp, "pipe_out.csv"),
         "--raw-npz", os.path.join(tmp, "pipe_raw.npz"), "--device",
         dev.type], capture_output=True, text=True, timeout=300, cwd=tmp,
        env=env))
    check(proc.returncode == 0, f"pipeline runner failed: "
                                f"{proc.stderr[-3000:]}")
    with np.load(os.path.join(tmp, "pipe_raw.npz")) as z:
        _same_bits("pipeline artifact runner margins (card) vs in-process",
                   torch.from_numpy(z["margins"]), want.cpu())
    print(f"pipeline artifact: {man['programs'][0]['bytes']} program "
          f"bytes, the runner scored {m} raw rows bitwise in a fresh "
          f"process ({t_run:.2f} s from spawn to exit)")
    psess.end()
    return launches, model, [fused[0].col(0).data.clone(),
                             fused[1].col(0).data.clone(), fused[2]]


def phase_card_vs_cpu_fusion(h2o, dev, model):
    """Fused statements, the lazy chained session and pipeline margins on
    FUSION['cvc_rows'] rows on the card and on the CPU: bit for bit (the
    statement sum to 1e-6, its float32 order differs), the pipeline's
    probabilities to C29's 1e-6."""
    from h2o3_tpu_torch import pipeline, scoring
    from h2o3_tpu_torch.rapids import fusion, planner

    n = FUSION["cvc_rows"]
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        key = f"fusion_cvc_{name}"
        rapids_frame(h2o, d, key, n, RAPIDS["seed"])
        sess = h2o.Session(key)
        with fusion.force(True), planner.force(True):
            stmt = [h2o.exec_rapids(st, sess)
                    for st in rapids_statements(key)]
            chain = chain_pass(h2o, key, sess)
        sess.end()
        if name == "cpu":
            h2o.init(device="cpu")
        try:
            pipe_raw_frame(h2o, d, f"pipe_cvc_{name}", n,
                           np.random.default_rng(11))
            psess = h2o.Session(f"pipe_{name}")
            ssn = scoring.ScoringSession(model)
            with fusion.force(True), planner.force(True), \
                    pipeline.force(True):
                pf = _Engineer(h2o, psess, f"pipe_cvc_{name}")()
                cap = pipeline.try_capture(ssn, pf)
                check(cap is not None, f"no capture on the {name}")
                mg, _ = pipeline.execute_margins(ssn, cap)
            psess.end()
        finally:
            h2o.init()
        res[name] = (stmt, chain.cpu(), mg.cpu(),
                     model._margin_to_raw(mg.cpu())["probs"])
    (cs, cc, cm, cp), (hs, hc, hm, hp) = res["card"], res["cpu"]
    for i in (0, 1):
        check(same_bits(cs[i].col(0).data.cpu(), hs[i].col(0).data),
              f"card vs CPU: fused statement {i + 1} differs")
    rel = abs(cs[2] - hs[2]) / abs(hs[2])
    check(rel <= 1e-6, f"card vs CPU: fused statement 3 sum off by {rel}")
    check(same_bits(cc, hc), "card vs CPU: lazy rb_out differs")
    check(same_bits(cm, hm), "card vs CPU: pipeline margins differ")
    gap = float((cp - hp).abs().max())
    check(gap <= PDP_CVC_ATOL, f"card vs CPU: pipeline probabilities {gap}")
    print(f"card vs cpu fusion ({n} rows): fused statements 1-2, the lazy "
          f"chained session and pipeline margins bitwise; statement 3 sum "
          f"rel {rel:.2e}; pipeline probabilities within {gap:.3e}")
    h2o.DKV.clear()


def _cvc_close(label, card, cpu, rtol, scale):
    """|card - cpu| <= rtol * max(|cpu|, scale), with NaN and inf where
    the CPU has them; returns the worst scaled difference."""
    a = card.cpu().double().numpy()
    b = cpu.double().numpy()
    fin = np.isfinite(a) & np.isfinite(b)
    err = np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), scale)
    worst = float(err.max()) if err.size else 0.0
    same = (np.array_equal(np.isnan(a), np.isnan(b))
            and np.array_equal(a[np.isinf(a)], b[np.isinf(b)]))
    check(same and worst <= rtol,
          f"card vs CPU {label}: {worst:.2e} > {rtol} or NaN/inf differ")
    return worst


def phase_card_vs_cpu_rapids(h2o, dev):
    """The statements, sorts, joins, group-bys and window ops on 100k
    rows on the card and on the CPU: arithmetic, comparison and ifelse
    results, permutations, join pairs, group counts, sums and levels,
    ranks and difflag1 bit for bit; the libm prims and cumsum/cumprod
    within the stated bounds."""
    from h2o3_tpu_torch.ops.groupby import GroupBy
    from h2o3_tpu_torch.ops.merge import merge
    from h2o3_tpu_torch.ops.sort import sort_order

    n = RAPIDS["cpu_rows"]
    unary = ["exp", "log", "sqrt", "sin", "cos", "tan", "tanh", "log1p",
             "expm1", "asinh", "cospi"]
    gamma = ["lgamma", "digamma", "trigamma"]
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        key = f"rapids_cvc_{name}"
        fr = rapids_frame(h2o, d, key, n, RAPIDS["seed"])
        sess = h2o.Session(key)
        r = {"stmt": [h2o.exec_rapids(st, sess)
                      for st in rapids_statements(key)]}
        for op in unary + gamma:
            r[op] = h2o.exec_rapids(f"({op} (cols {key} [0]))", sess)
        r["pow"] = h2o.exec_rapids(f"(^ (cols {key} [2]) (cols {key} [1]))",
                                   sess)
        for op in ("cumsum", "cumprod", "cummin", "cummax"):
            r[op] = h2o.exec_rapids(f"({op} (cols {key} [2]) 0)", sess)
        r["perm"] = sort_order(fr, ["a"], [True])
        r["perm2"] = sort_order(fr, ["b", "a"], [False, True])
        rng = np.random.default_rng(5)
        lf = h2o.Frame.from_numpy(np.stack([
            rng.integers(0, 20_000, n).astype(float),
            np.arange(n, dtype=float)], 1), names=["k", "lv"], device=d)
        rf = h2o.Frame.from_numpy(np.stack([
            rng.integers(0, 25_000, 20_000).astype(float),
            np.arange(20_000, dtype=float)], 1), names=["k", "rv"], device=d)
        r["inner"] = merge(lf, rf)
        r["full"] = merge(lf, rf, all_x=True, all_y=True)
        ffr = flagship_frame(h2o, d, n)
        ffr.install()
        r["groups"] = GroupBy(ffr, ["c0", "c1"]).count().sum("n0") \
            .mean("n0").sd("n0").min("n1").max("n1").get_frame()
        r["rank"] = h2o.exec_rapids(
            f'(rank_within_groupby {ffr.key} [8 9] [0] [1] "r" 0)', sess)
        r["diff"] = h2o.exec_rapids(f"(difflag1 (cols {key} [0]))", sess)
        res[name] = r
        sess.end()
    card, cpu = res["card"], res["cpu"]
    for i in (0, 1):
        check(same_bits(card["stmt"][i].col(0).data.cpu(),
                        cpu["stmt"][i].col(0).data),
              f"card vs CPU: statement {i + 1} differs")
    rel3 = abs(card["stmt"][2] - cpu["stmt"][2]) / abs(cpu["stmt"][2])
    check(rel3 <= 1e-6, f"card vs CPU: statement 3 sum off by {rel3:.2e}")
    for op in ("cummin", "cummax"):
        check(same_bits(card[op].col(0).data.cpu(), cpu[op].col(0).data),
              f"card vs CPU: {op} differs")
    for k in ("perm", "perm2"):
        check(torch.equal(card[k].cpu(), cpu[k]), f"card vs CPU: {k}")
    for k in ("inner", "full", "groups", "rank"):
        same_frames(f"card vs CPU {k}", card[k], cpu[k])
    check(same_bits(card["diff"].col(0).data.cpu(), cpu["diff"].col(0).data),
          "card vs CPU: difflag1 differs")
    worst = {}
    for op in unary + ["pow"]:
        worst[op] = _cvc_close(op, card[op].col(0).data,
                               cpu[op].col(0).data, **UNARY_CVC)
    for op in gamma:
        worst[op] = _cvc_close(op, card[op].col(0).data,
                               cpu[op].col(0).data, **GAMMA_CVC)
    c = rapids_arrays(n, RAPIDS["seed"])[2]
    cs = _cvc_close("cumsum", card["cumsum"].col(0).data,
                    cpu["cumsum"].col(0).data, CUMSUM_CVC,
                    float(np.abs(c).sum()))
    cp = _cvc_close("cumprod", card["cumprod"].col(0).data,
                    cpu["cumprod"].col(0).data, CUMSUM_CVC, 0.0)
    print(f"card vs cpu Rapids {n // 1000}k rows: statements 1-2, cummin/"
          "cummax, sort permutations, inner and full joins, group-by, "
          f"rank_within_groupby and difflag1 bitwise; statement 3 sum rel "
          f"{rel3:.2e}; cumsum {cs:.2e} of sum|c|, cumprod rel {cp:.2e}; "
          f"libm prims' worst scaled difference {json.dumps(worst)}")
    h2o.DKV.clear()


# ---------------------------------------------------------------------------
# the remaining model builders (phase 3p; phase 4's card-vs-CPU checks)
# ---------------------------------------------------------------------------

def blob_frame(h2o, device, n_rows, k=5, dims=4, seed=3):
    """k seeded Gaussian blobs (sd 0.5, centers in [-8, 8]^dims), and
    each row's blob."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-8, 8, (k, dims))
    lab = rng.integers(0, k, n_rows)
    X = centers[lab] + 0.5 * rng.standard_normal((n_rows, dims))
    fr = h2o.Frame()
    for j in range(dims):
        fr.add(f"x{j}", h2o.Column.from_numpy(X[:, j], device=device))
    return fr, lab


def w2v_words(n_tokens, vocab, seed=5, sent_len=100):
    """A seeded Zipf corpus (exponent 1.2, ranks capped at `vocab`) in
    sentences of `sent_len` words, each ended by an NA; in a fifth of
    the sentences "alpha" or "beta" (one or the other at random) sits
    between "w7" and "w8", so the two are planted synonyms."""
    rng = np.random.default_rng(seed)
    n_sent = max(n_tokens // sent_len, 1)
    ranks = np.minimum(rng.zipf(1.2, (n_sent, sent_len)), vocab) - 1
    words = np.array([f"w{i}" for i in range(vocab)], object)[ranks]
    rows = rng.random(n_sent) < 0.2
    twin = np.where(rng.random(n_sent) < 0.5, "alpha", "beta")
    mid = sent_len // 2
    words[rows, mid] = twin[rows]
    words[rows, mid - 1], words[rows, mid + 1] = "w7", "w8"
    return np.concatenate([words, np.full((n_sent, 1), None, object)],
                          axis=1).ravel()


def survival_frame(h2o, device, n_rows, seed=11):
    """COXPH["p"] standard-normal covariates, exponential event times of
    hazard exp(x·b) for the seeded b, 25% censored, times rounded to
    0.01 (tied times for Efron); -> (frame, b)."""
    rng = np.random.default_rng(seed)
    p = COXPH["p"]
    X = rng.standard_normal((n_rows, p))
    b = rng.uniform(-0.8, 0.8, p)
    t = np.round(rng.exponential(1.0 / np.exp(X @ b)), 2) + 0.01
    ev = (rng.random(n_rows) > 0.25).astype(float)
    fr = h2o.Frame()
    for j in range(p):
        fr.add(f"x{j}", h2o.Column.from_numpy(X[:, j], device=device))
    fr.add("t", h2o.Column.from_numpy(t, device=device))
    fr.add("event", h2o.Column.from_numpy(ev, device=device))
    return fr, b


def _coxph_se(m, fr):
    """Standard errors of a CoxPH fit's raw-scale coefficients from the
    Breslow information matrix at the fit, float64 on the card."""
    di = m.data_info
    X = di.expand(*(c.data for c in di.cols(fr))).double()
    t = fr.col("t").data.double()
    ev = fr.col("event").data.double()
    order = torch.argsort(t, stable=True)
    X, t, ev = X[order], t[order], ev[order]
    beta = torch.as_tensor(m.beta, dtype=torch.float64, device=X.device)
    r = torch.exp(X @ beta)
    # risk sets of tied times start at their group's first row
    first = torch.searchsorted(t, t)

    def rev(v):
        return torch.flip(torch.cumsum(torch.flip(v, [0]), 0), [0])

    S0 = rev(r)[first]
    S1 = rev(r[:, None] * X)[first]
    S2 = rev(r[:, None, None] * X[:, :, None] * X[:, None, :])[first]
    e = ev > 0
    mu = S1[e] / S0[e][:, None]
    info = (S2[e] / S0[e][:, None, None]
            - mu[:, :, None] * mu[:, None, :]).sum(dim=0)
    se = torch.sqrt(torch.diagonal(torch.linalg.inv(info))).cpu().numpy()
    return se / np.asarray(di.num_sigmas, np.float64)


def _counted(hg, launches, path, fn):
    """fn() with the histogram kernel's count set to 0 before and read
    into launches[path] after."""
    hg.launches = 0
    out = fn()
    launches[path] = hg.launches
    return out


def phase_ensemble(h2o, dev, fr, gbm_cv):
    """StackedEnsemble over phase 3n's 5-fold GBM (`gbm_cv`) and a GLM
    cross-validated on the same folds, AUTO metalearner, itself
    cross-validated (5 folds of the level-one frame): its CV AUC is held
    to its best base model's."""
    nf = FRAMEWORK["nfolds"]
    glm, dt_glm = _timed(lambda: h2o.GLM(
        family="binomial", lambda_=0.0, nfolds=nf, seed=1,
        keep_cross_validation_predictions=True).train(y="y",
                                                      training_frame=fr))
    metric("glm_cv_train_s", dt_glm, f"({nf + 1} trains)")
    check(glm._output.fold_assignment_digest
          == gbm_cv._output.fold_assignment_digest,
          "the GLM's folds differ from the GBM's")
    se, dt = _timed(lambda: h2o.StackedEnsemble(
        base_models=[gbm_cv.key, glm.key], metalearner_nfolds=nf,
        seed=1).train(y="y", training_frame=fr))
    metric("se_train_s", dt, f"(level-one frame, non-negative GLM "
           f"metalearner and its {nf}-fold CV, training metrics)")
    aucs = {name: m._output.cross_validation_metrics.auc
            for name, m in (("gbm", gbm_cv), ("glm", glm), ("se", se))}
    coefs = se.metalearner.coef()
    print(f"StackedEnsemble CV AUC {aucs['se']!r} (GBM {aucs['gbm']!r}, "
          f"GLM {aucs['glm']!r}); training AUC "
          f"{se._output.training_metrics.auc!r}; metalearner {coefs}")
    check(aucs["se"] > 0.5 and aucs["se"] >= max(aucs["gbm"], aucs["glm"])
          - 1e-3, "the ensemble's AUC is below its best base model's")
    check(all(v >= 0 for k, v in coefs.items() if k != "Intercept"),
          "the AUTO metalearner has a negative weight")


def phase_builders(h2o, dev, fr):
    """The remaining builders, each timed after a small warm-up train:
    KMeans (k=10 Furthest on the 1M-row flagship; estimate_k on 200k
    rows of seeded blobs), PCA (GramSVD and Randomized), SVD and
    NaiveBayes on the flagship, Word2Vec on a seeded Zipf corpus,
    TargetEncoder (both enums, 5-fold KFold), GLRM, CoxPH, PSVM,
    Aggregator and IsotonicRegression on their configurations, and GLM
    and GBM segment models. Returns the kernel's launches per path."""
    from h2o3_tpu_torch.models import kmeans as km
    from h2o3_tpu_torch.models import pca
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from h2o3_tpu_torch.ops.filters import take_rows

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; KMeans and PCA need full float32")
    cfg = BUILDERS
    launches = {}
    small = flagship_frame(h2o, dev, 20_000, seed=2)
    n = fr.nrows
    # KMeans
    h2o.KMeans(k=cfg["k"], max_iterations=2, seed=1).train(
        training_frame=small)
    m, dt = _timed(lambda: _counted(hg, launches, "kmeans", lambda: h2o.KMeans(
        k=cfg["k"], init="Furthest", standardize=True, max_iterations=10,
        seed=1).train(training_frame=fr)))
    metric("kmeans_train_s", dt, f"(k={cfg['k']}, {n} rows)")
    _, dtp = _timed(lambda: m.predict(fr))
    metric("kmeans_predict_s", dtp, f"({n} rows)")
    di = m.data_info
    X = di.expand(*(c.data for c in di.cols(fr)))
    c0 = km._init_centers(X, cfg["k"], "Furthest", 1, di, None)
    ss0 = float(torch.clamp_min(km._dist2(X, c0).min(dim=1).values,
                                0.0).double().sum())
    wss = m._output.training_metrics.tot_withinss
    print(f"KMeans within-cluster SS {wss!r} (initial centers {ss0!r}, "
          f"total {m._output.training_metrics.totss!r})")
    check(wss <= ss0 * (1 + 1e-6), "KMeans ended above its initial SS")
    del X
    bfr, lab = blob_frame(h2o, dev, cfg["aux_rows"])
    mk = _counted(hg, launches, "kmeans", lambda: h2o.KMeans(
        estimate_k=True, seed=1).train(training_frame=bfr))
    pred = mk.predict(bfr).col("predict").data.cpu().numpy()
    pairs = set(zip(lab.tolist(), pred.tolist()))
    print(f"KMeans estimate_k on {bfr.nrows} rows of 5 blobs: k={mk.k}, "
          f"{len(pairs)} (blob, cluster) pairs")
    check(mk.k == 5 and len(pairs) == 5, "KMeans did not recover the blobs")
    # PCA and SVD
    h2o.PCA(k=cfg["pca_k"], transform="STANDARDIZE").train(
        training_frame=small)
    evs = {}
    for method in ("GramSVD", "Randomized"):
        pm, dt = _timed(lambda: _counted(hg, launches, "pca", lambda: h2o.PCA(
            k=cfg["pca_k"], transform="STANDARDIZE", pca_method=method,
            seed=1).train(training_frame=fr)))
        metric("pca_train_s", dt, f"({method}, k={cfg['pca_k']})")
        evs[method] = pm.std_deviation ** 2
    G = pca.gram(pm.data_info, fr) / (n - 1)
    ref = np.sort(np.linalg.eigvalsh(G))[::-1][:cfg["pca_k"]]
    gap = float(np.max(np.abs(evs["GramSVD"] / ref - 1)))
    rgap = float(np.max(np.abs(evs["Randomized"] / ref - 1)))
    print(f"PCA eigenvalues {evs['GramSVD'].tolist()}: {gap:.3e} relative "
          f"of numpy float64's; Randomized {rgap:.3e}")
    check(gap <= 1e-5, "PCA's eigenvalues differ from numpy's")
    h2o.SVD(nv=cfg["pca_k"]).train(training_frame=small)
    sm, dt = _timed(lambda: _counted(hg, launches, "svd", lambda: h2o.SVD(
        nv=cfg["pca_k"]).train(training_frame=fr)))
    metric("svd_train_s", dt, f"(nv={cfg['pca_k']}, U kept)")
    check(np.all(np.isfinite(sm.d)) and np.all(np.diff(sm.d) <= 0),
          "SVD's singular values")
    # NaiveBayes
    h2o.NaiveBayes().train(y="y", training_frame=small)
    nb, dt = _timed(lambda: _counted(hg, launches, "naive_bayes", lambda:
                                     h2o.NaiveBayes().train(
                                         y="y", training_frame=fr)))
    metric("nb_train_s", dt, "(training metrics included)")
    auc = nb._output.training_metrics.auc
    print(f"NaiveBayes training AUC {auc!r}")
    check(auc > 0.5, "NaiveBayes AUC")
    # Word2Vec
    warm = h2o.Frame({"w": h2o.Column.from_numpy(
        w2v_words(20_000, cfg["vocab"], seed=6), device=dev)})
    h2o.Word2Vec(vec_size=cfg["vec_size"], epochs=1).train(
        training_frame=warm)
    words = h2o.Frame({"w": h2o.Column.from_numpy(
        w2v_words(cfg["w2v_tokens"], cfg["vocab"]), device=dev)})
    wm, dt = _timed(lambda: _counted(hg, launches, "word2vec", lambda:
                                     h2o.Word2Vec(vec_size=cfg["vec_size"],
                                                  epochs=1, seed=1).train(
                                         training_frame=words)))
    metric("w2v_train_s", dt, f"({cfg['w2v_tokens']} tokens, vocabulary "
           f"{len(wm.vocab)}, vec_size {cfg['vec_size']}, 1 epoch)")
    phase_profile("Word2Vec train (1M tokens)", lambda: h2o.Word2Vec(
        vec_size=cfg["vec_size"], epochs=1, seed=1).train(
            training_frame=words), wall_s=dt)
    syn = list(wm.find_synonyms("alpha", 10))
    print(f"Word2Vec synonyms of alpha: {syn}")
    check("beta" in syn, "the planted synonym is not in the top 10")
    check(np.isfinite(wm.vectors).all(), "Word2Vec vectors not finite")
    # TargetEncoder, 5-fold KFold on both enums
    rng = np.random.default_rng(4)
    tfr = h2o.Frame({**{c: fr.col(c) for c in fr.names},
                     "fold": h2o.Column.from_numpy(
                         rng.integers(0, 5, n).astype(float), device=dev)})
    te_kw = dict(data_leakage_handling="KFold", fold_column="fold",
                 columns_to_encode=["c0", "c1"], seed=1)
    h2o.TargetEncoder(**te_kw).train(y="y", training_frame=take_rows(
        tfr, np.arange(20_000)))
    te, dt = _timed(lambda: _counted(hg, launches, "target_encoder",
                                     lambda: h2o.TargetEncoder(**te_kw).train(
                                         y="y", training_frame=tfr)))
    metric("te_train_s", dt, "(2 enums, 5 folds)")
    enc, dt = _timed(lambda: te.transform(tfr, as_training=True))
    metric("te_transform_s", dt, f"({n} rows, out of fold, noise)")
    for c in ("c0_te", "c1_te"):
        v = enc.col(c).data.cpu().numpy()
        check(np.isfinite(v).all() and (v > -0.02).all() and (v < 1.02).all(),
              f"{c} out of range")
    del tfr, enc
    # GLRM on 200k rows of the numerics
    nums = take_rows(fr.subframe([f"n{i}" for i in range(FLAGSHIP["n_num"])]),
                     np.arange(cfg["aux_rows"]))
    glrm_kw = dict(k=cfg["pca_k"], transform="STANDARDIZE",
                   min_step_size=GLRM_MIN_STEP, seed=1)
    h2o.GLRM(max_iterations=20, **glrm_kw).train(
        training_frame=take_rows(nums, np.arange(20_000)))
    gm, dt = _timed(lambda: _counted(hg, launches, "glrm", lambda: h2o.GLRM(
        **glrm_kw).train(training_frame=nums)))
    metric("glrm_train_s", dt, f"({gm.iterations} iterations, objective "
           f"{gm.objective!r})")
    check(np.isfinite(gm.objective) and gm.iterations > 0, "GLRM objective")
    # CoxPH
    sfr, b_true = survival_frame(h2o, dev, cfg["aux_rows"])
    h2o.CoxPH(stop_column="t").train(y="event", training_frame=take_rows(
        sfr, np.arange(20_000)))
    cm, dt = _timed(lambda: _counted(hg, launches, "coxph", lambda: h2o.CoxPH(
        stop_column="t").train(y="event", training_frame=sfr)))
    metric("coxph_train_s", dt, f"({cm.iterations} Newton iterations, "
           "Efron ties)")
    coef = np.array([cm.coefficients[f"x{j}"] for j in range(COXPH["p"])])
    se = _coxph_se(cm, sfr)
    z = np.abs(coef - b_true) / se
    print(f"CoxPH |coef - truth| / SE: max {z.max():.3f}; loglik "
          f"{cm.loglik!r}, concordance {cm.concordance!r}")
    check(z.max() <= COEF_SE_BOUND, "CoxPH coefficients off the truth")
    # PSVM
    pfr = take_rows(fr, np.arange(cfg["psvm_rows"]))
    h2o.PSVM().train(y="y", training_frame=take_rows(fr, np.arange(2_000)))
    ps, dt = _timed(lambda: _counted(hg, launches, "psvm", lambda: h2o.PSVM(
        seed=1).train(y="y", training_frame=pfr)))
    hist = ps._output.scoring_history[0]
    metric("psvm_train_s", dt, f"({pfr.nrows} rows, rank "
           f"{ps.pivots.shape[0]}, {hist['iterations']} BFGS steps)")
    print(f"PSVM training AUC {ps._output.training_metrics.auc!r}, "
          f"{ps.svs_count} support vectors")
    check(ps._output.training_metrics.auc > 0.5, "PSVM AUC")
    # Aggregator on 200k rows of the flagship's 10 features
    afr = take_rows(fr.subframe([c for c in fr.names if c != "y"]),
                    np.arange(cfg["aux_rows"]))
    h2o.Aggregator(target_num_exemplars=100).train(
        training_frame=take_rows(afr, np.arange(5_000)))
    ag, dt = _timed(lambda: _counted(hg, launches, "aggregator", lambda:
                                     h2o.Aggregator().train(
                                         training_frame=afr)))
    path = ag.search_path
    metric("aggregator_train_s", dt, f"({afr.ncol} columns, "
           f"{len(ag.counts)} exemplars, {len(path)} radius passes)")
    print("Aggregator radius passes (radius, exemplars; target + 1 for a "
          "pass cut short): " + ", ".join(f"({r:.5f}, {c})" for r, c in path))
    phase_profile("Aggregator train (200k rows, 10 columns)",
                  lambda: h2o.Aggregator().train(training_frame=afr),
                  wall_s=dt)
    check(ag.counts.sum() == afr.nrows and path[-1][1] == len(ag.counts)
          and (2500 <= len(ag.counts) <= 5000 or len(path) == 20),
          "Aggregator exemplars")
    # IsotonicRegression on 200k rows
    ifr = take_rows(fr.subframe(["n0", "n1"]), np.arange(cfg["aux_rows"]))
    h2o.IsotonicRegression().train(y="n1", training_frame=take_rows(
        ifr, np.arange(2_000)))
    im, dt = _timed(lambda: _counted(hg, launches, "isotonic", lambda:
                                     h2o.IsotonicRegression().train(
                                         y="n1", training_frame=ifr)))
    metric("isotonic_train_s", dt, f"({len(im.thresholds_x)} knots)")
    check(bool((np.diff(im.thresholds_y) >= 0).all()), "isotonic fit")
    # segments: a GLM per level of c0 on the 1M rows; GBMs per level of
    # c1 on 200k rows run the kernel
    h2o.train_segments(h2o.GLM, {"family": "binomial"}, small, ["c0"], y="y")
    sg, dt = _timed(lambda: _counted(hg, launches, "segments_glm", lambda:
                                     h2o.train_segments(
                                         h2o.GLM, {"family": "binomial"},
                                         fr, ["c0"], y="y")))
    metric("segments_train_s", dt, f"({len(sg)} GLMs)")
    check(len(sg) == 4 and all(r["status"] == "SUCCEEDED" for r in sg.rows),
          f"segments: {[r['status'] for r in sg.rows]}")
    tbl = h2o.exec_rapids(f"(segment_models_as_frame '{sg.key}')",
                          h2o.Session("seg"))
    check(tbl.nrows == 4, "segment_models_as_frame rows")
    gbm_seg = _counted(hg, launches, "segments", lambda: h2o.train_segments(
        h2o.GBM, {"ntrees": 5, "max_depth": FLAGSHIP["max_depth"]},
        take_rows(fr, np.arange(cfg["aux_rows"])), ["c1"], y="y"))
    check(len(gbm_seg) == 3 and all(r["status"] == "SUCCEEDED"
                                    for r in gbm_seg.rows), "GBM segments")
    print(f"GBM segments: {len(gbm_seg)} models, hist_gather launches "
          f"{launches['segments']}")
    for path, count in launches.items():
        check(count == 0 or path == "segments",
              f"{path} launched the histogram kernel {count} times")
    check(launches["segments"] == 3 * 5 * FLAGSHIP["max_depth"],
          f"{launches['segments']} launches for 3 GBM segments")
    h2o.DKV.clear()     # the models and frames installed since phase 3n
    return launches


def _levels(model):
    """Histogram levels a tree model and its CV models walked: the device
    grower builds one histogram per level below max_depth, every tree."""
    ms = [model] + list(model._output.cross_validation_models or [])
    return sum(m.forest.n_trees * int(m._parms["max_depth"]) for m in ms)


def _aml_members(aml):
    """Each AutoML model's step name, in the order they were built."""
    step = {st["model_id"]: st["name"] for st in aml.modeling_plan
            if st.get("model_id")}
    return [step.get(str(m.key), getattr(m, "_se_name", None))
            for m in aml.models]


def _aml_leaderboard(aml):
    names = dict(zip((str(m.key) for m in aml.models), _aml_members(aml)))
    return [(names.get(r["model_id"], r["model_id"]), r["algo"],
             r[aml._metric_name]) for r in aml.leaderboard]


def _check_automl(aml, label):
    """The members AutoML must build, none parked, none failed."""
    members = _aml_members(aml)
    check(members == AML_MEMBERS, f"{label}: members {members}")
    counts = aml._search_engine.counts()
    check(counts.get("done") == 2 and set(counts) <= {"done", "pending"},
          f"{label}: member states {counts}")
    failed = [e["message"] for e in aml.event_log if "FAILED" in
              e["message"]]
    check(not failed, f"{label}: {failed}")


def phase_search(h2o, dev, fr):
    """Search on the flagship frame: the dryrun's AutoML, a Cartesian GBM
    grid, a RandomDiscrete GLM grid sequential and with parallelism 3,
    and a cancelled GBM train. Returns the kernel's launches per path."""
    import threading

    from h2o3_tpu_torch.automl import search
    from h2o3_tpu_torch.core.job import Job, JobCancelled
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    c, launches = SEARCH, {}
    search.reset_stats()
    aml, dt = _timed(lambda: _counted(hg, launches, "automl", lambda:
                                      h2o.H2OAutoML(
                                          max_models=c["aml_models"],
                                          seed=c["seed"]).train(
                                          y="y", training_frame=fr)))
    metric("automl_train_s", dt, f"({len(aml.models)} models, "
           f"{aml.nfolds}-fold CV)")
    for name, algo, auc in _aml_leaderboard(aml):
        print(f"  leaderboard: {name} ({algo}) CV AUC {auc!r}")
    _check_automl(aml, "AutoML")
    lb = aml.leaderboard
    best_base = max(_metric_of(m) for m in aml.models[:2])
    check(lb[0]["auc"] > 0.5 and lb[0]["auc"] >= best_base - 1e-3,
          f"the leader's AUC {lb[0]['auc']} is below its best base "
          f"model's {best_base}")
    gbm = aml.models[1]
    levels = _levels(gbm)
    print(f"AutoML hist_gather launches {launches['automl']}, levels "
          f"grown by the GBM member's {1 + aml.nfolds} trains {levels}; "
          "the GLM member and the ensembles add none")
    check(launches["automl"] == levels > 0,
          f"{launches['automl']} launches for {levels} levels grown")
    pred = aml.predict(fr).col("Y").data
    check(pred.shape == (fr.nrows,) and bool(torch.isfinite(pred).all()),
          "AutoML leader predictions")

    g, dt = _timed(lambda: _counted(hg, launches, "grid_gbm", lambda:
                                    h2o.H2OGridSearch(
                                        h2o.GBM, c["grid_hyper"]).train(
                                        y="y", training_frame=fr,
                                        ntrees=c["grid_ntrees"],
                                        seed=c["seed"])))
    metric("grid_train_s", dt, f"({len(g)} GBMs of {c['grid_ntrees']} "
           "trees)")
    table = g.sorted_metric_table()
    for r in table:
        print(f"  grid: max_depth {r['max_depth']} learn_rate "
              f"{r['learn_rate']} training AUC {r['auc']!r}")
    levels = sum(_levels(m) for m in g.models)
    check(len(g) == 4 and not g.failed, f"GBM grid: {len(g)} models, "
                                        f"failed {g.failed}")
    check([r["auc"] for r in table] == sorted((r["auc"] for r in table),
                                              reverse=True),
          "the sorted metric table is out of order")
    check(launches["grid_gbm"] == levels > 0,
          f"{launches['grid_gbm']} launches for {levels} levels grown")
    # phase 3v resumes this grid from a recovery_dir
    RUN["grid_gbm"] = {_combo(m): _forest_bits(m) for m in g.models}
    RUN["grid_table"] = _grid_table(g)

    glm = {}
    for par in (1, 3):
        search.reset_stats()
        g, dt = _timed(lambda: _counted(hg, launches, "grid_glm",
                                        lambda: h2o.H2OGridSearch(
            h2o.GLM(family="binomial"), c["glm_hyper"], search_criteria={
                "strategy": "RandomDiscrete", "max_models": c["glm_models"],
                "seed": c["glm_seed"]}).train(y="y", training_frame=fr,
                                              parallelism=par)))
        glm[par] = {str(sorted(m._grid_params.items())):
                    m._output.training_metrics.auc for m in g.models}
        print(f"GLM grid, parallelism {par}: {dt!r} s, {len(g)} models; "
              f"H2O_TPU_SEARCH stats {search.stats()}")
        check(len(g) == c["glm_models"] and not g.failed,
              f"GLM grid (parallelism {par}): {len(g)} models, failed "
              f"{g.failed}")
        check(launches["grid_glm"] == 0, "a GLM grid launched the "
                                         "histogram kernel")
    check(search.stats()["overlap"] >= 2,
          "the parallel GLM grid ran its members one at a time")
    check(sorted(glm[1]) == sorted(glm[3]),
          f"parallel GLM grid combos {sorted(glm[3])} vs {sorted(glm[1])}")
    gap = max(abs(glm[1][k] - glm[3][k]) for k in glm[1])
    print(f"GLM grid parallelism 3 vs 1: the same {len(glm[1])} combos, "
          f"max AUC gap {gap!r}")
    check(gap <= GRID_AUC_ATOL, f"parallel GLM grid AUCs differ by {gap}")

    # jobs: a normal train ends DONE at progress 1.0; a train cancelled
    # from another thread after its second tree ends CANCELLED
    b = h2o.GBM(ntrees=5, max_depth=FLAGSHIP["max_depth"], seed=1)
    b.train(y="y", training_frame=fr)
    check(b.job.status == Job.DONE and b.job.progress == 1.0,
          f"a GBM train's job ended {b.job.status} at {b.job.progress}")
    nt = c["cancel_ntrees"]
    b, box = h2o.GBM(ntrees=nt, max_depth=FLAGSHIP["max_depth"],
                     seed=1), {}

    def train():
        try:
            box["model"] = b.train(y="y", training_frame=fr)
        except JobCancelled as e:
            box["cancelled"] = e

    t = threading.Thread(target=train)
    t.start()
    while t.is_alive() and (b.job is None or b.job.progress < 2 / nt):
        time.sleep(0.001)
    b.job.cancel()
    t.join(600)
    print(f"cancelled GBM train: job {b.job.status} at progress "
          f"{b.job.progress} ({b.job.progress_msg})")
    check(not t.is_alive() and "cancelled" in box
          and b.job.status == Job.CANCELLED
          and 2 / nt <= b.job.progress < 1.0,
          f"the cancelled train's job ended {b.job.status} at "
          f"{b.job.progress}")
    h2o.DKV.clear()
    return launches


def _metric_of(m):
    mm = m._output.cross_validation_metrics or m._output.training_metrics
    return float(mm.auc)


def _pred_columns(m, fr):
    """{column: host array} of m.predict(fr)."""
    p = m.predict(fr)
    return {nm: p.col(nm).data.cpu().numpy() for nm in p.names}


def _same_predictions(label, a, b):
    check(sorted(a) == sorted(b), f"{label}: columns {sorted(a)} vs "
                                  f"{sorted(b)}")
    for nm in a:
        check(a[nm].dtype == b[nm].dtype and np.array_equal(
            a[nm].view(np.uint8), b[nm].view(np.uint8)),
            f"{label}: column {nm} differs")


def _feat_rows(src):
    """Rows of a tree POJO's FEAT table (one per tree)."""
    import re

    table = re.search(r"static final int\[\]\[\] FEAT = \{(.*)\};", src)
    return len(re.findall(r"\{[^{}]*\}", table.group(1)))


def phase_explain_export(h2o, dev, fr, gbm, dl_model, tmp):
    """Export, import and explanation on the flagship frame, over the
    flagship GBM (phase 3), phase 3m's DeepLearning model and one
    binomial GLM trained here: native MOJO round trips through
    H2OGenericEstimator (bitwise), Java-format MOJOs scored by the torch
    walk (probabilities to JAVA_ATOL), POJO sources, TreeSHAP on the
    first EXPLAIN["contrib_rows"] rows (row sums to the margins within
    CONTRIB_ATOL), partial dependence of all 10 columns and one ICE
    curve, feature interactions, the varimp and correlation matrices;
    the two explanation calls profiled. Launches no histogram kernel;
    returns (launches, the GLM)."""
    import os

    from h2o3_tpu_torch import explain
    from h2o3_tpu_torch.models import mojo, mojo_java, pojo
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from h2o3_tpu_torch.ops.filters import take_rows

    c = EXPLAIN
    hg.launches = 0
    glm = h2o.GLM(family="binomial").train(y="y", training_frame=fr)
    models = {"gbm": gbm, "glm": glm, "deeplearning": dl_model}
    want = {k: _pred_columns(m, fr) for k, m in models.items()}
    for name, m in models.items():
        path, t_exp = _timed(lambda: m.download_mojo(
            os.path.join(tmp, f"{name}.zip")))
        gm, t_imp = _timed(lambda: h2o.H2OGenericEstimator(
            path=path).train())
        got, t_pred = _timed(lambda: _pred_columns(gm, fr))
        _same_predictions(f"{name} MOJO round trip", want[name], got)
        check(gm.inner_algo == m.algo_name, f"{name}: inner algo "
                                            f"{gm.inner_algo}")
        size = os.path.getsize(path)
        if name == "gbm":
            metric("mojo_export_s", t_exp)
            metric("mojo_import_s", t_imp)
            metric("generic_predict_s", t_pred, f"({fr.nrows} rows)")
            metric("mojo_bytes", size)
        print(f"{name} MOJO round trip: {size} bytes, export {t_exp:.4f} s, "
              f"import {t_imp:.4f} s, predict {t_pred:.4f} s, predictions "
              "bitwise equal")
    for name in ("gbm", "glm"):
        blob, t_exp = _timed(lambda: mojo_java.export_java_mojo_bytes(
            models[name]))
        jm = mojo.read_mojo(blob)
        got, t_pred = _timed(lambda: _pred_columns(jm, fr))
        gap = float(np.abs(got["Y"] - want[name]["Y"]).max())
        agree = float((got["predict"] == want[name]["predict"]).mean())
        check(gap <= JAVA_ATOL and agree > 0.995,
              f"{name} Java MOJO: probabilities differ by {gap}, labels "
              f"agree on {agree}")
        if name == "gbm":
            metric("java_mojo_export_s", t_exp)
            metric("java_mojo_predict_s", t_pred, f"({fr.nrows} rows)")
        print(f"{name} Java MOJO: {len(blob)} bytes, max probability gap "
              f"{gap:.3e}, labels agree on {agree:.6f}")
    (src_gbm, src_glm), t_pojo = _timed(lambda: (
        pojo.pojo_source(gbm), pojo.pojo_source(glm)))
    check(_feat_rows(src_gbm) == gbm.forest.n_trees == FLAGSHIP["ntrees"],
          f"the GBM POJO names {_feat_rows(src_gbm)} trees")
    check("double[] BETA" in src_glm, "the GLM POJO has no coefficients")
    metric("pojo_source_s", t_pojo, f"({len(src_gbm)} + {len(src_glm)} "
                                    "characters)")

    sub = take_rows(fr, np.arange(c["contrib_rows"]))
    contrib, t_con = _timed(lambda: gbm.predict_contributions(sub))
    phi = np.stack([contrib.col(nm).data.cpu().numpy()
                    for nm in contrib.names], 1).astype(np.float64)
    margin = gbm.forest.predict_binned(gbm.spec.bin_columns(
        gbm.adapt_test(sub))).cpu().numpy()
    lgap = float(np.abs(phi.sum(1) - margin).max())
    check(contrib.names == gbm._output.names + ["BiasTerm"]
          and np.isfinite(phi).all() and lgap <= CONTRIB_ATOL,
          f"contributions: row sums differ from the margins by {lgap}")
    metric("contrib_rows_per_sec", c["contrib_rows"] / t_con,
           f"({c['contrib_rows']} rows, {gbm.forest.n_trees} trees, "
           f"{t_con!r} s)")
    print(f"TreeSHAP: contributions + BiasTerm = margin within {lgap:.3e}")

    tables, t_pdp = _timed(lambda: gbm.partial_plot(fr, nbins=c["nbins"]))
    ice = gbm.partial_plot(fr, cols=["n0"], nbins=c["nbins"], row_index=0)
    calls = sum(len(t["values"]) for t in tables)
    check([t["column"] for t in tables] == gbm._output.names,
          "partial_plot: the tables are not one per column")
    for t in tables + ice:
        v = np.asarray(t["mean_response"])
        check(np.isfinite(v).all() and (v >= 0).all() and (v <= 1).all(),
              f"partial_plot {t['column']}: responses not in [0, 1]")
    check(all(s == 0.0 for s in ice[0]["stddev_response"])
          and len(ice[0]["values"]) == c["nbins"], "ICE curve malformed")
    metric("pdp_s", t_pdp, f"({calls} scoring calls of {fr.nrows} rows)")

    rows = gbm.feature_interaction(2)
    fo = gbm.forest
    total = sum(float(g) for g in fo.gain[fo.feat >= 0])
    singles = sum(r["gain"] for r in rows if r["depth"] == 0)
    check(abs(singles - total) <= 1e-9 * max(1.0, abs(total)),
          f"depth-0 gains sum to {singles}, the forest's to {total}")
    vm = explain.varimp_matrix(list(models.values()))
    cm, t_cor = _timed(lambda: explain.model_correlation(
        list(models.values()), fr))
    C = cm["matrix"]
    check(C.shape == (3, 3) and np.abs(np.diag(C) - 1).max() <= 1e-6,
          f"model correlation diagonal {np.diag(C)}")
    print(f"feature interactions: {len(rows)} rows, depth-0 gains "
          f"{singles!r} = forest {total!r}; varimp matrix "
          f"{vm['matrix'].shape}; correlations "
          f"{np.round(C[np.triu_indices(3, 1)], 4).tolist()} "
          f"({t_cor:.3f} s)")
    phase_profile(f"predict_contributions ({c['contrib_rows']} rows)",
                  lambda: gbm.predict_contributions(sub), wall_s=t_con)
    phase_profile(f"partial_plot (n0 and c0, {fr.nrows} rows)",
                  lambda: gbm.partial_plot(fr, cols=["n0", "c0"],
                                           nbins=c["nbins"]))
    launches = hg.launches
    check(launches == 0, f"phase 3r launched the histogram kernel "
                         f"{launches} times")
    return launches, glm


def phase_card_vs_cpu_explain(h2o, dev):
    """A GBM on EXPLAIN["cvc_rows"] flagship rows trained on the card and
    its forest carried to a CPU model: contributions bit for bit (the
    same host walk over the same bin matrix); the PDP grid frames'
    margins bit for bit (ROADMAP C2) and the PDP tables of a numeric and
    an enum column within PDP_CVC_ATOL (the probabilities pass through
    the card's and the CPU's float32 exp, ROADMAP C29); and the card model's MOJO read and
    scored on the CPU equal to the CPU model's predictions."""
    from h2o3_tpu_torch import convert, explain
    from h2o3_tpu_torch.models import mojo

    n, cpu = EXPLAIN["cvc_rows"], torch.device("cpu")
    frs = [flagship_frame(h2o, d, n) for d in (dev, cpu)]
    card = h2o.GBM(ntrees=5, max_depth=FLAGSHIP["max_depth"], seed=1).train(
        y="y", training_frame=frs[0])
    fo, sp, o = card.forest, card.spec, card._output
    host = convert.gbm_model_from_numpy({
        "forest": {**{k: getattr(fo, k) for k in (
            "feat", "thresh_bin", "na_left", "left", "right", "leaf_val",
            "cat_split", "cat_table", "tree_class", "na_bins", "init_class",
            "gain", "cover")},
            "max_depth": fo.max_depth, "init_f": fo.init_f,
            "nclasses": fo.nclasses},
        "spec": {"names": sp.names, "is_cat": sp.is_cat, "nbins": sp.nbins,
                 "edges": sp.edges, "cards": sp.cards},
        "output": {"names": o.names, "domains": o.domains,
                   "response_domain": o.response_domain,
                   "model_category": o.model_category,
                   "response_name": o.response_name}})
    # labels follow the max-F1 threshold of the training metrics
    host._output.training_metrics = o.training_metrics
    phis = [np.stack([c.col(nm).data.cpu().numpy() for nm in c.names], 1)
            for c in (card.predict_contributions(frs[0]),
                      host.predict_contributions(frs[1]))]
    check(np.array_equal(phis[0].view(np.uint32), phis[1].view(np.uint32)),
          "contributions differ between the card and the CPU")
    pdps = [m.partial_plot(f, cols=["n0", "c0"], nbins=EXPLAIN["nbins"])
            for m, f in ((card, frs[0]), (host, frs[1]))]
    gap = max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
              for a, b in zip(*pdps)
              for k in ("mean_response", "stddev_response"))
    check(all(a["values"] == b["values"] for a, b in zip(*pdps))
          and gap <= PDP_CVC_ATOL, f"PDP tables differ between the card "
                                   f"and the CPU by {gap}")
    for v in (-1.5, 0.25, 2.0):      # a grid frame's margins, bitwise
        margins = [m.forest.predict_binned(m.spec.bin_columns(m.adapt_test(
            explain._with_value(f, "n0", v, False, [])))).cpu().numpy()
            for m, f in ((card, frs[0]), (host, frs[1]))]
        check(np.array_equal(margins[0].view(np.uint32),
                             margins[1].view(np.uint32)),
              f"PDP grid frame n0={v}: margins differ between the card "
              "and the CPU")
    back = mojo.read_mojo(mojo.export_mojo_bytes(card))
    _same_predictions("card MOJO scored on the CPU",
                      _pred_columns(host, frs[1]),
                      _pred_columns(back, frs[1]))
    print(f"card vs cpu explain ({n} rows): contributions bitwise, the "
          f"PDP grid frames' margins bitwise, PDP tables {gap:.3e} apart "
          f"(bitwise: {pdps[0] == pdps[1]}), the card's MOJO on the CPU "
          "predicts bitwise")
    h2o.DKV.clear()


def phase_card_vs_cpu_search(h2o, dev):
    """The AutoML of phase 3q with 3 folds on 20k flagship rows, on the
    card and on the CPU: the same members in the same order and the same
    leaderboard (neighbours closer than GLM_PRED_ATOL may swap); the GBM
    member's forests (main and folds) bitwise, its holdout predictions
    and CV metrics to PRED_ATOL; the GLM member's coefficients to
    GLM_COEF_TOL and its predictions, and the ensembles', to
    GLM_PRED_ATOL. Every gap is reported before the phase fails."""
    c = SEARCH
    failures, amls, frames = [], [], []

    def expect(ok, msg):
        if not ok:
            failures.append(msg)

    for d in (dev, torch.device("cpu")):
        fr = flagship_frame(h2o, d, c["cvc_rows"])
        aml, dt = _timed(lambda: h2o.H2OAutoML(
            max_models=c["aml_models"], nfolds=c["cvc_nfolds"],
            seed=c["seed"]).train(y="y", training_frame=fr))
        print(f"AutoML on {d.type}, {c['cvc_rows']} rows: {dt!r} s")
        _check_automl(aml, f"AutoML on {d.type}")
        amls.append(aml)
        frames.append(fr)
    card, host = amls
    lbs = [_aml_leaderboard(a) for a in amls]
    print(f"leaderboards card {lbs[0]} / CPU {lbs[1]}")
    order = [n for n, _, _ in lbs[1]]
    pos = {n: i for i, (n, _, _) in enumerate(lbs[0])}
    for (a, _, va), (b, _, vb) in zip(lbs[1], lbs[1][1:]):
        expect(abs(va - vb) <= GLM_PRED_ATOL or pos[a] < pos[b],
               f"leaderboard order card {[n for n, _, _ in lbs[0]]} vs CPU "
               f"{order}")
    preds = [[m.predict(f).col("Y").data.cpu().numpy() for m in a.models]
             for a, f in zip(amls, frames)]
    gaps = {}
    for i, name in enumerate(AML_MEMBERS):
        gaps[name] = float(np.abs(preds[0][i] - preds[1][i]).max())
    gm = [a.models[1] for a in amls]
    for ma, mb in zip([gm[0]] + gm[0]._output.cross_validation_models,
                      [gm[1]] + gm[1]._output.cross_validation_models):
        fa, fb = _forest_arrays(ma), _forest_arrays(mb)
        for k in fa:
            expect(np.array_equal(fa[k], fb[k]),
                   f"AutoML GBM member: forest {k} differs")
    oa, ob = gm[0]._output, gm[1]._output
    hdiff = float(np.abs(oa.cross_validation_holdout_predictions
                         - ob.cross_validation_holdout_predictions).max())
    mdiff = max(abs(getattr(oa.cross_validation_metrics, k)
                    - getattr(ob.cross_validation_metrics, k))
                for k in ("auc", "logloss", "rmse"))
    expect(hdiff <= PRED_ATOL and mdiff <= PRED_ATOL
           and gaps["def_gbm_1"] <= PRED_ATOL,
           f"AutoML GBM member: holdout predictions differ by {hdiff}, CV "
           f"metrics by {mdiff}, predictions by {gaps['def_gbm_1']}")
    ca, cb = card.models[0].coef(), host.models[0].coef()
    cgap = max(abs(ca[k] - cb[k]) for k in ca)
    expect(list(ca) == list(cb) and all(
        np.allclose(ca[k], cb[k], **GLM_COEF_TOL) for k in ca),
        f"AutoML GLM member: coefficients differ by {cgap}")
    for name in ("def_glm", "StackedEnsemble_BestOfFamily",
                 "StackedEnsemble_AllModels"):
        expect(gaps[name] <= GLM_PRED_ATOL,
               f"AutoML {name}: predictions differ by {gaps[name]}")
    print(f"card vs cpu AutoML: members {AML_MEMBERS}; GBM member forests "
          f"equal, holdout pred diff {hdiff:.3e}, CV metric diff "
          f"{mdiff:.3e}; GLM coef diff {cgap:.3e}; prediction diffs "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    h2o.DKV.clear()
    check(not failures, "; ".join(failures))


def phase_card_vs_cpu_builders(h2o, dev):
    """Each remaining builder on the card and on the CPU (100k-row
    fixtures: KMeans on seeded blobs, as its CPU tests, PSVM on its 20k
    rows), held to the CPU tests' tolerances; CoxPH's coefficients to
    COXPH["cvc_coef_atol"] (ROADMAP C23), Word2Vec's vectors to
    W2V_CVC_ATOL (C24); Aggregator's designs bitwise and its exemplars
    equal, or parting first at a row within rounding of the radius or
    of a tie (C25)."""
    from h2o3_tpu_torch.models import aggregator as agg

    cpu = torch.device("cpu")
    n = BUILDERS["cvc_rows"]
    # every builder is compared before the phase fails, so one run
    # names every gap
    failures, secs, out = [], {}, {}

    def expect(ok, msg):
        if not ok:
            failures.append(msg)

    def both(label, make, fit):
        models = []
        for d in (dev, cpu):
            t0 = time.perf_counter()
            models.append(fit(make(d)))
            torch.cuda.synchronize()
            secs[(label, d.type)] = time.perf_counter() - t0
        return models

    def close(label, a, b, **tol):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        diff = float(np.max(np.abs(a - b))) if a.size else 0.0
        expect(np.allclose(a, b, **tol),
               f"{label}: card vs CPU differ by {diff} (bar {tol})")
        out[label] = diff
        return diff

    def flag(d):
        return flagship_frame(h2o, d, n)

    def nums(d):
        return flag(d).subframe([f"n{i}" for i in range(8)])

    k = both("KMeans", lambda d: blob_frame(h2o, d, n)[0],
             lambda fr: h2o.KMeans(k=5, seed=1).train(training_frame=fr))
    close("KMeans centers", k[0].centers, k[1].centers, atol=1e-5, rtol=0)
    close("KMeans SS", k[0]._output.training_metrics.tot_withinss,
          k[1]._output.training_metrics.tot_withinss, rtol=1e-5, atol=0)
    p = both("PCA", flag, lambda fr: h2o.PCA(
        k=5, transform="STANDARDIZE").train(training_frame=fr))
    close("PCA eigenvalues", p[0].std_deviation, p[1].std_deviation,
          rtol=1e-5, atol=0)
    close("PCA eigenvectors", p[0].eigenvectors, p[1].eigenvectors,
          atol=1e-4, rtol=0)
    s = both("SVD", flag, lambda fr: h2o.SVD(nv=5, keep_u=False).train(
        training_frame=fr))
    close("SVD d", s[0].d, s[1].d, rtol=1e-5, atol=0)
    nb = both("NaiveBayes", flag, lambda fr: h2o.NaiveBayes().train(
        y="y", training_frame=fr))
    expect(np.array_equal(nb[0].priors, nb[1].priors)
           and all(np.array_equal(a, b)
                   for a, b in zip(nb[0].cat_tables, nb[1].cat_tables)),
           "NaiveBayes tables differ between card and CPU")
    close("NaiveBayes means", nb[0].num_means, nb[1].num_means, rtol=1e-6,
          atol=1e-7)
    words = w2v_words(BUILDERS["cvc_tokens"], BUILDERS["vocab"], seed=7)
    w = both("Word2Vec",
             lambda d: h2o.Frame({"w": h2o.Column.from_numpy(words,
                                                             device=d)}),
             lambda fr: h2o.Word2Vec(vec_size=BUILDERS["vec_size"], epochs=1,
                                     seed=1).train(training_frame=fr))
    expect(list(w[0].vocab) == list(w[1].vocab), "Word2Vec vocabularies")
    close("Word2Vec vectors", w[0].vectors, w[1].vectors, atol=W2V_CVC_ATOL,
          rtol=0)

    def te_fit(fr):
        fr.add("fold", h2o.Column.from_numpy(np.arange(fr.nrows) % 5.0,
                                             device=fr.col("y").device))
        m = h2o.TargetEncoder(data_leakage_handling="KFold",
                              fold_column="fold", seed=1).train(
            y="y", training_frame=fr)
        return m.transform(fr, as_training=True).col("c0_te").data.cpu()

    te = both("TargetEncoder", flag, te_fit)
    close("TargetEncoder c0_te", te[0], te[1], atol=1e-6, rtol=0)
    g = both("GLRM", nums, lambda fr: h2o.GLRM(
        k=5, transform="STANDARDIZE", min_step_size=GLRM_MIN_STEP,
        max_iterations=20, seed=1).train(training_frame=fr))
    expect(g[0].iterations == g[1].iterations > 0, "GLRM iterations")
    close("GLRM objective", g[0].objective, g[1].objective, rtol=1e-5,
          atol=0)
    c = both("CoxPH", lambda d: survival_frame(h2o, d, n)[0],
             lambda fr: h2o.CoxPH(stop_column="t").train(
                 y="event", training_frame=fr))
    close("CoxPH loglik", c[0].loglik, c[1].loglik, rtol=1e-6, atol=0)
    close("CoxPH coefficients", list(c[0].coefficients.values()),
          list(c[1].coefficients.values()), atol=COXPH["cvc_coef_atol"],
          rtol=0)

    def psvm_decision(fr):
        m = h2o.PSVM(seed=1).train(y="y", training_frame=fr)
        return m._predict_raw(m.adapt_test(fr))["decision"].cpu().numpy()

    ps = both("PSVM", lambda d: flagship_frame(h2o, d, BUILDERS["psvm_rows"]),
              psvm_decision)
    close("PSVM decision", ps[0], ps[1], atol=1e-3, rtol=0)
    # Aggregator at the flagship's full width: the designs bitwise (the
    # NORMALIZE means are summed order-free); where the two searches
    # part, the first pass that parts is run again on both devices and
    # its first parting row must lie within rounding of the radius or
    # of a tie (C25)
    feats = [f"n{i}" for i in range(8)] + ["c0", "c1"]
    afr = {d.type: flag(d).subframe(feats) for d in (dev, cpu)}
    a = both("Aggregator", lambda d: afr[d.type],
             lambda fr: h2o.Aggregator(
                 target_num_exemplars=AGG_CVC_TARGET).train(
                     training_frame=fr))
    Xs = [m.data_info.expand(*(c.data for c in m.data_info.cols(afr[t])))
          for m, t in zip(a, (dev.type, "cpu"))]
    X = Xs[1].numpy()
    expect(np.array_equal(Xs[0].cpu().numpy(), X),
           "Aggregator designs differ between card and CPU")
    shared = len(np.intersect1d(a[0].exemplar_rows, a[1].exemplar_rows))
    ne = (len(a[0].counts), len(a[1].counts))
    ok, note = _aggregator_parting(agg, a, Xs, AGG_CVC_TARGET)
    expect(ok, f"Aggregator: card vs CPU part beyond C25 ({note})")
    print(f"card vs cpu Aggregator ({n} rows, {X.shape[1]} design columns): "
          f"{ne[0]} / {ne[1]} exemplars, {shared} shared rows, {note}")
    expect(a[0].counts.sum() == a[1].counts.sum() == n,
           "Aggregator counts do not cover the rows")
    iso = both("IsotonicRegression",
               lambda d: flag(d).subframe(["n0", "n1"]),
               lambda fr: h2o.IsotonicRegression().train(
                   y="n1", training_frame=fr))
    expect(np.array_equal(iso[0].thresholds_x, iso[1].thresholds_x)
           and np.array_equal(iso[0].thresholds_y, iso[1].thresholds_y),
           "isotonic knots differ between card and CPU")
    sg = both("segments", flag, lambda fr: h2o.train_segments(
        h2o.GLM, {"family": "binomial"}, fr, ["c0"], y="y"))
    for ra, rb in zip(sg[0].rows, sg[1].rows):
        close(f"segment {ra['segment']['c0']} GLM",
              list(h2o.DKV.get(ra["model_id"]).coef().values()),
              list(h2o.DKV.get(rb["model_id"]).coef().values()),
              **GLM_COEF_TOL)
    se = both("StackedEnsemble", flag, lambda fr: _small_ensemble(h2o, fr))
    close("StackedEnsemble predictions", se[0], se[1], atol=GLM_PRED_ATOL,
          rtol=0)
    print("card vs cpu, the remaining builders: knots, vocabulary, "
          "NaiveBayes tables equal; max diffs " + ", ".join(
              f"{lb} {v:.3e}" for lb, v in out.items()))
    print("card vs cpu seconds (card / CPU): " + ", ".join(
        f"{lb} {secs[(lb, dev.type)]:.2f} / {secs[(lb, 'cpu')]:.2f}"
        for lb in dict.fromkeys(lb for lb, _ in secs)))
    check(not failures, "; ".join(failures))


def _aggregator_parting(agg, models, designs, target):
    """(ok, note) for two Aggregator models trained on the same frame on
    two devices, with their designs: equal exemplars and counts, or the
    first radius pass at which their searches differ, run again on both
    designs, parts first at a row within rounding of the radius or of a
    tie (ROADMAP C25)."""
    a, b = models
    if (np.array_equal(a.exemplar_rows, b.exemplar_rows)
            and np.array_equal(a.counts, b.counts)):
        return True, "bitwise equal"
    pa, pb = a.search_path, b.search_path
    k = next((i for i, (u, v) in enumerate(zip(pa, pb)) if u != v),
             len(pa) - 1)
    radius = pa[k][0]
    X = designs[1].cpu().numpy()
    runs = [agg._radius_pass(X, Xd, radius, None if k == 19 else target)
            for Xd in designs]
    f, near = _first_parting(X, runs[0], runs[1], radius)
    return f is not None and near, (
        f"pass {k + 1} of {len(pa)} / {len(pb)} parts first at row {f}, "
        f"{'within' if near else 'NOT within'} rounding of the radius or "
        "of a tie")


def _first_parting(X, a, b, radius):
    """The first row at which two Aggregator passes `a` and `b`
    ((exemplar rows, assignments)) over the design X part: one admits it
    and the other does not, or they assign it differently; or None. And
    whether that row lies, in float64, within rounding (2**-16 of the
    squared norms) of the radius from the exemplar either pass gave it,
    or equally far from both."""
    (ex_a, as_a), (ex_b, as_b) = a, b
    n = X.shape[0]
    adm_a, adm_b = np.zeros(n, bool), np.zeros(n, bool)
    adm_a[ex_a], adm_b[ex_b] = True, True
    diff = np.flatnonzero((adm_a != adm_b) | (as_a != as_b))
    if not len(diff):
        return None, True
    f = int(diff[0])
    x = X[f].astype(np.float64)
    r2 = radius * radius
    ds, sizes = [], [x @ x]
    for adm, ex, asg in ((adm_a, ex_a, as_a), (adm_b, ex_b, as_b)):
        if not adm[f]:
            e = X[ex[asg[f]]].astype(np.float64)
            ds.append(float(((e - x) ** 2).sum()))
            sizes.append(e @ e)
    tol = 2.0**-16 * (max(sizes) + r2)
    near = any(abs(v - r2) <= tol for v in ds) or (
        len(ds) == 2 and abs(ds[0] - ds[1]) <= tol)
    return f, near


def _small_ensemble(h2o, fr):
    """An AUTO StackedEnsemble over a 3-fold GBM (2 trees of depth 3)
    and GLM -> its P(class 1) on `fr`."""
    kw = dict(nfolds=3, seed=1, keep_cross_validation_predictions=True)
    bases = [h2o.GBM(ntrees=2, max_depth=3, **kw).train(
        y="y", training_frame=fr), h2o.GLM(lambda_=0.0, **kw).train(
            y="y", training_frame=fr)]
    se = h2o.StackedEnsemble(base_models=bases).train(y="y",
                                                      training_frame=fr)
    return se.predict(fr).col("Y").data.cpu().numpy()


def host_profile(label, train, top=10):
    """Host time by function of the port (cumulative, cProfile) over one
    call of `train`."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    train()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    total = st.total_tt
    rows = sorted(((ct, nc, f"{Path(fn).name}:{ln}({name})")
                   for (fn, ln, name), (_, nc, _, ct, _) in st.stats.items()
                   if "h2o3_tpu_torch" in fn), reverse=True)
    print(f"host profile {label}: {total * 1e3:.1f} ms under cProfile")
    for ct, nc, where in rows[:top]:
        print(f"  {ct * 1e3:9.1f} ms {100 * ct / total:5.1f}% x{nc:<5d} "
              f"{where}")


def device_time(train):
    """(device-busy us, device ops) of one call of `train` under
    torch.profiler, read from the raw trace: a long train records
    millions of kernels, too many to aggregate through key_averages()."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    busy_ns = n_ops = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            busy_ns += e.duration_ns()
            n_ops += 1
    return busy_ns / 1e3, n_ops


def phase_profile(label, train, top=12, wall_s=None):
    """Where a train's time goes: device time by kernel from
    torch.profiler over one call of `train`, the device-busy share of
    the same train's unprofiled wall time (`wall_s` when the caller has
    just timed it), and the host time by function."""
    from torch.profiler import ProfilerActivity, profile

    if wall_s is None:
        _, wall_s = _timed(train)
    wall_us = wall_s * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train()
        torch.cuda.synchronize()
    # summed by kernel from the raw trace: key_averages() would first
    # parse every event into the autograd tree, seconds for a train of
    # tens of thousands of launches
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            us, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, count + 1)
    rows = [(us, count, key) for key, (us, count) in by_name.items()]
    busy_us = sum(r[0] for r in rows)
    n_ops = sum(r[1] for r in rows)
    if busy_us <= 0:
        print("profile: the profiler recorded no device time (not measured)")
    else:
        print(f"profile {label}: unprofiled wall {wall_us / 1e3:.1f} ms, "
              f"device busy {busy_us / 1e3:.1f} ms = "
              f"{100 * busy_us / wall_us:.1f}% of it, {n_ops} device ops")
    # the top rows, then the port's own kernels wherever they rank
    for rank, (dev_us, count, key) in enumerate(sorted(rows, reverse=True)):
        if rank < top or "hist_" in key:
            print(f"  {dev_us / 1e3:9.3f} ms {100 * dev_us / busy_us:5.1f}% "
                  f"x{count:<6d} {key[:90]}")
    host_profile(label, train)
    return busy_us, n_ops


def phase_leaf_sums(h2o, fr, reps=5):
    """The grower's two per-tree sums at the flagship's inputs (those of
    its first tree, captured from a one-tree train): the leaf sums and
    the response mean, as the grower computes them since the row mesh
    (order-free int64 fixed-point sums, core/ops.fixed_point_group_sums)
    and as it did before (a sorted float64 scan, core/ops.segment_sum,
    and two float64 torch.sum calls), each the median
    device-busy time of `reps` calls under torch.profiler. Returns the
    two totals (ms a tree: fixed point, scan)."""
    from h2o3_tpu_torch.core import ops
    from h2o3_tpu_torch.models.tree import device_tree as dtree

    seen = {}
    real_leaf, real_sums = dtree.leaf_sums, dtree.fixed_point_sums

    def grab_leaf(row_leaf, cols, tot_slots, mesh=None):
        seen.setdefault("leaf", (row_leaf.clone(), cols.clone(), tot_slots))
        return real_leaf(row_leaf, cols, tot_slots, mesh)

    def grab_sums(vals, mesh=None):
        seen.setdefault("ymean", vals.clone())
        return real_sums(vals, mesh)

    dtree.leaf_sums, dtree.fixed_point_sums = grab_leaf, grab_sums
    try:
        h2o.GBM(ntrees=1, max_depth=FLAGSHIP["max_depth"]).train(
            y="y", training_frame=fr)
    finally:
        dtree.leaf_sums, dtree.fixed_point_sums = real_leaf, real_sums
    row_leaf, cols, tot = seen["leaf"]
    wy_w = seen["ymean"]
    idx = torch.clamp_max(torch.where(row_leaf >= 0, row_leaf, tot),
                          tot).long()
    calls = {
        "leaf_sums fixed point": lambda: real_leaf(row_leaf, cols, tot),
        "leaf_sums float64 scan": lambda: ops.segment_sum(
            idx, cols, tot + 1)[:tot],
        "ymean fixed point": lambda: real_sums(wy_w),
        "ymean float64 torch.sum": lambda: (
            torch.sum(wy_w[:, 0]) / torch.clamp_min(torch.sum(wy_w[:, 1]),
                                                    1e-12)),
    }
    ms = {}
    for name, fn in calls.items():
        fn()
        ms[name] = float(np.median([device_time(fn)[0]
                                    for _ in range(reps)])) / 1e3
        print(f"time {name} ({cols.shape[0]} rows, {cols.shape[1]} "
              f"columns, {tot} slots): {ms[name]!r} ms device")
    fixed = ms["leaf_sums fixed point"] + ms["ymean fixed point"]
    scan = ms["leaf_sums float64 scan"] + ms["ymean float64 torch.sum"]
    print(f"leaf sums + response mean a tree: fixed point {fixed!r} ms, "
          f"float64 scan {scan!r} ms (device)")
    return fixed, scan


def _forest_arrays(m):
    fo = m.forest
    return {k: np.asarray(getattr(fo, k)) for k in
            ("feat", "thresh_bin", "na_left", "left", "right", "cat_split")}


def _forest_bits(m):
    """A forest's arrays, leaf values included, on the host."""
    return dict(_forest_arrays(m), leaf_val=np.asarray(m.forest.leaf_val))


def _oob_bits(m):
    tm = m._output.training_metrics
    return np.array([tm.auc, tm.logloss, tm.rmse, tm.nobs], np.float64)


def _combo(m):
    return str(sorted(m._grid_params.items()))


def _grid_table(g):
    """A grid's leaderboard: (combo, training AUC) in rank order."""
    return [(str(sorted((k, v) for k, v in r.items()
                        if k not in ("model_id", "auc"))), r["auc"])
            for r in g.sorted_metric_table("auc")]


def _margins_of(sess, fr):
    """A session's margins of `fr`'s rows (a device tensor)."""
    return sess._margin_x(sess._features(sess.model.adapt_test(fr)))


def _same_bits(label, got, want):
    check(got.shape == want.shape and same_bits(got, want),
          f"{label}: not bitwise equal")


def _frames_same(label, a, b):
    _same_predictions(label, {nm: a.col(nm).data.cpu().numpy()
                              for nm in a.names},
                      {nm: b.col(nm).data.cpu().numpy() for nm in b.names})


def _concurrent(fn, frames):
    """fn(frame) from one thread per frame, started together; returns
    (results, errors) in frame order."""
    import threading

    out, errs = [None] * len(frames), [None] * len(frames)
    barrier = threading.Barrier(len(frames))

    def worker(i):
        barrier.wait(timeout=60)
        try:
            out[i] = fn(frames[i])
        except Exception as e:   # noqa: BLE001 — each request's own error
            errs[i] = e

    ths = [threading.Thread(target=worker, args=(i,))
           for i in range(len(frames))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in ths), "a request thread hung")
    return out, errs


@contextlib.contextmanager
def _env(**kw):
    """Environment knobs set for the block, restored after it."""
    import os

    saved = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _serving_session(h2o, dev, fr, gbm):
    """Step 1: run_scoring's request sizes through the flagship's
    session; step 2: the micro-batcher and admission."""
    from h2o3_tpu_torch import admission, scoring
    from h2o3_tpu_torch.ops.filters import take_rows

    c = SERVING
    scoring.purge()
    sess = scoring.session_for(gbm)
    check(sess.device.type == "cuda", f"session on {sess.device}")
    frames = [take_rows(fr, np.arange(n)) for n in c["sizes"]]
    for sub in frames:                       # warm every bucket
        want = gbm._margin(gbm.adapt_test(sub))
        for _ in range(2):                   # the eager run, then a replay
            _same_bits(f"session margins ({sub.nrows} rows)",
                       _margins_of(sess, sub), want)
        _frames_same(f"session predict ({sub.nrows} rows)",
                     sess.predict(sub), gbm.predict(sub))
    preds = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(c["passes"]):
        for sub in frames:
            preds.append(sess.predict(sub))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rows = c["passes"] * sum(c["sizes"])
    metric("score_rows_per_sec", rows / dt,
           f"({c['passes']} passes of {list(c['sizes'])} rows, {dt!r} s)")
    check(sess.fused_compiles <= len(sess.buckets),
          f"{sess.fused_compiles} captures for {len(sess.buckets)} buckets")
    print(f"session: {sess.fused_compiles} CUDA-graph captures, buckets "
          f"{list(sess.buckets)}")
    big, t_big = _timed(lambda: _margins_of(sess, fr))
    _same_bits("1M-row request margins", big, gbm._margin(gbm.adapt_test(fr)))
    _, t_big = _timed(lambda: sess.predict(fr).delete())
    metric("score_1m_s", t_big, f"({fr.nrows} rows in windows of "
                                f"{sess.buckets[-1]})")
    for p in preds:
        p.delete()
    x16 = sess._features(gbm.adapt_test(frames[-1]))
    phase_profile(f"session dispatch ({frames[-1].nrows} rows, graph "
                  "replay)", lambda: sess._margin_x(x16))
    phase_profile(f"eager walk ({frames[-1].nrows} rows)",
                  lambda: gbm._margin(gbm.adapt_test(frames[-1])))

    small = [take_rows(fr, np.arange(i * c["small_rows"],
                                     (i + 1) * c["small_rows"]))
             for i in range(c["conc"])]
    alone = [sess.predict(sub) for sub in small]
    s0 = sess.stats.snapshot()
    for r in range(c["rounds"]):
        got, errs = _concurrent(
            lambda sub: scoring.BATCHER.submit(gbm, sub)[0], small)
        check(not any(errs), f"batcher round {r}: {errs}")
        for a, b in zip(got, alone):
            _frames_same(f"coalesced request vs alone (round {r})", a, b)
            a.delete()
    s1 = sess.stats.snapshot()
    flushes = s1["batches"] - s0["batches"]
    dpf = (s1["dispatches"] - s0["dispatches"]) / max(flushes, 1)
    metric("score_dispatches_per_flush", dpf,
           f"({flushes} flushes of {c['rounds']} x {c['conc']} requests)")
    metric("score_p99_ms", s1.get("p99_ms", 0.0))
    check(dpf <= 2.0, f"{dpf} dispatches per flush: coalescing regressed")
    for a in alone:
        a.delete()

    admission.CONTROLLER.reset()
    with _env(H2O_TPU_SCORE_MAX_INFLIGHT=1, H2O_TPU_SCORE_QUEUE_CAP=2):
        got, errs = _concurrent(
            lambda sub: scoring.score_request(gbm, sub)[0], small)
    shed = [e for e in errs if e is not None]
    check(shed and all(isinstance(e, admission.AdmissionRejected)
                       for e in shed), f"admission: {shed[:3]}")
    served = [(sub, p) for sub, p in zip(small, got) if p is not None]
    for sub, p in served:
        _frames_same("admitted request", p, gbm.predict(sub))
        p.delete()
    print(f"admission: {len(shed)} of {len(small)} requests shed "
          f"(status {shed[0].status}, Retry-After "
          f"{shed[0].retry_after_s:.3f} s), {len(served)} served bitwise; "
          f"{admission.CONTROLLER.snapshot()['rejected']} rejected")
    admission.CONTROLLER.reset()
    return sess


def _serving_memory(h2o, dev, fr, gbm, sess):
    """Step 3: the budgeted run, the injected ladder and a real OOM."""
    from h2o3_tpu_torch import scoring
    from h2o3_tpu_torch.core import failure
    from h2o3_tpu_torch.memory import budget, stream
    from h2o3_tpu_torch.models.tree.compressed import ResidentForest

    c = SERVING
    want = _margins_of(sess, fr)
    with _env(H2O_TPU_MEM_BUDGET_MB=c["mem_budget_mb"]):
        stream.reset_counters()
        got, t = _timed(lambda: _margins_of(sess, fr))
        sc = stream.counters()
    _same_bits("budgeted (streamed) margins", got, want)
    check(sc["chunked_runs"] >= 1 and sc["windows"] > 1,
          f"a {c['mem_budget_mb']} MB budget did not stream: {sc}")
    print(f"budget {c['mem_budget_mb']} MB: {sc['windows']} windows, "
          f"{t:.3f} s, bitwise equal to the unbudgeted run")
    stream.reset_counters()
    with failure.inject("mem.exhausted", times=2):
        got, t = _timed(lambda: _margins_of(sess, fr))
    sc = stream.counters()
    _same_bits("ladder-recovered margins", got, want)
    check(sc["ladder_recoveries"] == 1, f"injected OOMs: {sc}")
    metric("mem_degrade_recover_s", t, "(two injected OOMs, 1M rows)")
    metric("mem_ladder_halvings", sc["ladder_halvings"])

    # a real OOM: a session whose largest bucket needs more than the
    # capped process can allocate, while half of it fits
    res = ResidentForest(gbm.forest, gbm.spec, dev)
    X = gbm._features(gbm.adapt_test(fr))
    need = {}
    for n in c["oom_buckets"]:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        res.margins(X[:n])
        need[n] = torch.cuda.max_memory_allocated(dev) - base
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    small, big = c["oom_buckets"]
    allow = 2 * need[small] + (64 << 20)
    check(allow < need[big], f"working sets {need} leave no room to "
                             "separate the buckets")
    total = torch.cuda.mem_get_info(dev)[1]
    cap = (torch.cuda.memory_reserved(dev) + allow) / total
    stream.reset_counters()
    with _env(H2O_TPU_SCORE_BUCKETS=",".join(map(str, c["oom_buckets"]))):
        oom_sess = scoring.ScoringSession(gbm)
    torch.cuda.set_per_process_memory_fraction(cap, dev)
    try:
        got, t = _timed(lambda: oom_sess._margin_x(X))
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    sc = stream.counters()
    _same_bits("real-OOM-recovered margins", got, want)
    check(sc["ladder_recoveries"] >= 1 and sc["ladder_halvings"] >= 1,
          f"the capped run raised no OutOfMemoryError: {sc}")
    print(f"real OOM: working sets {need} bytes, cap {cap:.4f} of "
          f"{total} bytes; the ladder recovered ({sc}), {t:.3f} s, "
          "bitwise")
    budget.reset_pressure()


def _serving_cleaner(h2o, dev, fr, gbm, sess, tmp):
    """Step 4: evict the frames' columns, fault them back in, spill."""
    from h2o3_tpu_torch.core import cleaner
    from h2o3_tpu_torch.persist import spill

    want = sess.predict(fr)
    fr.install()
    before = cleaner.device_bytes_in_use()
    freed, t = _timed(lambda: cleaner.sweep(before))
    count = cleaner.evicted_count()
    check(all(fr._cols[nm].is_evicted for nm in fr.names),
          "the sweep left a flagship column on the card")
    metric("evicted_count", count, f"({freed} bytes in {t:.3f} s)")
    _frames_same("predictions after fault-in", sess.predict(fr), want)
    check(not any(fr._cols[nm].is_evicted for nm in gbm._output.names),
          "a predict left a feature column evicted")
    col = fr._cols["n0"]
    data = col.data.clone()
    spill.spill_column(col, "n0")
    check(col.is_evicted and callable(col._evicted), "n0 did not spill")
    check(torch.equal(fr.col("n0").data, data), "n0 reloaded differently")
    print(f"spill: n0 round trip through {spill.spill_dir()} bitwise")
    want.delete()


def _runner_subprocess(art, csv_path, out_dir, device):
    """The standalone runner in a fresh process on `device`: (cold start
    from spawn to the first prediction, requests per second over
    SERVING['sustain_s'] at 256 rows, its raw.npz)."""
    import os

    code = (
        "import time\n"
        "start = time.time()\n"
        "import json, runpy, sys\n"
        "g = runpy.run_path(sys.argv[1])\n"
        "imported = time.time()\n"
        "art, csv, out, dev = sys.argv[2:6]\n"
        "g['main'](['--artifact', art, '--input', csv, '--output',\n"
        "           out + '/out.csv', '--raw-npz', out + '/raw.npz',\n"
        "           '--device', dev])\n"
        "first = time.time()\n"
        "s = g['load_artifact'](art, dev)\n"
        "X = s.pack_features(g['read_csv_columns'](csv))\n"
        "s.raw_predict(X)\n"
        "n, t0 = 0, time.perf_counter()\n"
        f"while time.perf_counter() - t0 < {SERVING['sustain_s']}:\n"
        "    s.raw_predict(X)\n"
        "    n += 1\n"
        "qps = n / (time.perf_counter() - t0)\n"
        "mods = sorted(k for k in sys.modules if k.startswith('h2o3'))\n"
        "print(json.dumps({'start': start, 'imported': imported,\n"
        "                  'first': first, 'qps': qps, 'n': n,\n"
        "                  'modules': mods}))\n")
    runner = Path(__file__).resolve().parent / "h2o3_tpu_torch" / \
        "artifact" / "runner.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    spawn = time.time()
    proc = subprocess.run([sys.executable, "-c", code, str(runner), art,
                           csv_path, out_dir, device], capture_output=True,
                          text=True, timeout=300, cwd=out_dir, env=env)
    check(proc.returncode == 0, f"runner process failed: "
                                f"{proc.stderr[-3000:]}")
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    check(rep["modules"] == [], f"the runner imported {rep['modules']}")
    print(f"runner process: interpreter up {rep['start'] - spawn:.3f} s, "
          f"runner and torch imported {rep['imported'] - rep['start']:.3f} "
          f"s, first prediction {rep['first'] - rep['imported']:.3f} s "
          f"later; {rep['n']} requests in {SERVING['sustain_s']} s")
    return rep["first"] - spawn, rep["qps"], os.path.join(out_dir, "raw.npz")


def _serving_artifacts(h2o, dev, fr, gbm, glm, sess, tmp):
    """Step 5: export, load in process, the runner in a fresh process."""
    import os

    from h2o3_tpu_torch import artifact
    from h2o3_tpu_torch.ops.filters import take_rows

    c = SERVING
    art = os.path.join(tmp, "gbm_artifact")
    man, t_exp = _timed(lambda: artifact.export_model(
        gbm, art, buckets=c["artifact_buckets"]))
    metric("artifact_export_s", t_exp,
           f"(flagship GBM, buckets {c['artifact_buckets']}, "
           f"{sum(e['bytes'] for e in man['programs'])} program bytes)")
    gart = os.path.join(tmp, "glm_artifact")
    _, t_glm = _timed(lambda: artifact.export_model(
        glm, gart, buckets=c["artifact_buckets"]))
    print(f"GLM artifact export {t_glm:.3f} s")
    want = _margins_of(sess, fr)
    loaded = artifact.load_model(art, model_id="chip_smoke_artifact_gbm")
    _same_bits("artifact loaded in process: margins",
               loaded._margin(loaded.adapt_test(fr)), want)
    gl = artifact.load_model(gart, model_id="chip_smoke_artifact_glm")
    _frames_same("GLM artifact loaded in process", gl.predict(fr),
                 glm.predict(fr))
    loaded.delete()
    gl.delete()

    n = c["batch_rows"]
    sub = take_rows(fr, np.arange(n))
    cols = {}
    for nm in gbm._output.names:
        col = sub.col(nm)
        v = col.data.cpu().numpy()
        cols[nm] = (np.asarray(col.domain, object)[v] if col.domain
                    else [repr(float(x)) for x in v])
    csv_path = os.path.join(tmp, "batch.csv")
    with open(csv_path, "w") as f:
        f.write(",".join(cols) + "\n")
        for i in range(n):
            f.write(",".join(str(cols[nm][i]) for nm in cols) + "\n")
    cold, qps, raw = _runner_subprocess(art, csv_path, tmp, dev.type)
    metric("artifact_cold_start_s", cold, "(fresh process, spawn to the "
                                          "first prediction)")
    metric("artifact_qps", qps, f"({n} rows a request)")
    with np.load(raw) as z:
        _same_bits("runner margins (card) vs in-process serving",
                   torch.from_numpy(z["margins"]),
                   _margins_of(sess, sub).cpu())
    runner = _load_runner()
    gs = runner.load_artifact(gart, dev.type)
    X = gs.pack_features({k: list(v) for k, v in cols.items()})
    got = gs.raw_predict(X)["probs"][:, 1]
    ref = glm.predict(sub).col("Y").data.cpu().numpy()
    gap = float(np.abs(got - ref).max())
    check(gap <= GLM_ARTIFACT_ATOL, f"GLM runner vs predict: {gap}")
    print(f"GLM runner (card) vs in-process predict: max gap {gap:.3e} "
          f"({'bitwise' if gap == 0.0 else 'ROADMAP C30'})")
    return art


def _load_runner():
    import importlib.util

    path = Path(__file__).resolve().parent / "h2o3_tpu_torch" / \
        "artifact" / "runner.py"
    spec = importlib.util.spec_from_file_location("artifact_runner", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_serving(h2o, dev, fr, gbm, glm, tmp):
    """Serving on the card (phase 3s) over the flagship GBM and phase
    3r's GLM: the bucketed session on CUDA graphs at run_scoring's
    request sizes and one 1M-row request, coalesced and admission-
    controlled requests, the memory planner and its ladder (a 2 MB
    budget, injected OOMs, a real OutOfMemoryError under a capped
    allocator), the cleaner and spill, and the standalone artifacts.
    Every response is held bit for bit. Launches no histogram kernel;
    returns (launches, the GBM artifact's directory)."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    hg.launches = 0
    sess = _serving_session(h2o, dev, fr, gbm)
    _serving_memory(h2o, dev, fr, gbm, sess)
    _serving_cleaner(h2o, dev, fr, gbm, sess, tmp)
    art = _serving_artifacts(h2o, dev, fr, gbm, glm, sess, tmp)
    launches = hg.launches
    check(launches == 0, f"phase 3s launched the histogram kernel "
                         f"{launches} times")
    return launches, art


def phase_card_vs_cpu_serving(h2o, dev, art):
    """Session margins on SERVING['cvc_rows'] flagship rows on the card
    and on the CPU (bitwise), and the card-exported artifact scored by
    the runner on the CPU: margins bitwise, probabilities to C29's 1e-6."""
    from h2o3_tpu_torch import artifact, scoring

    n = SERVING["cvc_rows"]
    gbm = artifact.load_model(art, install=False)
    card = _margins_of(scoring.ScoringSession(gbm),
                       flagship_frame(h2o, dev, n)).cpu()
    cpu_fr = flagship_frame(h2o, torch.device("cpu"), n)
    h2o.init(device="cpu")
    try:
        cpu = _margins_of(scoring.ScoringSession(gbm), cpu_fr)
    finally:
        h2o.init()
    _same_bits("session margins card vs CPU", card, cpu)
    s = _load_runner().load_artifact(art, "cpu")
    X = gbm._features(gbm.adapt_test(cpu_fr)).numpy()
    _same_bits("card-exported artifact on the CPU runner: margins",
               torch.from_numpy(s.margins(X)), card)
    probs = s.raw_predict(X)["probs"]
    ref = gbm._margin_to_raw(card)["probs"].numpy()
    gap = float(np.abs(probs - ref).max())
    check(gap <= PDP_CVC_ATOL, f"runner CPU vs card probabilities: {gap}")
    print(f"card vs cpu serving ({n} rows): session margins bitwise, "
          f"runner --device cpu margins bitwise, probabilities within "
          f"{gap:.3e}")


def phase_card_vs_cpu(h2o, dev, parse_path):
    """The same port on the card and on the CPU imports the same columns
    and grows the same models."""
    cpu = torch.device("cpu")
    same_frames("run_parse file imported on the card vs the CPU",
                h2o.import_file(parse_path),
                h2o.import_file(parse_path, device="cpu"))
    print("card vs cpu run_parse import: columns bitwise equal")
    supervised = lambda b: lambda fr: b.train(y="y", training_frame=fr)
    xgb = dict(ntrees=5, seed=1)
    cases = [
        ("600-row fixture", lambda d: small_frame(h2o, d),
         supervised(h2o.GBM(ntrees=4, max_depth=3, seed=3)), "Y"),
        ("50k flagship rows", lambda d: flagship_frame(h2o, d, 50_000),
         supervised(h2o.GBM(ntrees=5, max_depth=FLAGSHIP["max_depth"],
                            seed=1)), "Y"),
        ("DRF 20k deep-stage rows", lambda d: drf_deep_frame(h2o, d, 20_000),
         supervised(h2o.DRF(ntrees=3, max_depth=12, seed=1)), "Y"),
        ("multinomial GBM 5k rows",
         lambda d: multinomial_frames(h2o, d, 5_000, 0)[0],
         supervised(h2o.GBM(ntrees=5, max_depth=5, sample_rate=0.8,
                            col_sample_rate=0.8, seed=1)), "k0"),
        ("XGBoost gbtree 50k flagship rows",
         lambda d: flagship_frame(h2o, d, 50_000),
         supervised(h2o.XGBoost(**xgb)), "Y"),
        ("XGBoost dart 50k flagship rows",
         lambda d: flagship_frame(h2o, d, 50_000),
         supervised(h2o.XGBoost(booster="dart", rate_drop=0.3, **xgb)), "Y"),
        ("IsolationForest 50k outlier rows",
         lambda d: outlier_frame(h2o, d, 50_000, ISOFOR["outlier_frac"],
                                 ISOFOR["shift"])[0],
         lambda fr: h2o.IsolationForest(seed=1).train(training_frame=fr),
         "predict"),
        ("Extended IF 50k outlier rows",
         lambda d: outlier_frame(h2o, d, 50_000, ISOFOR["outlier_frac"],
                                 ISOFOR["shift"])[0],
         lambda fr: h2o.ExtendedIsolationForest(
             ntrees=20, extension_level=14, seed=1).train(training_frame=fr),
         "predict")]
    n = 50_000
    for kind, fam, extra in (("real", "gaussian", {}),
                             ("count", "poisson", {}),
                             ("tweedie", "tweedie", {}),
                             ("real", "gaussian", {"lambda_search": True,
                                                   "alpha": 0.5})):
        label = f"GLM {fam}{' lambda search' if extra else ''} {n // 1000}k"
        cases.append((label, lambda d, k=kind: regression_frame(h2o, d, n, k),
                      supervised(h2o.GLM(family=fam, **extra)), "predict"))
    cases += [
        (f"GLM binomial {n // 1000}k flagship rows",
         lambda d: flagship_frame(h2o, d, n),
         supervised(h2o.GLM(family="binomial")), "Y"),
        (f"GLM multinomial {n // 1000}k", lambda d: multinomial_frames(
            h2o, d, n, 0)[0], supervised(h2o.GLM(family="multinomial")),
         "k0"),
        (f"GLM ordinal {n // 1000}k", lambda d: multinomial_frames(
            h2o, d, n, 0)[0], supervised(h2o.GLM(family="ordinal")), "k3"),
        (f"GAM bs 0-3 {n // 1000}k flagship rows",
         lambda d: flagship_frame(h2o, d, n),
         supervised(h2o.GAM(gam_columns=["n0", "n1", "n2", "n3"],
                            bs=[0, 1, 2, 3])), "Y"),
        (f"RuleFit {n // 1000}k flagship rows",
         lambda d: flagship_frame(h2o, d, n),
         supervised(h2o.RuleFit(rule_generation_ntrees=20, seed=1)), "Y")]
    for label, make, fit, col in cases:
        models, preds = [], []
        for d in (dev, cpu):
            fr = make(d)
            m = fit(fr)
            models.append(m)
            preds.append(m.predict(fr).col(col).data.cpu().numpy())
        if hasattr(models[0], "glm_model") or hasattr(models[0], "beta"):
            _glm_card_vs_cpu(label, models, preds)
            continue
        a, b = (_model_arrays(m) for m in models)
        for k in a:
            check(np.array_equal(a[k], b[k]), f"{label}: {k} differs "
                                              "between card and CPU")
        diff = float(np.abs(preds[0] - preds[1]).max())
        check(diff <= PRED_ATOL, f"{label}: card vs CPU predictions differ "
                                 f"by {diff}")
        size = (f"{models[0].forest.n_trees} trees" if hasattr(
            models[0], "forest") else f"{models[0].normals.shape[0]} trees")
        print(f"card vs cpu {label}: {size}, models equal, max pred diff "
              f"{diff:.3e}")


def _glm_card_vs_cpu(label, models, preds):
    """A GLM-family model on the card against the CPU: GLM coefficients
    within GLM_COEF_TOL and predictions within GLM_PRED_ATOL; GAM's knots
    and RuleFit's forests and rules equal, their fitted values within
    C10_PRED_ATOL (ill-conditioned designs, ROADMAP C10)."""
    card, host = models
    diff = float(np.abs(preds[0] - preds[1]).max())
    if hasattr(card, "beta"):
        ca, cb = card.coef(), host.coef()
        check(list(ca) == list(cb), f"{label}: coefficient names differ")
        gap = max(float(np.max(np.abs(np.asarray(ca[k]) - np.asarray(cb[k]))))
                  for k in ca)
        for k in ca:
            check(np.allclose(ca[k], cb[k], **GLM_COEF_TOL),
                  f"{label}: coefficient {k} differs, {ca[k]} vs {cb[k]}")
        check(diff <= GLM_PRED_ATOL, f"{label}: predictions differ by "
                                     f"{diff}")
        print(f"card vs cpu {label}: iterations {card.iterations} / "
              f"{host.iterations}, max coef diff {gap:.3e}, max pred diff "
              f"{diff:.3e}")
        return
    if hasattr(card, "knots"):
        for k in card.knots:
            check(np.array_equal(card.knots[k], host.knots[k]),
                  f"{label}: knots of {k} differ")
        what = f"knots equal ({len(card.knots)} columns)"
    else:
        for ta, tb in zip(card.tree_models, host.tree_models):
            a, b = _forest_arrays(ta), _forest_arrays(tb)
            for k in a:
                check(np.array_equal(a[k], b[k]), f"{label}: forest {k} "
                                                  "differs")
        check(sorted((r["name"], r["rule"]) for r in card.rules)
              == sorted((r["name"], r["rule"]) for r in host.rules),
              f"{label}: rules differ")
        what = f"forests and {len(card.rules)} rules equal"
    check(diff <= C10_PRED_ATOL, f"{label}: predictions differ by {diff}")
    print(f"card vs cpu {label}: {what}, max pred diff {diff:.3e}")


def _model_arrays(m):
    """The arrays that define a model's structure: a forest's, or an
    Extended IF's packed trees (with the leaf path lengths)."""
    if hasattr(m, "forest"):
        return _forest_arrays(m)
    return {k: getattr(m, k) for k in ("normals", "offsets", "lefts",
                                       "rights", "values")}


def _time_ms(fn, flush, reps=5):
    """Best of `reps` device times of fn() after a warm-up, each launch
    preceded by an L2 flush so the inputs come from device memory."""
    fn()
    best = float("inf")
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best


def _time_shape(dev, lib, flush, rate, label, arrays, bdt, S):
    """Kernel, plain version and library call at one level shape, the
    bound, and the kernel's passes each alone through the same C entry
    point. `arrays` is (binned, node, w, y, offsets, TB). Timing launches
    are not main-path launches."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    *arrays, TB = arrays
    b, nd, w, y, off = _to(dev, *arrays, bin_dtype=bdt)
    n, F = b.shape
    kw = dict(offsets=off, TB=TB, S=S)
    live = nd >= 0
    idx = (nd[live].long()[:, None] * TB + off.long()[None, :]
           + b[live].long()).reshape(-1)
    wl, yl = w[live], y[live]
    vals = torch.stack([wl, wl * yl, wl * yl * yl], -1)
    vals = vals[:, None, :].expand(-1, F, 3).reshape(-1, 3).contiguous()
    saved = hg.launches
    k_ms = _time_ms(lambda: hg.hist_gather(b, nd, w, y, **kw), flush)
    hg.launches = saved
    p_ms = _time_ms(lambda: hg.hist_gather_ref(b, nd, w, y, **kw), flush)
    l_ms = _time_ms(lambda: torch.zeros(S * TB, 3, device=dev).index_put_(
        (idx,), vals, accumulate=True), flush)
    tile_S, n_tiles = hg.plan_tiles(TB, S)
    scratch = torch.zeros(2 + S * TB * 3, dtype=torch.int64, device=dev)
    out = torch.empty(S * TB, 3, dtype=torch.float32, device=dev)

    def run(passes):
        err = hg.launch(lib, b, nd, w, y, off, scratch, out, TB=TB, S=S,
                        tile_S=tile_S, n_tiles=n_tiles, passes=passes)
        check(err == 0, f"hist_gather passes={passes}: CUDA error {err}")

    run(hg.ALL_PASSES)
    split = [_time_ms(lambda p=p: run(p), flush)
             for p in (hg.PASS_SCALE, hg.PASS_ACCUMULATE, hg.PASS_FINALISE)]
    # bytes the function must move for this data: every row's node;
    # bins, w and y of the rows inside [0, S); offsets; the output
    n_live = int(((nd >= 0) & (nd < S)).sum())
    nbytes = 4 * n + n_live * (F * b.element_size() + 8) + 4 * F + 12 * S * TB
    ops = 3 * n_live * F
    bound_ms = max(nbytes / rate, ops / F32_PEAK) * 1e3
    print(f"time hist_gather {label} n={n} F={F} TB={TB} S={S} "
          f"{b.dtype}: kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} "
          f"us, library index_put_ {l_ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.1f} MB at "
          f"{rate / 1e12:.2f} TB/s)")
    print(f"  passes alone: scale {split[0] * 1e3:.1f} us, accumulate "
          f"{split[1] * 1e3:.1f} us, finalise {split[2] * 1e3:.1f} us "
          f"(tile_S={tile_S}, {n_tiles} tiles)")
    return (k_ms, p_ms, l_ms, bound_ms), split


def _means(dev, lib, flush, rate, label, cases):
    """Times at each (arrays, bin dtype, S) case and their means. Returns
    (mean of kernel/plain/library/bound, kernel time per case)."""
    rows, splits = [], []
    for arrays, bdt, S in cases:
        r, sp = _time_shape(dev, lib, flush, rate, label, arrays, bdt, S)
        rows.append(r)
        splits.append(sp)
    mean = [float(np.mean([r[j] for r in rows])) for j in range(4)]
    pmean = [float(np.mean([s[j] for s in splits])) for j in range(3)]
    print(f"hist_gather mean per launch at the {label} shapes: kernel "
          f"{mean[0] * 1e3:.1f} us = {100 * mean[3] / mean[0]:.1f}% of the "
          f"bound; passes alone: scale {pmean[0] * 1e3:.1f} us, accumulate "
          f"{pmean[1] * 1e3:.1f} us, finalise {pmean[2] * 1e3:.1f} us")
    return mean, [r[0] for r in rows]


def _block(S, times, launches):
    mean, per_S = times
    return {"S": S, "ms": mean[0], "plain_ms": mean[1], "bound_ms": mean[3],
            "library_ms": mean[2], "ms_by_S": per_S, "launches": launches}


def phase_times(dev, launches, max_err):
    """Kernel, plain version and library call at the level shapes of the
    flagship, the deep DRF, XGBoost and IsolationForest, beside the
    bound, with the kernel's time split by pass. `launches` holds each
    main path's count."""
    from h2o3_tpu_torch import kernels

    name = torch.cuda.get_device_name(dev)
    rate = memory_rate(name)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=dev)
    lib = kernels.load("hist_gather")

    def grid(seed0, shapes):
        return [(hist_case(seed0 + i, *shape), np.uint8, shape[3])
                for i, shape in enumerate(shapes)]

    def levels(seed0, shapes):
        out = []
        for i, (kind, n, S) in enumerate(shapes):
            *arrays, TB, bdt = level_case(kind, seed0 + i, n, S)
            out.append(((*arrays, TB), bdt, S))
        return out

    flag = _means(dev, lib, flush, rate, "flagship",
                  grid(20, flagship_level_shapes()))
    drf = _means(dev, lib, flush, rate, "deep DRF",
                 grid(60, drf_level_shapes()))
    xgb = _means(dev, lib, flush, rate, "xgboost",
                 levels(100, xgb_level_shapes()))
    iso = _means(dev, lib, flush, rate, "isofor",
                 levels(120, isofor_level_shapes()))
    mean = flag[0]
    cross = _cross_rank_block(flag)
    return [{"name": "hist_gather", "route": "cuda",
             "source": "h2o3_tpu_torch/csrc/hist_gather.cu",
             "replaces": "h2o3_tpu/models/tree/pallas_hist.py:362",
             # the main paths of the flagship: phase 3's numpy-built frame,
             # phase 3l's frame imported from CSV, phase 3u's train over
             # POST /3/ModelBuilders/gbm, phase 3v's resume after the
             # kill and its grid's members trained after load, phase 3w's
             # bf16 frame
             "launches": int(launches["gbm_flagship"]
                             + launches["gbm_imported_csv"]
                             + launches["rest"] + launches["resume"]
                             + launches["grid_resume"] + launches["bf16"]
                             + launches["cloud"]
                             + launches["cloud_resume"]
                             + launches["sharded"] + launches["nccl"]
                             + launches["sharded_cv"]
                             + launches["sharded_xgb"]
                             + launches["sharded_automl"]
                             + launches["sharded_multinomial"]
                             + launches["sharded_automl_multiclass"]
                             + launches["sharded_cv_stratified"]),
             "max_abs_err": max_err,
             "ms": mean[0], "plain_ms": mean[1], "bound_ms": mean[3],
             "bound_by": "bytes", "library_ms": mean[2],
             "launches_by_path": launches,
             "drf_shapes": _block([s[3] for s in drf_level_shapes()], drf,
                                  int(launches["drf_deep"])),
             "xgb_shapes": _block([s[2] for s in xgb_level_shapes()], xgb,
                                  int(launches["xgboost"])),
             "isofor_shapes": _block([s[2] for s in isofor_level_shapes()],
                                     iso, int(launches["isolationforest"])),
             "cross_rank_shapes": cross}]


def _cross_rank_block(flag):
    """Phase 3y's cross-rank histogram times (n = 500k a rank, S = 1..16,
    two ranks on the card over gloo) beside the one-rank kernel at
    n = 1M: the three passes on the device clock, the two all-reduces on
    the host clock (staged through the host, the other rank's arrival
    included)."""
    rows0, rows1 = RUN["cross_rank_times"]
    steps = ("scale", "all_reduce_max", "accumulate", "all_reduce_sum",
             "finalise")
    for r0, r1 in zip(rows0, rows1):
        print(f"time hist_gather cross-rank n={r0['n']} a rank S={r0['S']}: "
              + ", ".join(f"{k} {r0['ms'][k] * 1e3:.1f}/{r1['ms'][k] * 1e3:.1f}"
                          for k in steps) + " us (rank 0/rank 1); bitwise "
              f"with the plain version {r0['bitwise'] and r1['bitwise']}")
    mean = {k: float(np.mean([r["ms"][k] for r in rows0])) for k in steps}
    print("hist_gather cross-rank mean per launch (rank 0): "
          + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in mean.items())
          + f"; passes {sum(mean[k] for k in steps[::2]) * 1e3:.1f} us "
          f"beside the one-rank kernel at n=1M {flag[0][0] * 1e3:.1f} us")
    x0, x1 = RUN["cross_rank_xgb"]
    for r0, r1 in zip(x0, x1):
        print(f"time hist_gather cross-rank XGBoost n={r0['n']} a rank "
              f"maxB 257 int16 S={r0['S']}: {r0['ms'] * 1e3:.1f}/"
              f"{r1['ms'] * 1e3:.1f} us a call (rank 0/rank 1, host clock, "
              f"all-reduces included); bitwise with the plain version "
              f"{r0['bitwise'] and r1['bitwise']}, max_abs_err "
              f"{max(r0['max_abs_err'], r1['max_abs_err'])!r}")
    return {"S": [r["S"] for r in rows0], "n_per_rank": rows0[0]["n"],
            "ms_mean": mean, "ms_by_S": [r["ms"] for r in rows0],
            "one_rank_ms": flag[0][0], "bitwise": all(
                r["bitwise"] for r in rows0 + rows1),
            "xgb_S": [r["S"] for r in x0], "xgb_maxB": 257,
            "xgb_bins": "int16", "xgb_call_ms_by_S": [r["ms"] for r in x0],
            "xgb_bitwise": all(r["bitwise"] for r in x0 + x1)}


# ---------------------------------------------------------------------------
# phase 0b: the port's invariant analyzer
# ---------------------------------------------------------------------------

def phase_analysis():
    """`python -m h2o3_tpu_torch.analysis --json` from the checkout's
    root (where triton and nvcc exist): exit 0, no finding."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "h2o3_tpu_torch.analysis",
                          "--json"], cwd=root, capture_output=True,
                         text=True, timeout=300)
    dt = time.perf_counter() - t0
    print(out.stderr[-2000:], end="")
    check(out.returncode == 0,
          f"the invariant analyzer exited {out.returncode}: "
          f"{out.stdout[-2000:]}")
    rep = json.loads(out.stdout)
    check(rep["findings"] == [] and rep["baseline_problems"] == [],
          f"analyzer findings {rep['findings'][:3]}")
    print(f"analysis_s {dt!r} (passes {rep['elapsed_s']} s, "
          f"{len(rep['baselined'])} baselined)")


# ---------------------------------------------------------------------------
# phase 3w: bf16 numeric storage (numeric_dtype="bfloat16")
# ---------------------------------------------------------------------------

def _frame_bytes(fr):
    """(numeric bytes, enum-code bytes) of a frame's device columns."""
    num = sum(c.device_nbytes for c in fr.columns if not c.is_categorical)
    cat = sum(c.device_nbytes for c in fr.columns if c.is_categorical)
    return num, cat


def _built(make):
    """(frame, rise of torch.cuda.memory_allocated while it was built)."""
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    fr = make()
    torch.cuda.synchronize()
    return fr, torch.cuda.memory_allocated() - m0


def _bf16_bits_equal(label, want32, got16):
    """`got16` (bf16) holds `want32` rounded to bf16: NaN as a mask, the
    other values bitwise."""
    want = want32.to(torch.bfloat16)
    na = torch.isnan(want)
    check(torch.equal(na, torch.isnan(got16)), f"{label}: NaN masks differ")
    check(torch.equal(want[~na].view(torch.int16),
                      got16[~na].view(torch.int16)),
          f"{label}: values differ from the float32 parse rounded to bf16")


def phase_bf16(h2o, dev, parse_path):
    """The storage opt-in at full width: the flagship frame, GBM and its
    scoring, the bench GLM, an import, a fused statement, card vs CPU.
    The opt-in is set on the runtime's options, as the reference's
    tests set it, and restored after."""
    from h2o3_tpu_torch import scoring
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from h2o3_tpu_torch.rapids import Env, fusion, planner
    from h2o3_tpu_torch.rapids.parser import parse

    args = h2o.cluster().args
    saved = args.numeric_dtype
    c = FLAGSHIP
    try:
        args.numeric_dtype = "float32"
        fr32, d32 = _built(lambda: flagship_frame(h2o, dev, c["n_rows"]))
        args.numeric_dtype = "bfloat16"
        fr16, d16 = _built(lambda: flagship_frame(h2o, dev, c["n_rows"]))
        (n32, k32), (n16, k16) = _frame_bytes(fr32), _frame_bytes(fr16)
        check(all(fr16.col(f"n{i}").data.dtype == torch.bfloat16
                  for i in range(c["n_num"])), "flagship numerics not bf16")
        metric("bf16_frame_bytes", n16 + k16,
               f"(float32 twin {n32 + k32}; numeric {n16} vs {n32}, enum "
               f"codes {k16} vs {k32}; memory_allocated rise {d16} vs "
               f"{d32})")
        check(2 * n16 == n32 and n32 == 4 * c["n_num"] * c["n_rows"],
              f"numeric bytes {n16} not half of {n32}")
        check(k16 == k32, f"enum code bytes changed: {k16} vs {k32}")

        # in turns (twin, bf16, bf16, twin), so neither side runs only
        # first; the launches counted are the first bf16 train's
        kw = dict(ntrees=c["ntrees"], max_depth=c["max_depth"])
        m32, t32a = _timed(lambda: h2o.GBM(**kw).train(
            y="y", training_frame=fr32))
        hg.launches = 0
        m16, t16a = _timed(lambda: h2o.GBM(**kw).train(
            y="y", training_frame=fr16))
        launches = hg.launches
        _m, t16b = _timed(lambda: h2o.GBM(**kw).train(
            y="y", training_frame=fr16))
        _m, t32b = _timed(lambda: h2o.GBM(**kw).train(
            y="y", training_frame=fr32))
        del _m
        t16, t32 = (t16a + t16b) / 2, (t32a + t32b) / 2
        auc = float(m16._output.training_metrics.auc)
        metric("gbm_bf16_train_s", t16,
               f"(mean of {t16a!r}, {t16b!r}; float32 twin {t32!r}, the "
               f"mean of {t32a!r}, {t32b!r})")
        print(f"gbm_bf16_training_auc {auc!r} (float32 twin "
              f"{float(m32._output.training_metrics.auc)!r}); "
              f"hist_gather launches {launches}")
        check(np.isfinite(auc) and auc > 0.5, f"bf16 AUC {auc} not > 0.5")
        check(launches == c["ntrees"] * c["max_depth"],
              f"{launches} hist_gather launches on the bf16 frame, "
              f"expected {c['ntrees'] * c['max_depth']}")
        del m32

        eager = m16.predict(fr16).col("Y").data
        sess = scoring.session_for(m16)
        sess.predict(fr16)                              # captures
        got, dt = _timed(lambda: sess.predict(fr16).col("Y").data)
        metric("bf16_score_1m_s", dt, "(scoring session, graph replay)")
        check(torch.equal(got.view(torch.int32), eager.view(torch.int32)),
              "bf16 session replay differs from eager predict")
        own = [k for k, prog in sess._programs.items()
               if k[2] == torch.bfloat16 and prog.graph is not None]
        sess.predict(fr32)
        f32 = [k for k, prog in sess._programs.items()
               if k[2] == torch.float32]
        print(f"bf16 session programs {sorted(own)}; float32 programs "
              f"{sorted(f32)}")
        check(own and f32, "the bf16 frame did not get graphs of its own")
        del fr32, eager, got, sess

        gfr, _b = glm_bench_frame(h2o, dev, GLM_BENCH["n_rows"],
                                  BF16["glm_p"], GLM_BENCH["seed"])
        check(gfr.col("x0").data.dtype == torch.bfloat16,
              "bench GLM frame not bf16")
        g, dt = _timed(lambda: h2o.GLM(family="binomial", lambda_=0.0)
                       .train(y="y", training_frame=gfr))
        gauc = float(g._output.training_metrics.auc)
        metric("glm_bf16_train_s", dt, f"(training AUC {gauc!r})")
        check(np.isfinite(gauc) and gauc > 0.5 and
              bool(torch.isfinite(g.beta).all()), "bf16 GLM not finite")
        del gfr, g

        args.numeric_dtype = "float32"
        p32 = h2o.import_file(parse_path)
        args.numeric_dtype = "bfloat16"
        p16, dt = _timed(lambda: h2o.import_file(parse_path))
        metric("parse_bf16_s", dt, f"({p16.nrows} rows, the run_parse "
               f"file)")
        nums = [n for n, t in p16.types.items() if t == "real"]
        check(nums and all(p16.col(n).data.dtype == torch.bfloat16
                           for n in nums), "imported reals not bf16")
        for n in nums:
            _bf16_bits_equal(f"import {n}", p32.col(n).data,
                             p16.col(n).data)
        print(f"bf16 import: {len(nums)} real columns equal to the "
              f"float32 parse rounded to bf16")
        del p32, p16

        key = "bf16_rapids.hex"
        rapids_frame(h2o, dev, key, RAPIDS["n_rows"], RAPIDS["seed"])
        stmt = rapids_statements(key)[1]
        sess = h2o.Session("bf16_fusion")
        sig = fusion.plan_expr(parse(stmt), Env(sess)).signature
        c0 = fusion.counters()["captures"]
        with fusion.force(True), planner.force(True):
            fused = h2o.exec_rapids(stmt, sess).col(0).data
        caps = fusion.counters()["captures"] - c0
        with fusion.force(False), planner.force(False):
            eager = h2o.exec_rapids(stmt, sess).col(0).data
        print(f"bf16 fused statement: {caps} new capture(s), signature "
              f"{sig[:120]}")
        check("bfloat16" in sig, "bf16 leaves not in the plan signature")
        check(caps >= 1, "the bf16 statement replayed another capture")
        check(fused.dtype == torch.float32 and torch.equal(
            fused.view(torch.int32), eager.view(torch.int32)),
            "bf16 fused statement differs from its eager run")
        sess.end()
        del fused, eager

        n = BF16["cvc_rows"]
        gkw = dict(ntrees=BF16["cvc_trees"], max_depth=c["max_depth"],
                   seed=1)
        out = {}
        for d in (dev, torch.device("cpu")):
            f = flagship_frame(h2o, d, n)
            m = h2o.GBM(**gkw).train(y="y", training_frame=f)
            out[d.type] = (m, m.spec.bin_columns(f).cpu(),
                           m.predict(f).col("Y").data.cpu())
        (mc, bc, pc), (mh, bh, ph) = out["cuda"], out["cpu"]
        fc, fh = _forest_arrays(mc), _forest_arrays(mh)
        check(all(np.array_equal(fc[k], fh[k]) for k in fc),
              "bf16 card vs CPU: forest structure differs")
        check(all(np.array_equal(a, b) for a, b in
                  zip(mc.spec.edges, mh.spec.edges)) and
              torch.equal(bc, bh), "bf16 card vs CPU: bins differ")
        err = float((pc - ph).abs().max())
        print(f"bf16 card vs CPU ({n} rows): forest and bins bitwise, "
              f"predictions max abs diff {err!r}")
        check(err <= BF16["pred_atol"], f"bf16 card vs CPU predictions "
              f"{err} > {BF16['pred_atol']}")
    finally:
        args.numeric_dtype = saved
    return launches


# ---------------------------------------------------------------------------
# phase 3u: the REST server, the thin client and the observability plane
# ---------------------------------------------------------------------------

# phase 3u: run_scoring's 16 clients x 128 rows (h2o3_tpu/bench.py:180,
# :212-246) over HTTP, 50 pings for the round trip, a 1-epoch
# DeepLearning (the reference's default widths) on 100k flagship rows
# trained over REST while the 16 clients post; phase 4 on 100k rows
REST = dict(conc=16, small_rows=128, rounds=4, pings=50, dl_rows=100_000,
            dl=dict(hidden=[200, 200], epochs=1, seed=1),
            cvc_rows=100_000, cvc_gbm=dict(ntrees=5, max_depth=5, seed=1))
_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+=\"[^\"]*\""
    r"(,[a-zA-Z0-9_]+=\"[^\"]*\")*\})? -?\S+$")


class _Rest:
    """HTTP to the port's server: a timeout on every request, a deadline
    on every job poll, and a count of the requests made (the
    h2o3_rest_requests_total check). Any reply but the one due fails the
    phase."""

    def __init__(self, port):
        import threading

        self.base = f"http://127.0.0.1:{port}"
        self.n = 0
        self._lock = threading.Lock()

    def call(self, method, path, data=None, query=None, status=200):
        import urllib.error
        import urllib.parse
        import urllib.request

        url = self.base + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        body = None if data is None else json.dumps(data).encode()
        req = urllib.request.Request(
            url, data=body, method=method,
            headers={"Content-Type": "application/json"} if body else {})
        with self._lock:
            self.n += 1
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                code, hdrs, raw = r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            code, hdrs, raw = e.code, dict(e.headers), e.read()
        check(status is None or code == status,
              f"{method} {path}: HTTP {code}, expected {status}: "
              f"{raw[:300]!r}")
        return hdrs, raw

    def json(self, method, path, data=None, query=None, status=200):
        return json.loads(self.call(method, path, data, query, status)[1])

    def job(self, out, deadline_s=600):
        key = out["job"]["key"]["name"]
        t0 = time.perf_counter()
        while True:
            j = self.json("GET", f"/3/Jobs/{key}")["jobs"][0]
            if j["status"] not in ("CREATED", "RUNNING"):
                check(j["status"] == "DONE", f"job {key}: {j['status']} "
                                             f"{j.get('exception')}")
                return j
            check(time.perf_counter() - t0 < deadline_s,
                  f"job {key} past its {deadline_s} s deadline")
            time.sleep(0.01)

    def import_parse(self, path, dest):
        files = self.json("GET", "/3/ImportFiles",
                          query={"path": path})["files"]
        self.json("POST", "/3/ParseSetup", {"source_frames": files})
        return self.job(self.json("POST", "/3/Parse", {
            "source_frames": files, "destination_frame": dest}))


def _rows_frame(h2o, src, lo, hi, key):
    fr = h2o.Frame(key=key)
    for nm in src.names:
        c = src.col(nm)
        fr.add(nm, h2o.Column(c.data[lo:hi].clone(), c.ctype, hi - lo,
                              domain=c.domain))
    fr.install()
    return fr


def _p99(ms):
    return float(np.percentile(np.asarray(ms), 99))


def phase_rest(h2o, dev, csv_path, fr_3l, model_3l, fused_3t):
    """Phase 3u: the port's server on the card on an ephemeral port. The
    flagship CSV imported and trained over REST (frame and forest bitwise
    with phase 3l's, the kernel's 100 launches on this path), 1M rows
    scored over /3 and /4 (bitwise with in-process predict), run_rapids'
    statements over /99/Rapids (bitwise with phase 3t's), 16 concurrent
    128-row clients alone and during a DeepLearning train over REST
    (weights bitwise with the same train alone), then the observability
    routes and /3/Shutdown. Returns the kernel's launches on the REST
    path."""
    import threading

    from h2o3_tpu_torch import scoring
    from h2o3_tpu_torch.api.server import start_server
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from h2o3_tpu_torch.obs import metrics as obs_metrics

    def total_requests():
        m = obs_metrics.REGISTRY.get("h2o3_rest_requests_total")
        return sum(s["value"] for s in m.snapshot()["samples"])

    base_requests = total_requests()
    srv = start_server(port=0)
    R = _Rest(srv.port)
    name = torch.cuda.get_device_name(dev)
    cloud = R.json("GET", "/3/Cloud")
    check(name in cloud["nodes"][0]["h2o"] and cloud["cloud_size"] == 1,
          f"/3/Cloud names {cloud['nodes'][0]['h2o']!r}, not {name!r}")
    pings = []
    for _ in range(REST["pings"]):
        t0 = time.perf_counter()
        R.json("GET", "/3/Ping")
        pings.append((time.perf_counter() - t0) * 1e3)
    metric("rest_ping_ms", float(np.median(pings)),
           f"(median of {REST['pings']} /3/Ping round trips)")

    # the flagship CSV over ImportFiles / ParseSetup / Parse
    t0 = time.perf_counter()
    R.import_parse(csv_path, "rest_flagship.hex")
    print(f"rest_parse_s {time.perf_counter() - t0!r}")
    rfr = h2o.get_frame("rest_flagship.hex")
    same_frames("REST import vs phase 3l's in-process import", rfr, fr_3l)
    print("REST import of the flagship CSV: bitwise equal to phase 3l's")

    # the flagship GBM over POST /3/ModelBuilders/gbm
    hg.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w0 = time.time()
    hdrs, raw = R.call("POST", "/3/ModelBuilders/gbm", {
        "training_frame": "rest_flagship.hex", "response_column": "y",
        "ntrees": FLAGSHIP["ntrees"], "max_depth": FLAGSHIP["max_depth"]})
    w_reply, n0 = time.time(), R.n
    job = R.job(json.loads(raw))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    w_done, polls = time.time(), R.n - n0
    launches = hg.launches
    train_trace = hdrs.get("X-H2O3-Trace-Id")
    mid = job["dest"]["name"]
    m = h2o.get_model(mid)
    RUN["rest_gbm_train_s"] = dt                # phase 3x prints it
    metric("rest_gbm_train_s", dt, f"(in-process gbm_train_s "
           f"{RUN['gbm_train_s']!r} in phase 3)")
    # where the REST train's wall time went: the POST's reply, the
    # builder's own wall time (ModelBuilder.train: its start and
    # run_time_ms), and what came after it until the last poll saw DONE
    b0 = m._output.start_time
    b_ms = float(m._output.run_time_ms)
    print(f"rest_gbm_train split (ms): POST reply {(w_reply - w0) * 1e3!r}, "
          f"POST to builder start {(b0 - w0) * 1e3!r}, builder "
          f"{b_ms!r} (phase 3l in process on the same frame "
          f"{RUN['gbm_train_imported_s'] * 1e3!r}), builder end to DONE "
          f"seen {(w_done - b0) * 1e3 - b_ms!r}; {polls} polls of "
          f"/3/Jobs")
    check(launches == FLAGSHIP["max_depth"] * FLAGSHIP["ntrees"],
          f"{launches} hist_gather launches on the REST train")
    a, b = _forest_arrays(m), _forest_arrays(model_3l)
    for k in a:
        check(np.array_equal(a[k], b[k]), f"REST forest {k} differs from "
                                          "phase 3l's")
    check(np.array_equal(m.forest.leaf_val, model_3l.forest.leaf_val),
          "REST leaf values differ from phase 3l's")
    print(f"REST train: forest bitwise equal to phase 3l's; hist_gather "
          f"launches {launches}")

    # 1M rows over /3/Predictions and /4/Predictions
    ref = model_3l.predict(fr_3l)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    R.json("POST", f"/3/Predictions/models/{mid}/frames/rest_flagship.hex",
           {"predictions_frame": "rest_pred_v3"})
    metric("rest_predict_1m_s", time.perf_counter() - t0,
           f"({FLAGSHIP['n_rows']} rows, sync /3/Predictions)")
    v4 = R.json("POST", f"/4/Predictions/models/{mid}/frames/"
                        "rest_flagship.hex")
    R.job(v4)
    for label, key in (("/3", "rest_pred_v3"), ("/4", v4["dest"]["name"])):
        got = h2o.get_frame(key)
        for nm in ("N", "Y"):
            _same_bits(f"{label}/Predictions {nm} vs in-process predict",
                       got.col(nm).data, ref.col(nm).data)
    print("/3 and /4 predictions of 1M rows: bitwise equal to in-process "
          "predict")
    del ref

    # run_rapids' three statements over /99/Rapids, on phase 3t's frame
    # made again from its seed
    rapids_frame(h2o, dev, "rapids_fused", RAPIDS["n_rows"], RAPIDS["seed"])
    stmts = rapids_statements("rapids_fused")
    outs, ms = [], []
    for _ in range(RAPIDS["reps"]):
        outs = []
        for st in stmts:
            t0 = time.perf_counter()
            outs.append(R.json("POST", "/99/Rapids",
                               {"ast": st, "session_id": "rest_rapids"}))
            ms.append((time.perf_counter() - t0) * 1e3)
    metric("rest_rapids_statement_ms", float(np.mean(ms)),
           f"(mean of {len(ms)} statements over {RAPIDS['n_rows']} rows)")
    for i in (0, 1):
        got = h2o.get_frame(outs[i]["key"]["name"]).col(0).data
        _same_bits(f"REST Rapids statement {i + 1} vs phase 3t", got,
                   fused_3t[i])
    check(outs[2]["scalar"] == float(fused_3t[2]),
          f"REST Rapids sum {outs[2]['scalar']!r} vs phase 3t "
          f"{fused_3t[2]!r}")
    print("run_rapids' statements over /99/Rapids: bitwise equal to "
          "phase 3t's")

    # run_scoring's 16 clients x 128 rows, then the same during a REST
    # DeepLearning train
    c = REST
    for i in range(c["conc"]):
        _rows_frame(h2o, rfr, i * c["small_rows"], (i + 1) * c["small_rows"],
                    f"rest_small{i}")
    lat, traces = [], []

    def timed_post(i):
        t0 = time.perf_counter()
        hdrs, _raw = R.call(
            "POST", f"/3/Predictions/models/{mid}/frames/rest_small{i}",
            {"predictions_frame": f"rest_small_pred{i}"})
        return (time.perf_counter() - t0) * 1e3, hdrs.get("X-H2O3-Trace-Id")

    def post(i):
        return timed_post(i)[0]

    post(0)                                          # warm the bucket
    t_all = time.perf_counter()
    for _ in range(c["rounds"]):
        got, errs = _concurrent(timed_post, list(range(c["conc"])))
        check(not any(errs), f"a scoring client failed: {errs}")
        lat += [g[0] for g in got]
        traces += [g[1] for g in got]
    wall = time.perf_counter() - t_all
    metric("rest_score_p99_ms", _p99(lat), f"({c['rounds']} rounds of "
           f"{c['conc']} concurrent {c['small_rows']}-row requests)")
    metric("rest_predictions_per_sec", len(lat) * c["small_rows"] / wall,
           f"(rows/s over those {len(lat)} requests)")
    # where the requests' time went, from each one's own span tree: the
    # server-side ingress span and, by name, the spans under it (score:
    # admission, the batcher and the request's finish and metrics;
    # schema: the metrics' reply schema; reply: its JSON and send). A
    # request that led its flush holds pack/dispatch/fetch (every
    # member's finish and metrics run in that fetch, each recorded in
    # its member's own trace); the others hold one batch span over the
    # flush. A handler ends its ingress span after its reply is out:
    # let the last ones land first.
    time.sleep(0.5)
    per = []
    for tid in traces:
        root = R.json("GET", f"/3/Trace/{tid}")["tree"][0]
        check(root["name"] == "ingress", f"trace {tid} root {root['name']}")
        # "untraced": the ingress time outside its direct children
        kids = {"ingress": root["ms"], "untraced": root["ms"] - sum(
            sp["ms"] for sp in root["children"])}
        stack = list(root["children"])
        while stack:
            sp = stack.pop()
            kids[sp["name"]] = kids.get(sp["name"], 0.0) + sp["ms"]
            stack += sp["children"]
        per.append(kids)
    names = sorted({k for p in per for k in p})
    print(f"{len(per)} requests' spans, mean / max ms (at the client "
          f"{float(np.mean(lat)):.2f} / {float(np.max(lat)):.2f}): " +
          ", ".join(f"{k} {float(np.mean([p.get(k, 0.0) for p in per])):.2f}"
                    f" / {max(p.get(k, 0.0) for p in per):.2f}"
                    for k in names))
    leads = [p for p in per if "pack" in p]
    print(f"{len(leads)} flushes of {len(per) / max(len(leads), 1):.1f} "
          f"requests on average")
    slow = int(np.argmax(lat))
    print(f"slowest request {lat[slow]:.1f} ms at the client: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(per[slow].items())) + " ms")
    seq = [post(0) for _ in range(20)]
    print(f"one client alone: {float(np.median(seq)):.2f} ms median of 20 "
          f"sequential {c['small_rows']}-row requests")
    sref = model_3l.predict(_rows_frame(h2o, rfr, 0, c["small_rows"],
                                        "rest_small_ref"))
    _same_bits("16-client request vs in-process predict",
               h2o.get_frame("rest_small_pred0").col("Y").data,
               sref.col("Y").data)

    dfr = _rows_frame(h2o, rfr, 0, c["dl_rows"], "rest_dl.hex")
    alone = h2o.DeepLearning(**c["dl"]).train(y="y", training_frame=dfr)
    stop = threading.Event()
    served, errors = [], []

    def client(i):
        while not stop.is_set():
            try:
                post(i)
                served.append(i)
            except Exception as e:   # noqa: BLE001 — reported below
                errors.append(e)
                return

    ths = [threading.Thread(target=client, args=(i,))
           for i in range(c["conc"])]
    for t in ths:
        t.start()
    try:
        dj = R.job(R.json("POST", "/3/ModelBuilders/deeplearning", {
            "training_frame": "rest_dl.hex", "response_column": "y",
            "hidden": json.dumps(c["dl"]["hidden"]),
            "epochs": c["dl"]["epochs"], "seed": c["dl"]["seed"]}))
    finally:
        stop.set()
        for t in ths:
            t.join(timeout=120)
    check(not errors, f"a client failed during the REST train: {errors[:1]}")
    dl = h2o.get_model(dj["dest"]["name"])
    for x, y in zip(_dl_weights(dl), _dl_weights(alone)):
        check(np.array_equal(x, y), "DeepLearning over REST with 16 "
                                    "concurrent clients differs from the "
                                    "train alone")
    print(f"DeepLearning over REST ({c['dl_rows']} rows, 1 epoch, its step "
          f"loop a CUDA graph) during {len(served)} concurrent predictions: "
          f"weights bitwise equal to the train alone")

    # the observability routes; a request is counted as its handler
    # ends, after its reply is out: let the last one land first
    time.sleep(0.5)
    mj = R.json("GET", "/3/Metrics", query={"format": "json"})
    _h, text = R.call("GET", "/3/Metrics")
    bad = [ln for ln in text.decode().splitlines()
           if ln and not ln.startswith("#") and not _PROM_LINE.match(ln)]
    check(not bad, f"/3/Metrics lines that do not parse: {bad[:3]}")
    series = {s["name"]: s for s in mj["series"]}
    counted = sum(s["value"] for s in
                  series["h2o3_rest_requests_total"]["samples"])
    # the JSON scrape counts every request before it
    check(counted - base_requests == R.n - 2,
          f"h2o3_rest_requests_total {counted - base_requests}, requests "
          f"made before the scrape {R.n - 2}")
    sm = R.json("GET", "/3/ScoringMetrics")
    check(any(e["model"] == mid for e in sm["models"])
          and "rapids" in sm and "pipeline" in sm,
          "/3/ScoringMetrics lacks the flagship's session or a block")
    tr = R.json("GET", f"/3/Trace/{train_trace}")
    check(tr["tree"][0]["name"] == "ingress"
          and tr["tree"][0]["attrs"]["path"] == "/3/ModelBuilders/gbm",
          f"train trace {tr['tree'][0]}")
    rt = R.json("GET", "/3/Runtime")
    for p in ("backend_init", "device_discovery", "first_compile",
              "server_start"):
        check(p in rt["phase_report"], f"/3/Runtime lacks phase {p}")
    fams = rt["compile_families"]
    for f in ("kernel", "scoring", "rapids", "train"):
        check(fams.get(f, {}).get("compiles", 0) >= 1,
              f"/3/Runtime lists no {f} build or capture")
    print("compile ledger: " + ", ".join(
        f"{f} {a['compiles']} ({a['ms_total']:.1f} ms)"
        for f, a in sorted(fams.items())))
    torch.cuda.synchronize()
    prof = R.json("GET", "/3/Profiler")["nodes"][0]
    want = torch.cuda.memory_allocated(dev)
    check(prof["bytes_in_use"] == want,
          f"/3/Profiler bytes_in_use {prof['bytes_in_use']} vs "
          f"torch.cuda.memory_allocated {want}")
    pdir = tempfile.mkdtemp(prefix="chip_smoke_prof_")
    try:
        R.json("POST", "/3/Profiler/start", {"dir": pdir})
        R.json("POST", f"/3/Predictions/models/{mid}/frames/rest_small0")
        stop_reply = R.json("POST", "/3/Profiler/stop")
        with open(stop_reply["trace"]) as f:
            events = json.load(f).get("traceEvents", [])
        kern = sum(1 for e in events if e.get("cat") == "kernel")
        check(kern > 0, "the profiler's trace holds no CUDA kernel event")
        print(f"/3/Profiler/start|stop: a Chrome trace with {kern} CUDA "
              f"kernel events")
    finally:
        shutil.rmtree(pdir, ignore_errors=True)
    bench = R.json("GET", "/3/NetworkTest", query={"size": 4096})["bench"]
    print(f"/3/NetworkTest (size 4096): matmul {bench['matmul_gflops']:.1f} "
          f"GFLOP/s, stream {bench['membw_gbps']:.1f} GB/s, "
          f"{bench['psum_probe']} {bench['psum_latency_us']:.1f} us")
    R.json("POST", "/3/Shutdown")
    t0 = time.perf_counter()
    while srv.httpd is not None and time.perf_counter() - t0 < 30:
        time.sleep(0.01)
    check(srv.httpd is None, "/3/Shutdown did not stop the server")
    for k in list(h2o.DKV.keys()):
        if k.startswith(("rest_", "prediction_")) or k in (mid,
                                                           "rapids_fused"):
            h2o.remove(k)
    scoring.purge()
    return launches


def phase_card_vs_cpu_rest(h2o, dev, tmp):
    """A 100k-row REST session on the card and on the CPU, through one
    server: the frame summary (C2's bars) and the GBM's model-metrics
    JSON (forest equal, metrics to PRED_ATOL)."""
    import os

    from h2o3_tpu_torch.api.server import start_server

    n = REST["cvc_rows"]
    path = os.path.join(tmp, "rest_cvc.csv")
    write_csv(path, flagship_arrays(n), _repr_f32)
    srv = start_server(port=0)
    R = _Rest(srv.port)
    got = {}
    try:
        for label, device in (("card", None), ("cpu", "cpu")):
            h2o.init(device=device)
            key = f"rest_cvc_{label}.hex"
            R.import_parse(path, key)
            summ = R.json("GET", f"/3/Frames/{key}/summary")["frames"][0]
            mid = R.job(R.json("POST", "/3/ModelBuilders/gbm", dict(
                training_frame=key, response_column="y",
                **REST["cvc_gbm"])))["dest"]["name"]
            mm = R.json("POST", f"/3/ModelMetrics/models/{mid}/frames/"
                                f"{key}")["model_metrics"][0]
            got[label] = (summ, mm, _forest_arrays(h2o.get_model(mid)))
    finally:
        h2o.init()
        srv.stop()
    (cs, cm, cf), (ps, pm, pf) = got["card"], got["cpu"]
    for a, b in zip(cs["columns"], ps["columns"]):
        check(a["type"] == b["type"] and a["domain"] == b["domain"]
              and a["missing_count"] == b["missing_count"],
              f"REST summary {a['label']}: type/domain/NA differ")
        for k in ("mean", "sigma", "mins", "maxs", "percentiles"):
            x = np.asarray(a[k] if a[k] is not None else np.nan, float)
            y = np.asarray(b[k] if b[k] is not None else np.nan, float)
            check(np.allclose(x, y, rtol=1e-6, atol=1e-6, equal_nan=True),
                  f"REST summary {a['label']}.{k}: card {x} vs CPU {y}")
    for k in cf:
        check(np.array_equal(cf[k], pf[k]), f"REST GBM {k} differs "
                                            "between card and CPU")
    for k in ("AUC", "logloss", "MSE", "RMSE", "Gini", "pr_auc"):
        check(abs(cm[k] - pm[k]) <= PRED_ATOL,
              f"REST model metrics {k}: card {cm[k]} vs CPU {pm[k]}")
    check(cm["nobs"] == pm["nobs"] == n, "REST model metrics nobs")
    print(f"card vs cpu REST session ({n} rows): summaries within 1e-6, "
          f"forests equal, model metrics within {PRED_ATOL}")
    for k in list(h2o.DKV.keys()):
        if k.startswith("rest_cvc"):
            h2o.remove(k)


# ---------------------------------------------------------------------------
# phase 3v: crash-survivable training and search, and the S3 reader
# ---------------------------------------------------------------------------

# phase 3v: the knob's interval per builder, the tree a killed child
# holds at, the DeepLearning rows and epochs, and the resumed
# GLM/KMeans/DL bar (tests/test_job_resume.py:96)
RESUME = dict(gbm_every=5, gbm_kill_at=10, drf_every=2, drf_stop_at=2,
              glm_every=2, glm_stop_at=2, km_every=3, km_stop_at=3,
              dl_every=1, dl_stop_at=1, dl_rows=200_000, dl_epochs=3,
              rest_grid=dict(ntrees=5, hyper={"max_depth": [3, 5]}))
RESUME_TOL = dict(rtol=1e-6, atol=1e-7)


class _Interrupted(Exception):
    """A train stopped right after a durable save (the process dying)."""


def _progress_job(builder, fr, y="y"):
    """A Job with a re-dispatch recipe on `builder`, as the REST train
    handler attaches one."""
    from h2o3_tpu_torch.core.job import Job

    job = Job(description=f"{builder.algo_name} train")
    job.resume_spec = {"algo": builder.algo_name,
                       "params": {k: v for k, v in builder.params.items()
                                  if isinstance(v, (int, float, str, bool,
                                                    list, type(None)))},
                       "training_frame": str(fr.key), "y": y}
    builder._progress_job = job
    return job


@contextlib.contextmanager
def _stop_after(at):
    """Builders raise _Interrupted right after their durable save at
    iteration `at`."""
    from h2o3_tpu_torch.models.model_builder import ModelBuilder

    orig = ModelBuilder._tick_job_progress

    def tick(self, done, fn):
        orig(self, done, fn)
        if done >= at and self._progress_job is not None:
            raise _Interrupted()

    ModelBuilder._tick_job_progress = tick
    try:
        yield
    finally:
        ModelBuilder._tick_job_progress = orig


def _interrupt_and_load(label, make, fr, at, y="y"):
    """Train `make()` with progress until the save at `at`, interrupted
    there; -> the saved progress record."""
    from h2o3_tpu_torch.parallel import ckpt

    b = make()
    job = _progress_job(b, fr, y)
    try:
        with _stop_after(at):
            b.train(y=y, training_frame=fr)
        raise SmokeFailure(f"{label}: the train ran past its save at {at}")
    except _Interrupted:
        pass
    data = ckpt.load_job_progress(str(job.key))
    check(data is not None and data["iteration"] == at,
          f"{label}: no progress saved at iteration {at}")
    return data


def _resumed(make, data, fr, y="y"):
    """A fresh builder trained from the saved state, timed; the progress
    files go after it."""
    from h2o3_tpu_torch.parallel import ckpt

    b = make()
    b._resume_state = data["state"]
    out = _timed(lambda: b.train(y=y, training_frame=fr))
    ckpt.delete_job_progress(data["job"])
    return out


def _same_forest(label, got, want):
    for k in want:
        check(got[k].shape == want[k].shape
              and np.array_equal(got[k], want[k]),
              f"{label}: forest {k} differs")


def _within(label, got, want):
    """-> max |got - want|; fails beyond RESUME_TOL."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    bitwise = got.shape == want.shape and np.array_equal(got, want)
    print(f"{label}: {'bitwise' if bitwise else 'not bitwise'}, max abs "
          f"diff {err!r}")
    check(got.shape == want.shape and np.allclose(got, want, **RESUME_TOL),
          f"{label}: beyond rtol {RESUME_TOL['rtol']} / atol "
          f"{RESUME_TOL['atol']}")
    return err


def resume_child(ckdir: str, keyfile: str, n_rows: int) -> None:
    """Phase 3v's child process: the flagship GBM with durable progress
    every RESUME['gbm_every'] trees. It writes its job's key to `keyfile`
    and holds after its save at RESUME['gbm_kill_at'] until the parent
    kills it (the 20 trees take well under a second, too short to aim a
    kill at)."""
    import os

    os.environ["H2O_TPU_JOB_CKPT_ITERS"] = str(RESUME["gbm_every"])
    os.environ["H2O_TPU_OPLOG_CKPT_DIR"] = ckdir
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.models.model_builder import ModelBuilder

    dev = h2o.init().device
    fr = flagship_frame(h2o, dev, n_rows)
    b = h2o.GBM(ntrees=FLAGSHIP["ntrees"], max_depth=FLAGSHIP["max_depth"],
                seed=1)
    job = _progress_job(b, fr)
    orig = ModelBuilder._tick_job_progress

    def tick(self, done, fn):
        orig(self, done, fn)
        if done >= RESUME["gbm_kill_at"]:
            print(f"child: saved at tree {done}, holding", flush=True)
            time.sleep(3600)

    ModelBuilder._tick_job_progress = tick
    with open(keyfile + ".part", "w") as f:
        f.write(str(job.key))
    os.replace(keyfile + ".part", keyfile)
    b.train(y="y", training_frame=fr)


def _kill_child_at_save(tmp, ckdir):
    """Run resume_child in a fresh process, SIGKILL it once its sidecar
    reports a save at tree >= RESUME['gbm_kill_at']; -> the job key."""
    import os
    import signal

    from h2o3_tpu_torch.parallel import ckpt

    keyfile = os.path.join(tmp, "child_job_key")
    log = open(os.path.join(tmp, "child.log"), "w")
    root = str(Path(__file__).resolve().parent)
    child = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.resume_child("
         f"{ckdir!r}, {keyfile!r}, {FLAGSHIP['n_rows']})"], cwd=root,
        stdout=log,
        stderr=subprocess.STDOUT)
    try:
        t0, key, it = time.perf_counter(), None, 0
        while it < RESUME["gbm_kill_at"]:
            check(child.poll() is None, "the resume child ended on its own "
                                        f"(code {child.returncode})")
            check(time.perf_counter() - t0 < 600, "the resume child saved "
                                                  "no progress in 600 s")
            if key is None and os.path.exists(keyfile):
                with open(keyfile) as f:
                    key = f.read().strip()
            if key is not None:
                try:
                    with open(ckpt._job_path(key) + ".json") as f:
                        it = int(json.load(f)["iteration"])
                except (OSError, ValueError, KeyError):
                    pass
            time.sleep(0.01)
        child.send_signal(signal.SIGKILL)
        child.wait(60)
        print(f"child killed (SIGKILL, code {child.returncode}) after its "
              f"save at tree {it}, {time.perf_counter() - t0:.1f} s after "
              "its start")
        check(child.returncode == -signal.SIGKILL, "the child was not "
                                                   "killed by SIGKILL")
        return key
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(60)
        log.close()


def _gbm_with_saves(h2o, fr, ckdir):
    """The flagship GBM uninterrupted with a progress job: every save
    timed (state taken and written) and the files' bytes after the last.
    -> (model, seconds, save ms list, bytes)."""
    import os

    from h2o3_tpu_torch.models.model_builder import ModelBuilder
    from h2o3_tpu_torch.parallel import ckpt

    b = h2o.GBM(ntrees=FLAGSHIP["ntrees"], max_depth=FLAGSHIP["max_depth"],
                seed=1)
    job = _progress_job(b, fr)
    orig, saves, size = ModelBuilder._tick_job_progress, [], [0]
    prefix = os.path.basename(ckpt._job_path(str(job.key)))[:-4]

    def tick(self, done, fn):
        n0 = getattr(self, "_jp_last", 0)
        t0 = time.perf_counter()
        orig(self, done, fn)
        if getattr(self, "_jp_last", 0) != n0:
            saves.append((time.perf_counter() - t0) * 1e3)
            size[0] = sum(os.path.getsize(os.path.join(ckdir, n))
                          for n in os.listdir(ckdir) if n.startswith(prefix))

    ModelBuilder._tick_job_progress = tick
    try:
        m, dt = _timed(lambda: b.train(y="y", training_frame=fr))
    finally:
        ModelBuilder._tick_job_progress = orig
    check(not ckpt.has_job_progress(str(job.key))
          and not [n for n in os.listdir(ckdir) if n.startswith(prefix)],
          "a completed train left its progress files")
    return m, dt, saves, size[0]


def _resume_gbm(h2o, dev, fr, tmp, ckdir, launches):
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from h2o3_tpu_torch.parallel import ckpt

    c = RESUME
    want = RUN["flagship_forest"]
    with _env(H2O_TPU_JOB_CKPT_ITERS=c["gbm_every"]):
        def plain():
            return _timed(lambda: h2o.GBM(
                ntrees=FLAGSHIP["ntrees"], max_depth=FLAGSHIP["max_depth"],
                seed=1).train(y="y", training_frame=fr))[1]

        h2o.GBM(ntrees=2, max_depth=FLAGSHIP["max_depth"]).train(
            y="y", training_frame=fr)                   # warm-up
        # plain, saving, saving, plain: the saves' cost against trains
        # of the same moment, not only against phase 3's
        p1 = plain()
        m0, dt, saves, nbytes = _gbm_with_saves(h2o, fr, ckdir)
        _, dt2, saves2, _ = _gbm_with_saves(h2o, fr, ckdir)
        p2 = plain()
        metric("gbm_train_ckpt_s", dt, f"(again {dt2!r}; without saves "
               f"beside it {p1!r}, {p2!r}; phase 3's gbm_train_s "
               f"{RUN['gbm_train_s']!r}; {len(saves)} saves a train)")
        metric("gbm_train_ckpt_extra_s", (dt + dt2 - p1 - p2) / 2,
               "(mean of the saving trains less the plain ones beside)")
        metric("job_ckpt_save_ms", float(np.mean(saves + saves2)),
               f"(each: {[round(v, 3) for v in saves + saves2]})")
        metric("job_ckpt_bytes", nbytes, "(progress pickle, sidecar and "
               "tree chunks after the last save)")
        check(len(saves) == len(saves2)
              == FLAGSHIP["ntrees"] // c["gbm_every"],
              f"{len(saves)} saves in a {FLAGSHIP['ntrees']}-tree train")
        _same_forest("flagship with durable progress vs phase 3",
                     _forest_bits(m0), want)
        key = _kill_child_at_save(tmp, ckdir)
        data = ckpt.load_job_progress(key)
        check(data is not None, "no readable progress after the kill")
        it = int(data["iteration"])
        hg.launches = 0
        m, dt = _resumed(lambda: h2o.GBM(ntrees=FLAGSHIP["ntrees"],
                                         max_depth=FLAGSHIP["max_depth"],
                                         seed=1), data, fr)
        launches["resume"] = hg.launches
    metric("gbm_resume_train_s", dt, f"(from tree {it} of "
           f"{FLAGSHIP['ntrees']})")
    expect = (FLAGSHIP["ntrees"] - it) * FLAGSHIP["max_depth"]
    print(f"resumed flagship: hist_gather launches {launches['resume']} "
          f"(expected {expect})")
    check(it >= c["gbm_kill_at"] and launches["resume"] == expect,
          f"{launches['resume']} launches resuming from tree {it}")
    _same_forest("flagship resumed after SIGKILL vs uninterrupted",
                 _forest_bits(m), want)
    check(same_bits(torch.from_numpy(_forest_margin(m, fr)),
                    torch.from_numpy(_forest_margin(m0, fr))),
          "resumed flagship margins differ")
    print("flagship resumed after SIGKILL: forest and margins bitwise "
          "equal to the uninterrupted train (and to phase 3's)")


def _resume_drf(h2o, dev, launches):
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    c, d = RESUME, DRF_DEEP
    fr = drf_deep_frame(h2o, dev, d["n_rows"], seed=d["seed"])
    kw = dict(ntrees=d["ntrees"], max_depth=d["max_depth"], seed=d["seed"])
    with _env(H2O_TPU_JOB_CKPT_ITERS=c["drf_every"]):
        data = _interrupt_and_load("deep DRF", lambda: h2o.DRF(**kw), fr,
                                   c["drf_stop_at"])
        hg.launches = 0
        m, dt = _resumed(lambda: h2o.DRF(**kw), data, fr)
        launches["resume_drf"] = hg.launches
    metric("drf_resume_train_s", dt, f"(from tree {c['drf_stop_at']} of "
           f"{d['ntrees']})")
    want_forest, want_oob = RUN["drf_deep"]
    _same_forest("deep DRF resumed vs phase 3c", _forest_bits(m),
                 want_forest)
    got = _oob_bits(m)
    check(got.tobytes() == want_oob.tobytes(),
          f"deep DRF resumed OOB metrics {got} vs phase 3c's {want_oob}")
    expect = (d["ntrees"] - c["drf_stop_at"]) * d["max_depth"]
    check(launches["resume_drf"] == expect,
          f"{launches['resume_drf']} launches resuming the deep DRF")
    print(f"deep DRF resumed from tree {c['drf_stop_at']}: forest and OOB "
          f"metrics (AUC {got[0]!r}) bitwise equal to phase 3c's; "
          f"hist_gather launches {launches['resume_drf']}")


def _resume_glm_kmeans_dl(h2o, dev, fr):
    c = RESUME
    gfr, _ = glm_bench_frame(h2o, dev, GLM_BENCH["n_rows"], GLM_BENCH["p"],
                             GLM_BENCH["seed"])
    kw = dict(family="binomial", lambda_=0.0)
    with _env(H2O_TPU_JOB_CKPT_ITERS=c["glm_every"]):
        m0 = h2o.GLM(**kw).train(y="y", training_frame=gfr)
        data = _interrupt_and_load("GLM", lambda: h2o.GLM(**kw), gfr,
                                   c["glm_stop_at"])
        m, dt = _resumed(lambda: h2o.GLM(**kw), data, gfr)
    metric("glm_resume_train_s", dt, f"(from IRLS iteration "
           f"{c['glm_stop_at']} of {m0.iterations})")
    _within("GLM 1M x 32 resumed vs uninterrupted (knob on), beta",
            m.beta.cpu().numpy(), m0.beta.cpu().numpy())
    check(m.iterations == m0.iterations, "resumed GLM iterations differ")
    del gfr

    kw = dict(k=BUILDERS["k"], init="Furthest", standardize=True,
              max_iterations=10, seed=1)
    with _env(H2O_TPU_JOB_CKPT_ITERS=c["km_every"]):
        m0 = h2o.KMeans(**kw).train(training_frame=fr)
        data = _interrupt_and_load("KMeans", lambda: h2o.KMeans(**kw), fr,
                                   c["km_stop_at"], y=None)
        m, dt = _resumed(lambda: h2o.KMeans(**kw), data, fr, y=None)
    metric("kmeans_resume_train_s", dt, f"(k={kw['k']}, from Lloyd step "
           f"{c['km_stop_at']})")
    _within("KMeans resumed vs uninterrupted (knob on), centers",
            m.centers, m0.centers)

    dfr = flagship_frame(h2o, dev, c["dl_rows"])
    kw = dict(epochs=c["dl_epochs"], seed=DL["seed"])
    with _env(H2O_TPU_JOB_CKPT_ITERS=c["dl_every"]):
        m0 = h2o.DeepLearning(**kw).train(y="y", training_frame=dfr)
        data = _interrupt_and_load("DeepLearning",
                                   lambda: h2o.DeepLearning(**kw), dfr,
                                   c["dl_stop_at"])
        m, dt = _resumed(lambda: h2o.DeepLearning(**kw), data, dfr)
    metric("dl_resume_train_s", dt, f"({c['dl_rows']} rows, from epoch "
           f"{c['dl_stop_at']} of {c['dl_epochs']})")
    check(m.epochs_trained == m0.epochs_trained == c["dl_epochs"],
          "resumed DeepLearning epochs")
    _within("DeepLearning resumed vs uninterrupted, weights",
            np.concatenate([w.ravel() for w in _dl_weights(m)]),
            np.concatenate([w.ravel() for w in _dl_weights(m0)]))


def _resume_grid(h2o, fr, tmp, launches):
    import os

    from h2o3_tpu_torch.models.tree import hist_gather as hg

    c = SEARCH
    rec = os.path.join(tmp, "grid_recovery")
    kw = dict(y="y", training_frame=fr, ntrees=c["grid_ntrees"],
              seed=c["seed"], recovery_dir=rec)
    g = h2o.H2OGridSearch(h2o.GBM, c["grid_hyper"],
                          search_criteria={"max_models": 2})
    gid = str(g.key)
    g.train(**kw)
    first = sorted(str(m.key) for m in g.models)
    check(len(first) == 2, f"the capped grid built {len(first)} models")
    for k in first + [gid]:
        h2o.DKV.remove(k)
    del g
    g2 = h2o.H2OGridSearch.load(rec)
    check(sorted(g2.model_ids) == first, "load(recovery_dir) did not "
                                         "restore the two done members")
    g2.search_criteria["max_models"] = 0
    hg.launches = 0
    _, dt = _timed(lambda: g2.train(**kw))
    launches["grid_resume"] = hg.launches
    metric("grid_resume_train_s", dt, "(the 2 members left of 4)")
    new = [m for m in g2.models if str(m.key) not in first]
    levels = sum(_levels(m) for m in new)
    print(f"grid resumed: {len(g2)} models, {len(new)} trained after "
          f"load; hist_gather launches {launches['grid_resume']}, levels "
          f"grown by those {levels}")
    check(len(g2) == 4 and len(new) == 2 and not g2.failed,
          f"resumed grid: {len(g2)} models, {len(new)} new, failed "
          f"{g2.failed}")
    check(launches["grid_resume"] == levels > 0,
          f"{launches['grid_resume']} launches for {levels} levels")
    want = RUN["grid_gbm"]
    check(sorted(want) == sorted(_combo(m) for m in g2.models),
          "the resumed grid's combos differ from phase 3q's")
    for m in g2.models:
        _same_forest(f"resumed grid member {_combo(m)} vs phase 3q",
                     _forest_bits(m), want[_combo(m)])
    check(_grid_table(g2) == RUN["grid_table"],
          f"resumed grid leaderboard {_grid_table(g2)} vs phase 3q's "
          f"{RUN['grid_table']}")
    check(any(n.startswith("searchckpt_") for n in os.listdir(rec))
          and len(os.listdir(os.path.join(rec, "models"))) == 4,
          "the recovery_dir lost its snapshot or a model file")
    print("grid resumed from its recovery_dir: all 4 members bitwise "
          "equal to phase 3q's by combo, the leaderboard the same")


def _resume_rest(h2o, fr, tmp):
    import os

    from h2o3_tpu_torch.api.server import start_server
    from h2o3_tpu_torch.parallel import ckpt

    fr.install()
    srv = start_server(port=0)
    try:
        R = _Rest(srv.port)
        with _env(H2O_TPU_JOB_CKPT_ITERS=RESUME["gbm_every"]):
            out = R.json("POST", "/3/ModelBuilders/gbm", data={
                "training_frame": str(fr.key), "response_column": "y",
                "ntrees": FLAGSHIP["ntrees"],
                "max_depth": FLAGSHIP["max_depth"], "seed": 1})
            jid = out["job"]["key"]["name"]
            seen, t0 = None, time.perf_counter()
            while seen is None:
                cs = R.json("GET", "/3/CloudStatus")
                if any(r["job"] == jid for r in cs["job_progress"]):
                    seen = R.json("GET", f"/3/Jobs/{jid}")["jobs"][0]
                    break
                j = R.json("GET", f"/3/Jobs/{jid}")["jobs"][0]
                check(j["status"] in ("CREATED", "RUNNING"),
                      f"the REST train ended {j['status']} before "
                      "/3/CloudStatus listed its progress")
                check(time.perf_counter() - t0 < 600, "no progress listed")
            print(f"REST train after its first save: /3/Jobs status "
                  f"{seen['status']}, auto_recoverable "
                  f"{seen['auto_recoverable']}; /3/CloudStatus lists it "
                  "under job_progress")
            check(seen["status"] == "RUNNING" and seen["auto_recoverable"],
                  f"/3/Jobs after the first save: {seen}")
            done = R.job(out)
            check(not done["auto_recoverable"], "a DONE job reads "
                                                "auto_recoverable")
            check(not ckpt.has_job_progress(jid)
                  and all(r["job"] != jid for r in
                          R.json("GET", "/3/CloudStatus")["job_progress"]),
                  "the REST train's progress outlived DONE")
        rec = os.path.join(tmp, "rest_grid_recovery")
        g = RESUME["rest_grid"]
        out = R.json("POST", "/99/Grid/gbm", data={
            "training_frame": str(fr.key), "response_column": "y",
            "ntrees": g["ntrees"], "seed": 1,
            "hyper_parameters": g["hyper"], "recovery_dir": rec})
        R.job(out)
        nmod = len(os.listdir(os.path.join(rec, "models")))
        check(nmod == len(g["hyper"]["max_depth"])
              and any(n.startswith("searchckpt_") for n in os.listdir(rec)),
              f"the REST grid's recovery_dir holds {nmod} models")
        print(f"POST /99/Grid/gbm with recovery_dir: done, the directory "
              f"keeps its snapshot and {nmod} model files")
    finally:
        srv.stop()


def _s3_handler(objects, access_key, secret, seen):
    """A loopback S3 endpoint's handler class: GET /bucket/key serves
    `objects` ({path: bytes}) and answers 403 unless the request carries
    a well-formed SigV4 Authorization whose signature checks out for
    `access_key`/`secret` at its x-amz-date; each verdict goes to
    `seen`."""
    import datetime
    import hashlib
    import http.server

    from h2o3_tpu_torch.persist import s3

    pat = re.compile(
        r"^AWS4-HMAC-SHA256 Credential=" + re.escape(access_key)
        + r"/\d{8}/us-east-1/s3/aws4_request, SignedHeaders=host;"
        r"x-amz-content-sha256;x-amz-date, Signature=[0-9a-f]{64}$")
    empty = hashlib.sha256(b"").hexdigest()

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            auth = self.headers.get("Authorization", "")
            ok = bool(pat.match(auth)) and \
                self.headers.get("x-amz-content-sha256") == empty
            if ok:
                when = datetime.datetime.strptime(
                    self.headers.get("x-amz-date", ""),
                    "%Y%m%dT%H%M%SZ").replace(tzinfo=datetime.timezone.utc)
                url = f"http://{self.headers['Host']}{self.path}"
                ok = s3._sign_v4("GET", url, "us-east-1", access_key,
                                 secret, None, now=when)["Authorization"] \
                    == auth
            seen.append(ok)
            body = objects.get(self.path)
            if not ok or body is None:
                self.send_response(404 if ok else 403)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    return H


def _s3_import(h2o, dev, csv_path, fr_3l):
    import http.server
    import threading

    with open(csv_path, "rb") as f:
        body = f.read()
    seen = []
    srv = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), _s3_handler({"/smoke/flagship.csv": body},
                                      "AKIASMOKE", "smoke-secret", seen))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        with _env(H2O_TPU_S3_ENDPOINT=f"http://127.0.0.1:{srv.server_port}",
                  AWS_ACCESS_KEY_ID="AKIASMOKE",
                  AWS_SECRET_ACCESS_KEY="smoke-secret",
                  AWS_REGION="us-east-1"):
            sfr, dt = _timed(lambda: h2o.import_file(
                "s3://smoke/flagship.csv"))
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(60)
    mb = len(body) / 1e6
    metric("s3_import_s", dt, f"({mb:.3f} MB; phase 3l's flagship_parse_s "
           f"{RUN['flagship_parse_s']!r})")
    metric("s3_mb_per_sec", mb / dt)
    check(seen == [True], f"the S3 endpoint saw requests {seen}")
    same_frames("S3 import vs phase 3l's local import", sfr, fr_3l)
    print("s3:// import: one signed GET (SigV4 checked by the endpoint), "
          "the frame bitwise equal to phase 3l's")


def phase_resume(h2o, dev, tmp, csv_path, fr_3l):
    """Durable job progress, grid recovery and the S3 reader through the
    port's entry points. Returns the kernel's launches per path."""
    import os

    launches = {}
    ckdir = os.path.join(tmp, "ckpt")
    os.makedirs(ckdir, exist_ok=True)
    fr = flagship_frame(h2o, dev, FLAGSHIP["n_rows"])
    with _env(H2O_TPU_OPLOG_CKPT_DIR=ckdir):
        _resume_gbm(h2o, dev, fr, tmp, ckdir, launches)
        _resume_drf(h2o, dev, launches)
        _resume_glm_kmeans_dl(h2o, dev, fr)
        _resume_grid(h2o, fr, tmp, launches)
        _resume_rest(h2o, fr, tmp)
    _s3_import(h2o, dev, csv_path, fr_3l)
    return launches


# ---------------------------------------------------------------------------
# phase 3x: the cross-process control plane (two processes on the card)
# ---------------------------------------------------------------------------

# short knobs for the phase: both processes read them from the env
CLOUD = dict(H2O_TPU_HEARTBEAT_STALE_S="2", H2O_TPU_OP_ACK_TIMEOUT_S="10",
             H2O_TPU_MESH_TIMEOUT_S="30",
             H2O_TPU_OPLOG_CHECKPOINT_OPS="3", H2O_TPU_JOB_CKPT_ITERS="2",
             H2O_TPU_OPLOG_CKPT_ASYNC="0", H2O_TPU_SUPERVISE_INTERVAL_S="0.25",
             H2O_TPU_AUTO_RECOVER="1", H2O_TPU_ELECTION_GRACE_S="3600")
CLOUD_KILL_AT = 10          # SIGKILL the follower past this durable tree
CLOUD_DEADLINE_S = 120      # each wait of the phase


def _digest(obj, rows=None) -> str:
    """sha256 over a tree model's forest bits, or over a frame's columns'
    device bytes (on a row-sharded cloud the process's own rows; `rows`
    = (lo, hi) hashes those rows of a one-process frame): both processes
    hash alike."""
    import hashlib

    h = hashlib.sha256()
    lo, hi = rows if rows is not None else (None, None)
    if getattr(obj, "forest", None) is not None:
        arrays = _forest_bits(obj)
    else:
        arrays = {n: _col_bytes(obj.col(n), lo, hi) for n in obj.names}
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(f"{k}{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _col_bytes(c, lo, hi) -> np.ndarray:
    """A column's rows [lo, hi) as an array to hash: its device bytes, or
    a host-only column's values (strings) as their reprs."""
    if c.data is not None:
        return c.data[lo:hi].detach().cpu().contiguous().numpy()
    return np.frombuffer("\x1f".join(map(repr, c.host_data[lo:hi]))
                         .encode(), np.uint8)


def _bytes_digest(a) -> str:
    """sha256 over an array's bytes (a tensor's on the host)."""
    import hashlib

    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype}{a.shape}".encode()
                          + a.tobytes()).hexdigest()


def _blk(n, r, size=2):
    """Rank r's rows of n on a row mesh of `size` ranks."""
    from h2o3_tpu_torch.parallel import mesh as M

    return M.row_block(n, r, size)


def _write_json(path, obj) -> None:
    import os

    with open(path + ".part", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".part", path)


def cloud_child(outdir: str, rejoin: bool, die_at: str = "") -> None:
    """Phase 3x's follower process (process 1), on the card as the
    coordinator is. It joins the cloud from ``H2O_TPU_COORDINATOR``,
    ``H2O_TPU_NUM_PROCESSES`` and ``H2O_TPU_PROCESS_ID``, rejoins from the
    latest control-plane checkpoint when asked, and replays ops until the
    coordinator's shutdown op. After every op it writes ``status.json``:
    each op's kind and its hist_gather launches, and the digest of every
    ``cloud_*`` model and frame in its DKV. With `die_at`, it kills itself
    (SIGKILL) in ROADMAP C47's window of the first replayed op whose
    payload names `die_at`: after the op's collectives, before its rank
    section and ack (the ``oplog.replay.collectives_done`` fault
    point)."""
    import os

    t0 = time.perf_counter()
    from h2o3_tpu_torch.parallel import distributed as D

    D.initialize()
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from h2o3_tpu_torch.parallel import oplog

    dev = h2o.init().device
    if dev.type != "cuda" or D.process_count() != 2 \
            or D.process_index() != 1:
        raise SystemExit(f"cloud child on {dev}, process "
                         f"{D.process_index()} of {D.process_count()}")
    ops = []
    last = [0]

    def status(kind, payload):
        ops.append({"kind": kind, "resume": bool(payload.get("resume_job")),
                    "launches": hg.launches - last[0]})
        last[0] = hg.launches
        digests = {}
        for k in DKV.keys():
            if str(k).startswith("cloud_"):
                obj = DKV.get(k)
                if hasattr(obj, "names") or hasattr(obj, "forest"):
                    digests[str(k)] = _digest(obj)
        torch.cuda.synchronize()
        _write_json(os.path.join(outdir, "status.json"),
                    {"ops": ops, "digests": digests})

    if die_at:
        import signal

        from h2o3_tpu_torch.core import failure

        replay, point, now = oplog._replay, failure.faultpoint, {}

        def tracked(seq, kind, payload):
            now["op"] = json.dumps(payload)
            return replay(seq, kind, payload)

        def fault(name):
            if name == "oplog.replay.collectives_done" \
                    and die_at in now.get("op", ""):
                os.kill(os.getpid(), signal.SIGKILL)
            return point(name)

        oplog._replay, failure.faultpoint = tracked, fault
    hg.launches = 0
    cursor = D.rejoin() if rejoin else 0
    status("rejoin" if rejoin else "boot", {})
    _write_json(os.path.join(outdir, "ready.json"),
                {"cursor": cursor, "device": torch.cuda.get_device_name(dev),
                 "boot_s": time.perf_counter() - t0})
    oplog.follower_loop(idle_timeout_s=900, on_op=status, start_seq=cursor)


class _Follower:
    """Phase 3x's child: spawned on the card, its files read, killed in
    the end whatever happened."""

    def __init__(self, store_port, outdir, rejoin, die_at=""):
        import os

        self.out = outdir
        for n in ("ready.json", "status.json"):
            if os.path.exists(os.path.join(outdir, n)):
                os.unlink(os.path.join(outdir, n))
        env = dict(os.environ, H2O_TPU_COORDINATOR=f"127.0.0.1:{store_port}",
                   H2O_TPU_NUM_PROCESSES="2", H2O_TPU_PROCESS_ID="1",
                   TORCH_CPP_LOG_LEVEL="ERROR")
        self.log = open(os.path.join(outdir, "child.log"), "a")
        root = str(Path(__file__).resolve().parent)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.cloud_child("
             f"{outdir!r}, {rejoin!r}, {die_at!r})"], cwd=root, env=env,
            stdout=self.log,
            stderr=subprocess.STDOUT)

    def read(self, name):
        import os

        try:
            with open(os.path.join(self.out, name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def wait(self, name, pred=lambda d: True, what=""):
        while True:
            d = self.read(name)
            if d is not None and pred(d):
                return d
            if self.proc.poll() is not None:
                self.log.flush()
                raise SmokeFailure(f"the cloud child ended (code "
                                   f"{self.proc.returncode}) waiting for "
                                   f"{what or name}: {self.tail()}")
            check(time.perf_counter() - self.t0 < CLOUD_DEADLINE_S,
                  f"the cloud child: no {what or name} within "
                  f"{CLOUD_DEADLINE_S} s: {self.tail()}")
            time.sleep(0.01)

    def tail(self):
        import os

        self.log.flush()
        try:
            with open(os.path.join(self.out, "child.log")) as f:
                return f.read()[-3000:]
        except OSError:
            return ""

    def kill(self):
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(60)
        self.log.close()


def _until(cond, what, deadline_s=CLOUD_DEADLINE_S):
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < deadline_s,
              f"{what} within {deadline_s} s")
        time.sleep(0.01)
    return time.perf_counter() - t0


CLOUD_STATEMENT = ("(tmp= {dst} (- (+ (abs (- (* {A} 0.5) {C})) (* {B} 0.25)) "
                   "(* {A} 0.125)))")


def _cloud_refs(h2o, csv_path):
    """Part A's one-process references, made before the cloud forms: the
    flagship imported, trained, scored and munged in this process, each
    frame's digest of the rows each rank of two holds."""
    from h2o3_tpu_torch.parallel import mesh as M

    fr = h2o.import_file(csv_path, destination_frame="cloud_ref.hex")
    m = h2o.GBM(ntrees=FLAGSHIP["ntrees"],
                max_depth=FLAGSHIP["max_depth"]).train(y="y",
                                                       training_frame=fr)
    pred = m.predict(fr)
    A, B, C = (f"(cols cloud_ref.hex [{i}])" for i in range(3))
    h2o.exec_rapids(CLOUD_STATEMENT.format(dst="cloud_ref_rapids", A=A, B=B,
                                           C=C), h2o.Session("cloud_ref"))
    stmt = h2o.get_frame("cloud_ref_rapids")
    n = fr.nrows
    refs = {k: [_digest(f, M.row_block(n, r, 2)) for r in (0, 1)]
            for k, f in (("cloud_flagship.hex", fr), ("cloud_pred", pred),
                         ("cloud_rapids", stmt))}
    for k in ("cloud_ref.hex", str(m.key), str(pred.key),
              "cloud_ref_rapids"):
        h2o.DKV.remove(k)
    return refs


def _cloud_replay(h2o, R, fol, csv_path, launches, ack_ms, refs):
    """Part A: the flagship imported, trained, scored and munged over
    REST on the two-process cloud, each process holding its rows; the
    follower's forest bitwise the coordinator's and phase 3's, each
    process's rows of the frames bitwise the one-process rows."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from h2o3_tpu_torch.parallel import ckpt, oplog
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import mesh as M

    hg.launches = 0
    R.import_parse(csv_path, "cloud_flagship.hex")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    R.job(R.json("POST", "/3/ModelBuilders/gbm", {
        "training_frame": "cloud_flagship.hex", "response_column": "y",
        "ntrees": FLAGSHIP["ntrees"], "max_depth": FLAGSHIP["max_depth"],
        "model_id": "cloud_gbm"}))
    torch.cuda.synchronize()
    metric("cloud_train_s", time.perf_counter() - t0,
           f"(REST flagship train on the two-process cloud; one process "
           f"over REST, phase 3u: rest_gbm_train_s "
           f"{RUN.get('rest_gbm_train_s')!r})")
    launches["cloud"] = hg.launches
    check(hg.launches == FLAGSHIP["max_depth"] * FLAGSHIP["ntrees"],
          f"{hg.launches} hist_gather launches in the coordinator's cloud "
          "train")
    t0 = time.perf_counter()
    R.json("POST", "/3/Predictions/models/cloud_gbm/frames/"
           "cloud_flagship.hex", {"predictions_frame": "cloud_pred"})
    metric("cloud_predict_1m_s", time.perf_counter() - t0,
           f"({FLAGSHIP['n_rows']} rows, /3/Predictions mirrored)")
    A, B, C = (f"(cols cloud_flagship.hex [{i}])" for i in range(3))
    R.json("POST", "/99/Rapids", {
        "ast": CLOUD_STATEMENT.format(dst="cloud_rapids", A=A, B=B, C=C),
        "session_id": "cloud"})
    keys = ("cloud_flagship.hex", "cloud_gbm", "cloud_pred", "cloud_rapids")
    mine = {k: _digest(h2o.get_frame(k) if k != "cloud_gbm"
                       else h2o.get_model(k)) for k in keys}
    st = fol.wait("status.json", lambda d: all(k in d["digests"]
                                               for k in keys),
                  "the replayed frame, forest, predictions and statement")
    check(st["digests"]["cloud_gbm"] == mine["cloud_gbm"],
          "the follower's forest is not bitwise the coordinator's")
    _same_forest_bits("the cloud flagship", _forest_bits(
        h2o.get_model("cloud_gbm")), RUN["flagship_forest"])
    check(h2o.get_frame("cloud_flagship.hex").shard
          == M.row_block(FLAGSHIP["n_rows"], 0, 2),
          "the coordinator does not hold its block of the rows")
    for k in keys[:1] + keys[2:]:
        check(mine[k] == refs[k][0],
              f"the coordinator's rows of {k} are not the one-process rows")
        check(st["digests"][k] == refs[k][1],
              f"the follower's rows of {k} are not the one-process rows")
    print("cloud replay: each process holds its half of the rows; the "
          "forest is bitwise phase 3's in both; each process's rows of the "
          "frame, the 1M predictions and the Rapids result are bitwise the "
          "one-process rows")
    train_ops = [o for o in st["ops"] if o["kind"] == "train"]
    print(f"follower hist_gather launches (cloud train) "
          f"{train_ops[0]['launches']}")
    check(len(train_ops) == 1 and train_ops[0]["launches"]
          == FLAGSHIP["max_depth"] * FLAGSHIP["ntrees"],
          f"follower's launches on the cloud train: {train_ops}")
    lag = {r["process"]: r for r in oplog.follower_lag()}
    check(lag.get(1, {}).get("ack_lag") == 0, f"follower lag {lag}")
    recs = ckpt.records()
    check(bool(recs), "no control-plane checkpoint was written")
    seq = recs[-1][0]
    check(ckpt.truncated_through() >= seq
          and D.kv_try_get("oplog/0") is None
          and D.kv_try_get(f"oplog/ack/{seq}/1") is None,
          f"the prefix before checkpoint {seq} was not truncated")
    print(f"cloud checkpoint at op {seq} (keys that did not pickle: "
          f"{recs[-1][1].get('skipped', [])}); ops 0..{seq} truncated; "
          "follower ack lag 0")
    metric("op_ack_ms", float(np.median(ack_ms)),
           f"(median of {len(ack_ms)} ops' follower-ack waits)")
    return mine


def _cloud_kill_resume(h2o, R, store_port, tmp, fol, launches, mine):
    """Part B: the follower killed mid-train, the job failed from
    outside, the follower rejoined from the checkpoint, the job resumed
    by the watchdog: bitwise with the uninterrupted flagship in both."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import supervisor

    out = R.json("POST", "/3/ModelBuilders/gbm", {
        "training_frame": "cloud_flagship.hex", "response_column": "y",
        "ntrees": FLAGSHIP["ntrees"], "max_depth": FLAGSHIP["max_depth"],
        "model_id": "cloud_gbm2"})
    jk = out["job"]["key"]["name"]

    def saved():
        raw = D.kv_try_get(f"oplog/jobckpt/{jk}")
        return json.loads(raw)["iteration"] if raw else 0

    _until(lambda: saved() >= CLOUD_KILL_AT, "a durable save past tree "
                                             f"{CLOUD_KILL_AT}")
    t_kill = time.perf_counter()
    fol.kill()
    print(f"cloud follower killed (SIGKILL) after the coordinator's save "
          f"at tree {saved()}")

    def job():
        return R.json("GET", f"/3/Jobs/{jk}")["jobs"][0]

    _until(lambda: job()["status"] == "FAILED", "the train's job FAILED")
    j = job()
    check(supervisor.state() != supervisor.HEALTHY
          and "row mesh" in (j.get("exception") or ""),
          f"job {jk} failed with {j.get('exception')!r} on a "
          f"{supervisor.state()} cloud")
    metric("collective_fail_s", time.perf_counter() - t_kill,
           "(SIGKILL to the coordinator's train FAILED by its collective; "
           f"mesh timeout {CLOUD['H2O_TPU_MESH_TIMEOUT_S']} s)")
    check(j.get("auto_recoverable") is True, f"job {jk}: {j}")
    print(f"cloud job {jk} FAILED from outside: "
          f"{(j.get('exception') or '').splitlines()[0][:300]}")
    print(f"cloud state {supervisor.state()}: "
          f"{supervisor.status()['reason'][:200]}")
    R.call("POST", "/99/Rapids", {"ast": "(+ 1 1)", "session_id": "cloud"},
           status=503)
    print("a REST request meanwhile: 503")
    # the killed train is over: from here the coordinator launches only
    # for the resume, which the watchdog may start the moment the rejoin
    # turns the cloud HEALTHY
    hg.launches = 0
    fol2 = _Follower(store_port, tmp, rejoin=True)
    ready = fol2.wait("ready.json", what="the rejoin")
    metric("rejoin_s", time.perf_counter() - fol2.t0,
           f"(spawn to caught up at op {ready['cursor']}: boot, "
           f"checkpoint restore onto {ready['device']}, suffix replay)")
    st = fol2.read("status.json")
    check(st["digests"].get("cloud_gbm") == mine["cloud_gbm"],
          "the rejoined follower's Part A forest differs")
    check(st["digests"].get("cloud_flagship.hex") == mine["fol_frame"],
          "the rejoined follower does not hold its own rows of the frame")
    _until(lambda: supervisor.state() == supervisor.HEALTHY,
           "the cloud HEALTHY again")
    trans = supervisor.status()["transitions"]
    arc = [t["to"] for t in trans]
    print(f"cloud transitions: {arc}")
    check(arc[-3:] == ["FAILED", "RECOVERING", "HEALTHY"],
          f"the supervisor's arc {arc}")
    metric("secs_to_healthy", time.perf_counter() - t_kill,
           "(SIGKILL to HEALTHY, the rejoin included)")
    _until(lambda: job()["status"] == "DONE", "the resumed job DONE")
    metric("job_resume_s", time.time() - trans[-1]["ts"],
           "(the cloud HEALTHY again to the resumed job DONE seen, by "
           "the watchdog)")
    j = job()
    k = int(j["resumed_from_iteration"])
    check(j["attempt"] == 2 and CLOUD_KILL_AT <= k < FLAGSHIP["ntrees"],
          f"resumed job {j}")
    launches["cloud_resume"] = hg.launches
    want = FLAGSHIP["max_depth"] * (FLAGSHIP["ntrees"] - k)
    check(hg.launches == want, f"{hg.launches} coordinator launches on "
                               f"the resume from tree {k}, not {want}")
    m2 = h2o.get_model("cloud_gbm2")
    got = _forest_bits(m2)
    for a in RUN["flagship_forest"]:
        check(np.array_equal(got[a], RUN["flagship_forest"][a]),
              f"the resumed cloud forest's {a} differs from phase 3's")
    st = fol2.wait("status.json", lambda d: "cloud_gbm2" in d["digests"]
                   and any(o["resume"] for o in d["ops"]),
                   "the follower's resumed train")
    check(st["digests"]["cloud_gbm2"] == _digest(m2),
          "the follower's resumed forest is not the coordinator's")
    res = [o for o in st["ops"] if o["resume"]]
    print(f"follower hist_gather launches (cloud resume) "
          f"{res[0]['launches']}")
    check(res[0]["launches"] == want, f"follower resume launches {res}")
    print(f"cloud resume from tree {k}: forest bitwise with phase 3's in "
          f"both processes; {want} launches each")
    R.json("POST", "/3/Predictions/models/cloud_gbm/frames/"
           "cloud_flagship.hex", {"predictions_frame": "cloud_pred_after"})
    st = fol2.wait("status.json", lambda d: "cloud_pred_after"
                   in d["digests"], "the rejoined follower's predict")
    check(st["digests"]["cloud_pred_after"] == mine["fol_pred"]
          and _digest(h2o.get_frame("cloud_pred_after"))
          == mine["cloud_pred"], "the rejoined follower's predictions of "
                                 "Part A's model differ")
    print("the rejoined follower's Part A model predicts bitwise with the "
          "coordinator's")
    return fol2


def drill_recover():
    """The reference's recovery drill (h2o3_tpu/bench.py:427 run_recover)
    on the port: seconds from a silent coordinator to HEALTHY, the
    watchdog electing this process and the ex-coordinator's rejoin the
    only outside event. Memory KV: the control plane alone."""
    import os

    from h2o3_tpu_torch.core import failure
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import oplog, supervisor, watchdog

    knobs = dict(H2O_TPU_OPLOG_CKPT_DIR=tempfile.mkdtemp(
        prefix="chip_smoke_recover_"), H2O_TPU_ELECTION_GRACE_S="0.2",
        H2O_TPU_HEARTBEAT_STALE_S="1.0", H2O_TPU_AUTO_RECOVER="1",
        H2O_TPU_OPLOG_CHECKPOINT_OPS="0")
    count = D.process_count
    with _env(**knobs), D.memory_kv() as kv:
        D.process_count = lambda: 2
        wd = None
        try:
            D.write_epoch_record(0, 1)
            D.set_leader(1, 0)
            kv["h2o3/heartbeat/1"] = json.dumps({"ts": time.time() - 999,
                                                 "proc": 1})
            failure.heartbeat()
            oplog.reset()
            supervisor.reset()
            watchdog.reset()
            t0 = time.perf_counter()
            wd = watchdog.Watchdog(interval=0.05, follow=False).start()
            _until(D.is_coordinator, "the drill's election", 30)
            kv["h2o3/heartbeat/1"] = json.dumps({"ts": time.time(),
                                                 "proc": 1, "inc": 1})
            _until(lambda: supervisor.evaluate() == supervisor.HEALTHY,
                   "the drill's HEALTHY", 30)
            dt = time.perf_counter() - t0
        finally:
            if wd is not None:
                wd.stop()
            D.process_count = count
            oplog.reset()
            supervisor.reset()
            watchdog.reset()
            D.reset_leadership()
            shutil.rmtree(knobs["H2O_TPU_OPLOG_CKPT_DIR"],
                          ignore_errors=True)
    metric("recover_secs_to_healthy", dt, "(run_recover, memory KV)")


def drill_search_recover(h2o, dev, n_rows=1_500):
    """The reference's search-recovery drill (h2o3_tpu/bench.py:490
    run_search_recover) on the port and the card: a GLM grid loses its
    coordinator after two members; the watchdog rebuilds its job under
    the original key and finishes the leaderboard from durable state."""
    from h2o3_tpu_torch.automl import search
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.core.job import Job
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import oplog, supervisor, watchdog

    rng = np.random.default_rng(0)
    X = rng.normal(size=(n_rows, 3))
    yv = np.where(X[:, 0] + 0.5 * X[:, 1]
                  + rng.normal(scale=0.3, size=n_rows) > 0, "Y", "N")
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_search_recover_")
    orig = search.SearchEngine._build_one
    with _env(H2O_TPU_OPLOG_CKPT_DIR=ckdir, H2O_TPU_AUTO_RECOVER="1",
              H2O_TPU_SEARCH_CONCURRENCY="2"), D.memory_kv():
        wd = None
        try:
            oplog.reset()
            supervisor.reset()
            watchdog.reset()
            search.reset_stats()
            fr = h2o.Frame()
            for i, n in enumerate("abc"):
                fr.add(n, h2o.Column.from_numpy(X[:, i], device=dev))
            fr.add("y", h2o.Column.from_numpy(yv, ctype="enum", device=dev))
            fr.install()
            gid = "chip_smoke_search_recover_grid"
            job = Job(description="glm Grid Build", dest=gid)
            grid = h2o.H2OGridSearch(h2o.GLM(family="binomial"),
                                     {"alpha": [0.0, 0.3, 0.6, 1.0]},
                                     grid_id=gid)
            grid._search_job = job
            settled = {"n": 0}

            def dying(self, m, build_fn, score_fn=None):
                if settled["n"] >= 2:
                    raise RuntimeError("simulated coordinator loss")
                settled["n"] += 1
                return orig(self, m, build_fn, score_fn)

            search.SearchEngine._build_one = dying
            try:
                grid.train(y="y", training_frame=fr)
                raise SmokeFailure("the drill's grid outlived its loss")
            except RuntimeError as e:
                check("simulated coordinator loss" in str(e), str(e))
            finally:
                search.SearchEngine._build_one = orig
            DKV.remove(str(job.key))
            t0 = time.perf_counter()
            wd = watchdog.Watchdog(interval=0.05, follow=False).start()

            def done():
                j = DKV.get(str(job.key))
                return isinstance(j, Job) and j.status == Job.DONE

            _until(done, "the drill's resumed grid DONE", 60)
            dt = time.perf_counter() - t0
        finally:
            search.SearchEngine._build_one = orig
            if wd is not None:
                wd.stop()
            oplog.reset()
            supervisor.reset()
            watchdog.reset()
            shutil.rmtree(ckdir, ignore_errors=True)
    st = search.stats()
    check(st.get("searches_resumed", 0) >= 1
          and st.get("members_done", 0) >= 4, f"search drill stats {st}")
    print(f"search_members_overlap {st.get('overlap', 0)}")
    metric("search_recover_secs", dt, "(run_search_recover, GLM grid on "
                                      "the card)")


def phase_cloud(h2o, dev, tmp, csv_path):
    """Phase 3x: this process is the coordinator of a two-process cloud
    (the store's host, the REST server); a child process on the same card
    is the follower. Part A replays the flagship over REST, Part B kills
    the follower mid-train and lets the watchdog resume the job after
    the follower's rejoin, Part C runs the reference's two recovery
    drills. Returns the kernel's launches per path of this process."""
    import datetime
    import os

    import torch.distributed as dist

    from h2o3_tpu_torch.api.server import start_server
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import oplog, supervisor, watchdog

    launches = {}
    ctmp = os.path.join(tmp, "cloud")
    os.makedirs(ctmp, exist_ok=True)
    ack_ms = []
    wait_acks = oplog.wait_acks

    def timed_wait(seq, timeout_s=None):
        t0 = time.perf_counter()
        wait_acks(seq, timeout_s)
        if seq is not None:
            ack_ms.append((time.perf_counter() - t0) * 1e3)

    refs = _cloud_refs(h2o, csv_path)
    folls, srv = [], None
    with _env(H2O_TPU_OPLOG_CKPT_DIR=os.path.join(ctmp, "ckpt"), **CLOUD):
        store = dist.TCPStore("127.0.0.1", 0, 2, True,
                              timeout=datetime.timedelta(seconds=60),
                              wait_for_workers=False)
        D.initialize(store=store, num_processes=2, process_id=0)
        oplog.reset()
        supervisor.reset()
        watchdog.reset()
        oplog.wait_acks = timed_wait
        try:
            srv = start_server(port=0)
            R = _Rest(srv.port)
            folls.append(_Follower(store.port, ctmp, rejoin=False))
            ready = folls[0].wait("ready.json", what="the follower's boot")
            check("H100" in ready["device"] or ready["device"]
                  == torch.cuda.get_device_name(dev),
                  f"the follower runs on {ready['device']}")
            metric("follower_boot_s", time.perf_counter() - folls[0].t0,
                   f"(spawn to replaying, on {ready['device']})")
            _until(lambda: supervisor.state() == supervisor.HEALTHY,
                   "the two-process cloud HEALTHY")
            mine = _cloud_replay(h2o, R, folls[0], csv_path, launches,
                                 ack_ms, refs)
            mine["fol_frame"] = refs["cloud_flagship.hex"][1]
            mine["fol_pred"] = refs["cloud_pred"][1]
            folls.append(_cloud_kill_resume(h2o, R, store.port, ctmp,
                                            folls[0], launches, mine))
            oplog.publish("shutdown", {})
            folls[-1].proc.wait(60)
            check(folls[-1].proc.returncode == 0, "the follower did not end "
                  f"cleanly: {folls[-1].tail()}")
        finally:
            oplog.wait_acks = wait_acks
            for f in folls:
                f.kill()
            if srv is not None:
                srv.stop()
            D.shutdown()
            oplog.reset()
            supervisor.reset()
            watchdog.reset()
    for k in [k for k in h2o.DKV.keys() if str(k).startswith("cloud_")]:
        h2o.DKV.remove(k)
    drill_recover()
    drill_search_recover(h2o, dev)
    return launches


# ---------------------------------------------------------------------------
# phase 3y: frame rows sharded across two processes (the row mesh)
# ---------------------------------------------------------------------------

SHARD = dict(drf_trees=10, drf_depth=5, glm_rtol=1e-6, mesh_timeout_s="120",
             time_reps=5)
# phase 3y's munging: an 80/20 split, a sort by one numeric key,
# an inner join with a 1,000-row lookup on a 1,000-level categorical key
# (row i's key is level i % 1000), a group-by on the two enums; AutoML's
# plan, cut to 2 models, 2 folds, GLM and GBM (and their ensembles)
SHARD_MUNGE = dict(ratios=[0.8], seed=1, sort_key="n0", lookup_rows=1000)
SHARD_AML = dict(max_models=2, nfolds=2, seed=1,
                 include_algos=["glm", "gbm", "stackedensemble"])


def _munge_steps(h2o, fr):
    """Phase 3y's munging of the flagship frame `fr`, one process's or a
    rank's of the row mesh: -> ({name: result frame}, {step: seconds,
    bytes this process sent through the row exchange, rows gathered})."""
    from h2o3_tpu_torch.core import sharded_frame as SF
    from h2o3_tpu_torch.core.frame import Column
    from h2o3_tpu_torch.ops.filters import split_frame
    from h2o3_tpu_torch.ops.groupby import GroupBy
    from h2o3_tpu_torch.ops.merge import merge
    from h2o3_tpu_torch.ops.sort import sort_frame

    c = SHARD_MUNGE
    n, L = fr.nrows, c["lookup_rows"]
    dev = fr.col(0).device
    dom = [f"k{i:04d}" for i in range(L)]
    keyed = fr.subframe(fr.names)
    keyed.add("k", Column.from_numpy(np.arange(n) % L, ctype="enum",
                                     domain=dom, device=dev))
    look = h2o.Frame()
    look.add("k", Column.from_numpy(np.arange(L)[::-1].copy(), ctype="enum",
                                    domain=dom, device=dev))
    look.add("w", Column.from_numpy(np.random.default_rng(7)
                                    .standard_normal(L), device=dev))
    out, stats = {}, {}

    def step(name, fn):
        c0 = SF.counters()
        res, dt = _timed(fn)
        c1 = SF.counters()
        stats[name] = {"s": dt, "exchanged_bytes": c1["exchanged_bytes"]
                       - c0["exchanged_bytes"],
                       "gathered_rows": c1["gathered_rows"]
                       - c0["gathered_rows"]}
        return res

    out["split_0"], out["split_1"] = step("split", lambda: split_frame(
        fr, c["ratios"], seed=c["seed"]))
    out["sort"] = step("sort", lambda: sort_frame(fr, c["sort_key"]))
    out["merge"] = step("merge", lambda: merge(keyed, look))
    out["groupby"] = step("groupby", lambda: GroupBy(fr, ["c0", "c1"])
                          .count().mean("n0").sum("n1").min("n2").max("n3")
                          .get_frame())
    return out, stats


# phase 3y's Rapids prims on row-sharded frames (ROADMAP A14.6c part 1),
# on the flagship frame with two row-local columns added: `na`, n0 where
# n1 <= 1.2 (NA elsewhere, ~11% of rows), and `c0na`, c0 where n2 <= 1.5.
# Columns: n0..n7 0-7, c0 8, c1 9, y 10, na 11, c0na 12. Each step: its
# statements (the last one's value is the result) and its bar against
# one process: bitwise, 1e-6 relative over 1e-7 (C46), or 1e-5 of the
# column's sum of |x| (C16)
SHARD_PRIMS = [
    ("impute_median", ["(tmp= {t}_im (cols {f} [11]))",
                       "(h2o.impute {t}_im 0 'median' 'interpolate' [] _ _)",
                       "{t}_im"], "bit"),
    ("impute_mode", ["(tmp= {t}_io (cols {f} [12]))",
                     "(h2o.impute {t}_io 0 'mode' 'interpolate' [] _ _)",
                     "{t}_io"], "bit"),
    ("as.factor", ["(as.factor (floor (* (cols {f} [0]) 2)))"], "bit"),
    ("scale", ["(scale (cols {f} [0 1]) 1 1)"], "rel"),
    ("cumsum", ["(cumsum (cols {f} [1]) 0)"], "c16"),
    ("cummax", ["(cummax (cols {f} [2]) 0)"], "bit"),
    ("difflag1", ["(difflag1 (cols {f} [3]))"], "bit"),
    ("hist", ["(hist (cols {f} [0]) 20)"], "bit"),
    ("cor", ["(cor (cols {f} [0 1 2]) (cols {f} [0 1 2]) 'complete.obs' "
             "'pearson')"], "rel"),
    ("which.max", ["(which.max (cols {f} [0 1 2]) True 0)"], "bit"),
    ("mad", ["(mad (cols {f} [4]) 1.4826)"], "bit"),
    ("topn", ["(topn {f} 5 1 1)"], "bit"),
    ("dropdup", ["(dropdup {f} [8 9] 'first')"], "bit"),
    ("fillna", ["(h2o.fillna (cols {f} [11]) 'forward' 0 3)"], "bit"),
    ("rank_within_groupby", ['(rank_within_groupby (cols {f} [0 8]) [1] '
                             '[0] [1] "r" 0)'], "bit"),
]


def _prim_steps(h2o, fr, tag):
    """Phase 3y's Rapids prims (`SHARD_PRIMS`) on the flagship frame `fr`,
    one process's or a rank's: -> ({step: digest, domains, rows and
    shard of a frame, or the value}, {step: seconds, bytes this process
    sent through the row exchange, rows gathered}, {step: this process's
    rows of a frame held to a tolerance})."""
    from h2o3_tpu_torch.core.frame import Column

    pf = h2o.Frame(key=f"prims_{tag}.hex")
    for nm in fr.names:
        pf.add(nm, fr.col(nm))
    n0, n1, n2 = (fr.col(f"n{i}").data for i in range(3))
    c0 = fr.col("c0")
    pf.add("na", Column(torch.where(n1 > 1.2, torch.nan, n0), "real",
                        fr.nrows))
    pf.add("c0na", Column(torch.where(n2 > 1.5, -1, c0.data.long()).to(
        c0.data.dtype), "enum", fr.nrows, domain=c0.domain))
    return _run_steps(h2o, SHARD_PRIMS, [pf], tag, {"f": pf.key,
                                                    "t": f"prims_{tag}"})


def _run_steps(h2o, steps, frames, tag, keys, special=None):
    """`steps` (name, Rapids statements or a key of `special`, bar) on
    the installed `frames` (the statements' keys `keys`), one process's
    or a rank's; each frame is removed after. -> `_prim_steps`' three
    parts."""
    from h2o3_tpu_torch.core import sharded_frame as SF
    from h2o3_tpu_torch.rapids import Session, exec_rapids

    for f in frames:
        f.install()
    sess = Session(f"steps_{tag}")
    out, stats, arrays = {}, {}, {}
    try:
        for name, sts, bar in steps:
            c0_ = SF.counters()
            t0 = time.perf_counter()
            if isinstance(sts, str):
                v = special[sts]()
            else:
                for st in sts:
                    v = exec_rapids(st.format(**keys), sess)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            c1_ = SF.counters()
            stats[name] = {"s": dt, "exchanged_bytes": c1_["exchanged_bytes"]
                           - c0_["exchanged_bytes"],
                           "gathered_rows": c1_["gathered_rows"]
                           - c0_["gathered_rows"]}
            if isinstance(v, h2o.Frame):
                out[name] = {"digest": _digest(v), "rows": v.nrows,
                             "shard": None if v.shard is None
                             else list(v.shard),
                             "domains": [v.col(c).domain for c in v.names],
                             "blocks": [_digest(v, _blk(v.nrows, r))
                                        for r in (0, 1)]}
                if bar != "bit":
                    arrays[name] = np.stack([
                        v.col(c).data.float().cpu().numpy()
                        for c in v.names])
            else:
                out[name] = {"value": v}
    finally:
        sess.end()
        for f in frames:
            h2o.DKV.remove(str(f.key))
    return out, stats, arrays


def _check_prims(mine, theirs, arr1, ref, steps=None, key="prims",
                 label="sharded_prims_s", gathered=None):
    """Phase 3y's prims on both ranks against the one-process run `ref`
    (`_prim_steps`' three parts), at each step's bar; no row gathered
    (or a step's `gathered` count exactly). Prints each step's seconds
    beside one process's, its exchanged bytes and gathered rows, and
    `label`'s total."""
    steps = SHARD_PRIMS if steps is None else steps
    gathered = gathered or {}
    one, one_stats, one_arrays = ref
    bars = {name: bar for name, _sts, bar in steps}
    for rk, r, got_arrays in ((0, mine, mine[f"{key}_arrays"]),
                              (1, theirs, arr1)):
        for name, got in r[key].items():
            want, bar = one[name], bars[name]
            g = r[f"{key}_stats"][name]["gathered_rows"]
            check(g == gathered.get(name, 0),
                  f"rank {rk}: {name} gathered {g} rows")
            if "value" in want:
                a = np.asarray(want["value"], np.float64)
                b = np.asarray(got["value"], np.float64)
                ok = (np.array_equal(a, b, equal_nan=True) if bar == "bit"
                      else np.all(np.abs(a - b) <= 1e-6 * np.abs(a) + 1e-7))
                check(ok, f"rank {rk}: {name} {b} vs one process's {a}")
                continue
            check(got["rows"] == want["rows"] and got["domains"]
                  == want["domains"], f"rank {rk}: {name}'s rows or "
                  "domains differ from one process's")
            lo, hi = (0, want["rows"]) if got["shard"] is None else \
                _blk(want["rows"], rk)
            check(got["shard"] in (None, [lo, hi]), f"rank {rk}: {name} "
                  f"holds {got['shard']}")
            if bar == "bit":
                check(got["digest"] == (want["digest"] if got["shard"] is None
                                        else want["blocks"][rk]),
                      f"rank {rk}: {name} differs from one process's rows")
                continue
            a = one_arrays[name][:, lo:hi].astype(np.float64)
            b = np.asarray(got_arrays[name], np.float64)
            tol = (1e-5 * float(np.nansum(np.abs(one_arrays[name])))
                   if bar == "c16" else 1e-6 * np.abs(a) + 1e-7)
            check(a.shape == b.shape and np.array_equal(
                np.isnan(a), np.isnan(b)) and np.all(
                np.abs(np.nan_to_num(a - b)) <= tol),
                f"rank {rk}: {name} off one process's by "
                f"{np.nanmax(np.abs(a - b))!r}")
    total = 0.0
    for name, st in mine[f"{key}_stats"].items():
        total += st["s"]
        print(f"{label[:-2]} {name}: {st['s']!r} s (one process "
              f"{one_stats[name]['s']!r} s), exchanged_bytes "
              f"{st['exchanged_bytes']} (rank 0), "
              f"{theirs[f'{key}_stats'][name]['exchanged_bytes']} (rank 1), "
              f"gathered_rows {st['gathered_rows']}")
    metric(label, total, f"(one process "
           f"{sum(s['s'] for s in one_stats.values())!r}; "
           f"{len(steps)} steps, rank 0)")
    print(f"{label[:-2]}: {', '.join(bars)} one process's on both ranks at "
          f"their bars; rows gathered only where counted "
          f"({gathered or 'none'})")


# phase 3y's step for ROADMAP A14.6c part 1b (reshapes, user lambdas and
# string keys) on the flagship frame with row-local columns added: `na`
# as in SHARD_PRIMS, `s` the string of floor(n0*1000) (~8k distinct),
# `s2` that of floor(n0*100), `txt` c0's label, c1's label and
# "w" + floor(n0*10), `si` floor(n0*1000) as a number, `d` an enum of
# "D" (n3 > 0) and "N", `rid` the row id. Columns: n0..n7 0-7, c0 8,
# c1 9, y 10, na 11, s 12, s2 13, txt 14, si 15, d 16, rid 17. {b}: an
# 8x3 row-sharded frame (x), {o}: 16x2 row-sharded (distance), {m}: the
# labels of -6000..6000 as `s` with a value (a left merge's partner).
# Bars as SHARD_PRIMS'; `x` and `distance` gather exactly their second
# frame's rows
SHARD_RESHAPE = [
    ("x", ["(x (cols {f} [0 1 2 3 4 5 6 7]) {b})"], "rel"),
    ("melt", ['(melt (cols {f} [8 0 11]) [0] [1 2] "variable" "value" 1)'],
     "bit"),
    ("pivot", ["(pivot {f} 's2' 'c0' 'n1')"], "bit"),
    ("ddply", ['(ddply (cols {f} [0 8 9]) [1 2] {{ x . (mean (cols_py x '
               '"n0") True 0) }})'], "bit"),
    ("isax", ["(isax (cols {f} [0 1 2 3 4 5 6 7]) 2 4 0)"], "bit"),
    ("random_stratified_split", ["(h2o.random_stratified_split "
                                 "(cols {f} [10]) 0.25 42)"], "bit"),
    ("spearman", ["(cor (cols {f} [0 1 2]) (cols {f} [0 1 2]) "
                  "'complete.obs' 'spearman')"], "rel"),
    ("distance", ["(distance (cols {f} [0 1]) {o} 'l2')"], "rel"),
    ("dropdup", ["(dropdup (cols {f} [12 8]) [0 1] 'first')"], "bit"),
    ("rank_within_groupby", ['(rank_within_groupby (cols {f} [12 0]) [0] '
                             '[1] [1] "r" 0)'], "bit"),
    ("merge", ["(merge (cols {f} [12 0]) {m} 1 0 [] [] 'auto')"], "bit"),
    ("t", ["(t (rows (cols {f} [0 1 2 3 4 5 6 7]) [0:1000]))"], "bit"),
    ("apply", ["(apply (rows (cols {f} [0 1 2]) [0:2000]) 1 "
               "{{ x . (max x) }})"], "bit"),
    ("grouped_permute", ["(grouped_permute (rows (cols {f} [0 15 16 1]) "
                         "[0:20000]) 0 [1] 2 3)"], "bit"),
    ("tf-idf", ["(tf-idf (rows (cols {f} [17 14]) [0:100000]) 0 1 1 0)"],
     "bit"),
    ("append", "append", "bit"),
]
RESHAPE_GATHERED = {"x": 8, "distance": 16}
APPEND_ROWS = 1000


def _append_batch(n=APPEND_ROWS, seed=9) -> str:
    """A CSV batch of the flagship's columns; c0 brings a new label."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8))
    c0 = np.array(["a", "b", "c", "d", "e"])[rng.integers(0, 5, n)]
    c1 = np.array(["x", "y", "z"])[rng.integers(0, 3, n)]
    y = np.array(["N", "Y"])[rng.integers(0, 2, n)]
    return "".join(",".join([f"{v:.6g}" for v in x[i]] + [c0[i], c1[i],
                                                            y[i]]) + "\n"
                   for i in range(n))


def _reshape_steps(h2o, fr, tag):
    """Phase 3y's part 1b step (`SHARD_RESHAPE`) on the flagship frame
    `fr`, one process's or a rank's: `_prim_steps`' three parts."""
    from h2o3_tpu_torch.core.frame import Column
    from h2o3_tpu_torch.ingest.chunked import append_csv

    pf = h2o.Frame(key=f"reshape_{tag}.hex")
    for nm in fr.names:
        pf.add(nm, fr.col(nm))
    n = fr.nrows
    lo = fr.shard[0] if fr.shard is not None else 0
    n0 = fr.col("n0").data
    x0 = n0.double().cpu().numpy()
    c0 = np.asarray(fr.col("c0").domain, object)[
        fr.col("c0").data.long().cpu().numpy()]
    c1 = np.asarray(fr.col("c1").domain, object)[
        fr.col("c1").data.long().cpu().numpy()]

    def text(v):
        return v.astype(np.int64).astype(str).astype(object)

    k3, k2, k1 = (np.floor(x0 * f) for f in (1000, 100, 10))
    pf.add("na", Column(torch.where(fr.col("n1").data > 1.2, torch.nan, n0),
                        "real", n))
    pf.add("s", Column(None, "string", n, host_data=text(k3)))
    pf.add("s2", Column(None, "string", n, host_data=text(k2)))
    pf.add("txt", Column(None, "string", n, host_data=np.asarray(
        [f"{a} {b} w{int(k)}" for a, b, k in zip(c0, c1, k1)], object)))
    pf.add("si", Column(torch.from_numpy(k3.astype(np.float32)).to(
        n0.device), "real", n))
    pf.add("d", Column((fr.col("n3").data <= 0).to(torch.int8), "enum", n,
                       domain=["D", "N"]))
    pf.add("rid", Column(torch.arange(lo, lo + len(n0), device=n0.device,
                                      dtype=torch.float32), "real", n))
    rng = np.random.default_rng(21)
    b = h2o.Frame(key=f"reshape_b_{tag}.hex")
    for j in range(3):
        b.add(f"b{j}", Column.from_numpy(rng.standard_normal(8)))
    o = h2o.Frame(key=f"reshape_o_{tag}.hex")
    for j in range(2):
        o.add(f"o{j}", Column.from_numpy(rng.standard_normal(16)))
    mf = h2o.Frame(key=f"reshape_m_{tag}.hex")
    keys = np.arange(-6000, 6001)
    mf.add("s", Column.from_numpy(keys.astype(str).astype(object)))
    mf.add("v", Column.from_numpy((keys * 0.5).astype(np.float64)))
    af = h2o.Frame(key=f"reshape_a_{tag}.hex")
    for nm in fr.names:
        af.add(nm, fr.col(nm))

    def append():
        append_csv(af, _append_batch())
        return af

    return _run_steps(h2o, SHARD_RESHAPE, [pf, b, o, mf, af], tag,
                      {"f": pf.key, "b": b.key, "o": o.key, "m": mf.key},
                      {"append": append})


# phase 3y's multiclass and explanation step (ROADMAP A14.6c parts 2-3):
# a 4-class and a 3-class response cut on the mesh from z = n0 + n1/2 -
# n2/2, n0 then left out of the predictors (z's classes are not
# separable); multinomial GLM and a 20-tree depth-5 multinomial GBM on
# the 4 classes, ordinal GLM and AutoML on the 3; AutoML cut as 3y's is
# (2 models, 2 folds, GLM, GBM and ensembles) and its GBM step to 2
# trees of depth 6 (the exploitation step doubles them): its GLM member
# fails on a multiclass response and its AUTO metalearner refuses the
# multinomial family, in both packages; a 5-fold stratified CV GBM
# (depth 5, cut to 5 trees) on the flagship's response; the flagship GBM
# explained: leaves and staged probabilities on every row, TreeSHAP on a
# 200,000-row slice (host-bound), PDP on n1, n2 and c0 at 20 bins and
# the 2-D PDP of (n2, c0)
SHARD_MULTI = dict(z="(- (+ (cols {f} [0]) (* (cols {f} [1]) 0.5)) "
                     "(* (cols {f} [2]) 0.5))",
                   breaks4=[-1000, -0.7, 0, 0.7, 1000],
                   breaks3=[-1000, -0.5, 0.5, 1000], ntrees=20,
                   max_depth=5, aml_trees=2, aml_depth=6, cv_trees=5,
                   nfolds=5, contrib_rows=200_000,
                   pdp_cols=["n1", "n2", "c0"], nbins=20,
                   # ROADMAP C46; C54 for the unpenalised multinomial
                   # (L-BFGS stops on |g| <= 1e-6 of a flat optimum)
                   c46=dict(rtol=1e-6, atol=1e-6),
                   c54=dict(rtol=1e-5, atol=1e-5), pdp_atol=1e-6)
SHARD_MULTI_AML = dict(max_models=2, nfolds=2, seed=1,
                       include_algos=["glm", "gbm", "stackedensemble"])


@contextlib.contextmanager
def _cut_gbm_steps(trees, depth):
    """AutoML's default GBM step cut to `trees` trees of depth `depth`
    for the block (the plan's other steps as they are)."""
    from h2o3_tpu_torch.automl import steps

    saved = steps.GBMSteps.defaults

    def defaults(self, ctx):
        return [steps.step("def_gbm_1", "gbm", 10, steps.GROUP_DEFAULTS,
                           ntrees=trees, max_depth=depth, learn_rate=0.1,
                           sample_rate=0.8, col_sample_rate_per_tree=0.8)]

    steps.GBMSteps.defaults = defaults
    try:
        yield
    finally:
        steps.GBMSteps.defaults = saved


def _multiclass_frames(h2o, fr, tag):
    """(4-class frame, 3-class frame): the flagship's features but n0,
    and a response cut from z on this process's rows."""
    from h2o3_tpu_torch.rapids import Session, exec_rapids

    fr.install()
    sess = Session(f"multi_{tag}")
    z = SHARD_MULTI["z"].format(f=fr.key)
    ys = {}
    try:
        for k, br in (("y4", "breaks4"), ("y3", "breaks3")):
            edges = SHARD_MULTI[br]
            labels = " ".join(f'"k{i}"' for i in range(len(edges) - 1))
            v = exec_rapids(f"(cut {z} [{' '.join(map(str, edges))}] "
                            f"[{labels}] 0 1 3)", sess)
            ys[k] = v.col(v.names[0])
    finally:
        sess.end()
    feats = [n for n in fr.names if n not in ("n0", "y")]
    out = []
    for k in ("y4", "y3"):
        f = h2o.Frame(key=f"multi_{k}_{tag}.hex")
        for n in feats:
            f.add(n, fr.col(n))
        f.add("y", ys[k])
        out.append(f)
    return out


def _blocks(v, ref):
    """A result frame's digest: one process's two rank blocks (`ref`),
    else this rank's rows."""
    if ref:
        return [_digest(v, _blk(v.nrows, r)) for r in (0, 1)]
    return _digest(v)


def _probs(m, f):
    """This process's rows of a classifier's class probabilities."""
    p = m.predict(f)
    return np.stack([p.col(c).data.float().cpu().numpy()
                     for c in p.names[1:]], 1)


def _multiclass_steps(h2o, fr, gbm, tag):
    """Phase 3y's multiclass and explanation step on the flagship frame
    `fr` (one process's with tag "ref", else a rank's) and its flagship
    GBM `gbm`: -> (results, {name: this process's rows or coefficients}).
    Each path's kernel launches are counted from 0 just before it."""
    from h2o3_tpu_torch.core import sharded_frame as SF
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from h2o3_tpu_torch.ops.filters import take_rows

    ref = tag == "ref"
    c = SHARD_MULTI
    res, arrays = {}, {}
    g0 = SF.counters()["gathered_rows"]
    t_step = time.perf_counter()
    f4, f3 = _multiclass_frames(h2o, fr, tag)
    res["classes"] = [len(f4.col("y").domain), len(f3.col("y").domain)]
    for name, f in (("multinomial", f4), ("ordinal", f3)):
        m, dt = _timed(lambda: h2o.GLM(family=name).train(
            y="y", training_frame=f))
        res[f"glm_{name}"] = {"s": dt, "iterations": m.iterations,
                              "deviance": m.residual_deviance}
        arrays[f"glm_{name}_beta"] = m.beta.cpu().numpy()
        arrays[f"glm_{name}_probs"] = _probs(m, f)
        h2o.DKV.remove(str(m.key))
    hg.launches = 0
    m, dt = _timed(lambda: h2o.GBM(
        ntrees=c["ntrees"], max_depth=c["max_depth"], seed=1).train(
        y="y", training_frame=f4))
    res["gbm_multinomial"] = {"s": dt, "launches": hg.launches,
                              "levels": _levels(m), "forest": _digest(m),
                              "logloss": float(
                                  m._output.training_metrics.logloss)}
    h2o.DKV.remove(str(m.key))
    hg.launches = 0
    with _cut_gbm_steps(c["aml_trees"], c["aml_depth"]):
        aml, dt = _timed(lambda: h2o.H2OAutoML(
            project_name=f"multi_aml_{tag}", **SHARD_MULTI_AML).train(
            y="y", training_frame=f3))
    res["automl"] = {"s": dt, "launches": hg.launches,
                     "levels": sum(_levels(m) for m in aml.models
                                   if m.algo_name == "gbm"),
                     "members": _aml_members(aml),
                     "leaderboard": [[r["algo"], r.get("logloss")]
                                     for r in aml.leaderboard],
                     "failed": sorted(e["message"].split(":")[0]
                                      for e in aml.event_log
                                      if e["message"].startswith("FAILED"))}
    for k in [k for k in h2o.DKV.keys()
              if str(k).startswith(f"multi_aml_{tag}")]:
        h2o.DKV.remove(k)
    del aml
    hg.launches = 0
    gc0 = SF.counters()["gathered_rows"]
    cv, dt = _timed(lambda: h2o.GBM(
        ntrees=c["cv_trees"], max_depth=c["max_depth"], seed=1,
        nfolds=c["nfolds"], fold_assignment="Stratified").train(
        y="y", training_frame=fr))
    o = cv._output
    res["cv_stratified"] = {
        "s": dt, "launches": hg.launches, "levels": _levels(cv),
        "forest": _digest(cv),
        "folds": [_digest(f) for f in o.cross_validation_models],
        "fold_digest": o.fold_assignment_digest,
        "logloss": o.cross_validation_metrics.logloss,
        "gathered": SF.counters()["gathered_rows"] - gc0}
    h2o.DKV.remove(str(cv.key))
    # the flagship GBM explained
    ex = {}
    t0 = time.perf_counter()
    for kind in ("Path", "Node_ID"):
        v, ex[f"leaf_{kind}_s"] = _timed(
            lambda: gbm.predict_leaf_node_assignment(fr, type=kind))
        ex[f"leaf_{kind}"] = _blocks(v, ref)
        if kind == "Path":
            ex["path_domains"] = [v.col(n).domain for n in v.names]
    v, ex["staged_s"] = _timed(lambda: gbm.staged_predict_proba(fr))
    ex["staged"] = _blocks(v, ref)
    del v
    sl = take_rows(fr, np.arange(c["contrib_rows"]))
    v, ex["contrib_s"] = _timed(lambda: gbm.predict_contributions(sl))
    ex["contrib"] = _blocks(v, ref)
    del v, sl
    (pd, pd2), ex["pdp_s"] = _timed(lambda: (gbm.partial_plot(
        fr, cols=c["pdp_cols"], nbins=c["nbins"]), gbm.partial_plot(
        fr, col_pairs_2dpdp=[tuple(c["pdp_cols"][1:])], nbins=c["nbins"])))
    ex["pdp"] = [[t["column"], [v if isinstance(v, str) else float(v)
                                for v in t["values"]],
                  t["mean_response"], t["stddev_response"]] for t in pd]
    ex["pdp2"] = [[r[0], r[1] if isinstance(r[1], str) else float(r[1]),
                   r[2], r[3]] for r in pd2[0]["rows"]]
    ex["s"] = time.perf_counter() - t0
    res["explain"] = ex
    res["gathered"] = SF.counters()["gathered_rows"] - g0
    res["step_s"] = time.perf_counter() - t_step
    for f in (f4, f3):
        h2o.DKV.remove(str(f.key))
    return res, arrays


def _check_multiclass(mine, theirs, arr1, ref, arr_ref):
    """Phase 3y's multiclass and explanation step on both ranks (`mine`,
    `theirs`; rank 1's arrays `arr1`) against one process's (`ref`,
    `arr_ref`): the forests, fold ids, leaves, staged probabilities and
    contributions bitwise, the GLMs and PDP tables within their bars,
    the AutoML leaderboard one process's, each tree path's launches the
    levels it grew, no row gathered. Prints the step's metrics; returns
    the kernel's launches of the sharded paths (rank 0)."""
    c = SHARD_MULTI
    n = FLAGSHIP["n_rows"]
    check(ref["classes"] == [4, 3], f"the cut responses' classes "
          f"{ref['classes']}")
    for name in ("gbm_multinomial", "automl", "cv_stratified"):
        check(ref[name]["launches"] == ref[name]["levels"] > 0,
              f"one process's {name}: {ref[name]['launches']} launches for "
              f"{ref[name]['levels']} levels grown")
    check(ref["automl"]["members"] == ["def_gbm_1",
                                       "exploit_gbm_lr_annealing"]
          and ref["automl"]["failed"] == ["FAILED StackedEnsemble_AllModels",
                                          "FAILED def_glm (glm)"],
          f"the multiclass AutoML's plan: {ref['automl']}")
    for r, arr in ((mine, mine["multi_arrays"]), (theirs, arr1)):
        rk, got = r["rank"], r["multi"]
        lo, hi = _blk(n, rk)
        for name in ("multinomial", "ordinal"):
            b, want = arr[f"glm_{name}_beta"], arr_ref[f"glm_{name}_beta"]
            p, pwant = (arr[f"glm_{name}_probs"],
                        arr_ref[f"glm_{name}_probs"][lo:hi])
            g, gref = got[f"glm_{name}"], ref[f"glm_{name}"]
            bar = c["c54"] if name == "multinomial" else c["c46"]
            excess = max(float(np.max(np.abs(b - want) - bar["atol"]
                                      - bar["rtol"] * np.abs(want))),
                         float(np.max(np.abs(p - pwant) - bar["atol"]
                                      - bar["rtol"] * np.abs(pwant))))
            dev_rel = abs(g["deviance"] - gref["deviance"]) / abs(
                gref["deviance"])
            print(f"rank {rk}: sharded {name} GLM, coefficients max abs gap "
                  f"{float(np.max(np.abs(b - want)))!r}, probabilities max "
                  f"abs gap {float(np.max(np.abs(p - pwant)))!r}, deviance "
                  f"relative gap {dev_rel!r}; iterations {g['iterations']} "
                  f"(one process {gref['iterations']})")
            check(excess <= 0 and dev_rel <= 1e-6
                  and abs(g["iterations"] - gref["iterations"]) <= 1,
                  f"rank {rk}: the {name} GLM is beyond its bar of one "
                  f"process's ({'C54' if name == 'multinomial' else 'C46'}"
                  f": {bar}, deviance 1e-6)")
        g = got["gbm_multinomial"]
        check(g["forest"] == ref["gbm_multinomial"]["forest"]
              and g["logloss"] == ref["gbm_multinomial"]["logloss"],
              f"rank {rk}: the multinomial GBM differs from one process's")
        a = got["automl"]
        check(a["leaderboard"] == ref["automl"]["leaderboard"]
              and a["failed"] == ref["automl"]["failed"]
              and a["members"] == ref["automl"]["members"],
              f"rank {rk}: multiclass AutoML {a} vs one process's "
              f"{ref['automl']}")
        cv, cref = got["cv_stratified"], ref["cv_stratified"]
        check(cv["gathered"] == 0, f"rank {rk}: stratified CV gathered "
              f"{cv['gathered']} rows")
        check((cv["fold_digest"], cv["forest"], cv["folds"], cv["logloss"])
              == (cref["fold_digest"], cref["forest"], cref["folds"],
                  cref["logloss"]),
              f"rank {rk}: the stratified CV GBM differs from one "
              "process's")
        for name in ("gbm_multinomial", "automl", "cv_stratified"):
            check(got[name]["launches"] == got[name]["levels"]
                  == ref[name]["levels"],
                  f"rank {rk}: {name} {got[name]['launches']} launches for "
                  f"{got[name]['levels']} levels grown")
        ex, eref = got["explain"], ref["explain"]
        for k in ("leaf_Path", "leaf_Node_ID", "staged", "contrib"):
            check(ex[k] == eref[k][rk], f"rank {rk}: {k} differs from one "
                  "process's rows")
        check(ex["path_domains"] == eref["path_domains"],
              f"rank {rk}: the leaf paths' domains differ")
        for t, tr in zip(ex["pdp"], eref["pdp"]):
            check(t[:2] == tr[:2], f"rank {rk}: PDP grid of {t[0]}")
            gap = float(np.max(np.abs(np.array(t[2:]) - np.array(tr[2:]))))
            check(gap <= c["pdp_atol"], f"rank {rk}: PDP {t[0]} {gap!r}")
        gap2 = float(np.max(np.abs(np.array([r[2:] for r in ex["pdp2"]])
                                   - np.array([r[2:] for r in
                                               eref["pdp2"]]))))
        check([r[:2] for r in ex["pdp2"]] == [r[:2] for r in eref["pdp2"]]
              and gap2 <= c["pdp_atol"], f"rank {rk}: 2-D PDP {gap2!r}")
        check(got["gathered"] == 0, f"rank {rk} gathered {got['gathered']}"
              " rows in the multiclass and explanation step")
    print("multinomial GBM, stratified CV GBM, leaves, staged "
          "probabilities and contributions bitwise one process's on both "
          "ranks; the multiclass AutoML's members, failures and "
          "leaderboard one process's; ordinal GLM within C46, multinomial "
          "GLM within C54, PDP within 1e-6; launches = levels grown; 0 "
          "rows gathered")
    got = mine["multi"]
    for name in ("glm_multinomial", "glm_ordinal", "gbm_multinomial",
                 "automl", "cv_stratified"):
        label = {"automl": "automl_multiclass"}.get(name, name)
        metric(f"sharded_{label}_train_s", got[name]["s"],
               f"(one process {ref[name]['s']!r}"
               + (f"; {got[name]['launches']} launches"
                  if "launches" in got[name] else "") + ")")
    ex, eref = got["explain"], ref["explain"]
    metric("sharded_explain_s", ex["s"], f"(one process {eref['s']!r}; "
           + ", ".join(f"{k} {ex[k]!r} ({eref[k]!r})" for k in
                       ("leaf_Path_s", "leaf_Node_ID_s", "staged_s",
                        "contrib_s", "pdp_s")) + ")")
    print(f"3y's multiclass and explanation step: one process "
          f"{ref['step_s']!r} s, rank 0 {got['step_s']!r} s, rank 1 "
          f"{theirs['multi']['step_s']!r} s")
    return {"sharded_multinomial": got["gbm_multinomial"]["launches"],
            "sharded_automl_multiclass": got["automl"]["launches"],
            "sharded_cv_stratified": got["cv_stratified"]["launches"]}


def _same_leaderboard(got, want):
    """The same models in the same order; tree members' metrics bitwise,
    the GLM's and the ensembles' within ROADMAP C46's 1e-6."""
    if [g[0] for g in got] != [w[0] for w in want]:
        return False
    for (algo, auc, _ll), (_a, ref, _rl) in zip(got, want):
        if algo in ("glm", "stackedensemble"):
            if abs(auc - ref) > SHARD["glm_rtol"] * abs(ref):
                return False
        elif auc != ref:
            return False
    return True


def _leaderboard(aml):
    return [[r["algo"], r.get("auc"), r.get("logloss")]
            for r in aml.leaderboard]


def _weights_digest(m):
    return _bytes_digest(np.concatenate([
        t.detach().cpu().numpy().ravel() for W, b in m.params_tree
        for t in (W, b)]))


def _shard_slice(h2o, dev, fr, m, res):
    """Phase 3y's munging and trains, run alike by both ranks: the munging,
    the 5-fold CV GBM, XGBoost at its defaults, DeepLearning for one
    epoch at phase 3m's net, AutoML; digests of this rank's results and
    the timings."""
    from h2o3_tpu_torch.core import sharded_frame
    from h2o3_tpu_torch.models import deeplearning as dl
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    sharded_frame.reset_counters()
    out, res["munge"] = _munge_steps(h2o, fr)
    res["munge_digests"] = {k: _digest(f) for k, f in out.items()}
    res["munge_shards"] = {k: list(f.shard) for k, f in out.items()}
    res["munge_rows"] = {k: f.nrows for k, f in out.items()}
    del out
    (res["prims"], res["prims_stats"], res["prims_arrays"]), \
        res["prims_wall_s"] = _timed(lambda: _prim_steps(h2o, fr, "shard"))
    g0 = sharded_frame.counters()["gathered_rows"]
    (res["reshape"], res["reshape_stats"], res["reshape_arrays"]), \
        res["reshape_wall_s"] = _timed(lambda: _reshape_steps(h2o, fr,
                                                              "shard"))
    # `x` and `distance` gather their second frames (`_check_prims`
    # holds each step's count); the munging and CV gather nothing
    reshape_gathered = sharded_frame.counters()["gathered_rows"] - g0
    kw = dict(ntrees=FLAGSHIP["ntrees"], max_depth=FLAGSHIP["max_depth"])
    hg.launches = 0
    cv, res["sharded_cv_train_s"] = _timed(lambda: h2o.GBM(
        nfolds=FRAMEWORK["nfolds"], seed=1,
        keep_cross_validation_predictions=True, **kw).train(
        y="y", training_frame=fr))
    res["cv_launches"] = hg.launches
    o = cv._output
    res["cv"] = {"forest": _digest(cv), "folds": [
        _digest(f) for f in o.cross_validation_models],
        "auc": o.cross_validation_metrics.auc,
        "logloss": o.cross_validation_metrics.logloss,
        "fold_digest": o.fold_assignment_digest,
        "holdout": _bytes_digest(o.cross_validation_holdout_predictions)}
    res["gathered_in_munge_cv"] = sharded_frame.counters()[
        "gathered_rows"] - reshape_gathered
    hg.launches = 0
    xgb, res["sharded_xgb_train_s"] = _timed(lambda: h2o.XGBoost(
        ntrees=XGB["ntrees"], seed=XGB["seed"]).train(y="y",
                                                      training_frame=fr))
    res["xgb_launches"] = hg.launches
    res["xgb_digest"] = _digest(xgb)
    dl.graph_replays = dl.eager_steps = 0
    c0 = sharded_frame.counters()["dl_batch_rows"]
    st0 = m.stats()
    d, res["sharded_dl_train_s"] = _timed(lambda: h2o.DeepLearning(
        epochs=1, seed=DL["seed"]).train(y="y", training_frame=fr))
    st1 = m.stats()
    res["dl"] = {"weights": _weights_digest(d),
                 "auc": d._output.training_metrics.auc,
                 "steps": -(-fr.nrows // DL["batch"]),
                 "graph_replays": dl.graph_replays,
                 "dl_batch_rows": sharded_frame.counters()["dl_batch_rows"]
                 - c0, "collectives": st1["collectives"]
                 - st0["collectives"]}
    hg.launches = 0
    aml, res["sharded_automl_train_s"] = _timed(lambda: h2o.H2OAutoML(
        project_name="shard_aml", **SHARD_AML).train(y="y",
                                                     training_frame=fr))
    res["automl_launches"] = hg.launches
    res["automl_leaderboard"] = _leaderboard(aml)
    for k in [k for k in h2o.DKV.keys() if str(k).startswith("shard_aml")]:
        h2o.DKV.remove(k)
    for obj in (cv, xgb, d):
        h2o.DKV.remove(str(obj.key))


def _shard_steps(h2o, dev, rank, csv_path, out):
    """Phase 3y's steps, run alike by both ranks (this process is rank 0,
    `shard_child` rank 1); the collectives keep them in step. Returns
    what each rank checks or reports."""
    from h2o3_tpu_torch.core import sharded_frame
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from h2o3_tpu_torch.obs import metrics as obs_metrics
    from h2o3_tpu_torch.parallel import mesh as M

    m = M.current()
    res = {"rank": rank, "backend": m.backend, "device":
           torch.cuda.get_device_name(dev)}
    t0 = time.perf_counter()
    fr = h2o.import_file(csv_path, destination_frame="shard_flagship.hex")
    torch.cuda.synchronize()
    res["import_s"] = time.perf_counter() - t0
    res["shard"] = list(fr.shard)
    res["local_rows"] = fr.local_rows
    res["on_card"] = all(c.data.device.type == "cuda" for c in fr.columns)
    res["frame_bytes"] = sum(_frame_bytes(fr))
    sharded_frame.reset_counters()
    kw = dict(ntrees=FLAGSHIP["ntrees"], max_depth=FLAGSHIP["max_depth"])
    h2o.GBM(ntrees=2, max_depth=FLAGSHIP["max_depth"]).train(
        y="y", training_frame=fr)                    # warm-up
    torch.cuda.synchronize()
    hg.launches = 0
    st0 = m.stats()
    t0 = time.perf_counter()
    gbm = h2o.GBM(**kw).train(y="y", training_frame=fr)
    torch.cuda.synchronize()
    res["sharded_gbm_train_s"] = time.perf_counter() - t0
    st1 = m.stats()
    res["gbm_launches"] = hg.launches
    levels = FLAGSHIP["ntrees"] * FLAGSHIP["max_depth"]
    res["allreduce_ms_per_level"] = (st1["seconds"] - st0["seconds"]) \
        * 1e3 / levels
    res["collectives_per_level"] = (st1["collectives"]
                                    - st0["collectives"]) / levels
    res["staged_bytes"] = st1["staged_bytes"] - st0["staged_bytes"]
    res["gbm_forest"] = _forest_bits(gbm)
    res["gbm_auc"] = float(gbm._output.training_metrics.auc)
    hg.launches = 0
    drf = h2o.DRF(ntrees=SHARD["drf_trees"], max_depth=SHARD["drf_depth"],
                  seed=1).train(y="y", training_frame=fr)
    res["drf_launches"] = hg.launches
    res["drf_forest"] = _forest_bits(drf)
    res["gathered_in_train"] = sharded_frame.counters()["gathered_rows"]
    gfr, _b = glm_bench_frame(h2o, dev, GLM_BENCH["n_rows"], GLM_BENCH["p"],
                              GLM_BENCH["seed"])
    glm, res["sharded_glm_train_s"] = _timed(lambda: h2o.GLM(
        family="binomial", lambda_=0.0).train(y="y", training_frame=gfr))
    res["glm_beta"] = glm.beta.cpu().numpy()
    del gfr
    t0 = time.perf_counter()
    pred = gbm.predict(fr)
    torch.cuda.synchronize()
    res["sharded_predict_s"] = time.perf_counter() - t0
    res["pred"] = pred.col("Y").to_numpy()            # gathered
    res["gathered_after_predict"] = sharded_frame.counters()["gathered_rows"]
    DKV.publish(str(gbm.key))
    if rank == 0:
        DKV.put("shard_cfg", {"alpha": 0.5, "rank": 0})
        DKV.publish("shard_cfg", {"alpha": 0.5, "rank": 0}, replicate=True)
    m.barrier()
    res["fetched"] = DKV.fetch_remote("shard_cfg", timeout_ms=30000)
    res["global_keys"] = [k for k in DKV.global_keys()
                          if k in ("shard_cfg", str(gbm.key))]
    res["trees_built"] = [s["value"] for mm in obs_metrics.REGISTRY.snapshot()
                          if mm["name"] == "h2o3_tree_trees_built_total"
                          for s in mm["samples"]][0]
    obs_metrics.publish_snapshot()
    m.barrier()
    res["merged_trees_built"] = [
        s["value"] for mm in obs_metrics.cluster_aggregate()
        if mm["name"] == "h2o3_tree_trees_built_total"
        for s in mm["samples"]][0]
    _shard_slice(h2o, dev, fr, m, res)
    res["multi"], res["multi_arrays"] = _multiclass_steps(h2o, fr, gbm,
                                                          "shard")
    res["kernel_times"] = _cross_rank_times(dev, m)
    res["xgb_kernel_times"] = _cross_rank_times_xgb(dev, m)
    for k in ("shard_flagship.hex", str(gbm.key), str(drf.key),
              str(glm.key), str(pred.key), "shard_cfg"):
        DKV.remove(k)
    m.barrier()
    return res


def _cross_rank_times(dev, m):
    """The cross-rank histogram at a rank's flagship level shapes (n =
    500k, S = 1..16): its three passes and two all-reduces timed apart
    (CUDA events around each launch, the host clock around each
    all-reduce, which stages through the host on gloo and includes
    waiting for the other rank), and the result held bitwise against the
    cross-rank plain version on the same rows. Both ranks run it in
    step; timing launches are not main-path launches."""
    from h2o3_tpu_torch import kernels
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    lib = kernels.load("hist_gather")
    rows = []
    n_all = FLAGSHIP["n_rows"]
    for i, (n, F, maxB, S) in enumerate(flagship_level_shapes()):
        case = hist_case(200 + i, n_all, F, maxB, S)
        lo, hi = m.rows(n_all)
        *arrays, TB = case
        b, nd, w, y, off = _to(dev, *(a[lo:hi] if j < 4 else a
                                      for j, a in enumerate(arrays)),
                               bin_dtype=np.uint8)
        saved = hg.launches
        got = hg.hist_gather(b, nd, w, y, offsets=off, TB=TB, S=S, mesh=m,
                             n_global=n_all)
        hg.launches = saved
        ref = hg.hist_gather_ref(b, nd, w, y, offsets=off, TB=TB, S=S,
                                 mesh=m, n_global=n_all)
        same = bool(torch.equal(got.view(torch.int32),
                                ref.view(torch.int32)))
        tile_S, n_tiles = hg.plan_tiles(TB, S)
        kwl = dict(TB=TB, S=S, tile_S=tile_S, n_tiles=n_tiles,
                   n_global=n_all)
        best = None
        for _ in range(SHARD["time_reps"]):
            scratch = torch.zeros(2 + S * TB * 3, dtype=torch.int64,
                                  device=dev)
            out = torch.empty(S * TB, 3, dtype=torch.float32, device=dev)
            t = []
            for step in ("scale", "max", "accumulate", "sum", "finalise"):
                torch.cuda.synchronize()
                if step in ("max", "sum"):
                    t0 = time.perf_counter()
                    if step == "max":
                        m.all_reduce(scratch.view(torch.int32)[:3], "max")
                    else:
                        m.all_reduce(scratch[2:], "sum")
                    torch.cuda.synchronize()
                    t.append((time.perf_counter() - t0) * 1e3)
                    continue
                passes = {"scale": hg.PASS_SCALE,
                          "accumulate": hg.PASS_ACCUMULATE,
                          "finalise": hg.PASS_FINALISE}[step]
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                err = hg.launch(lib, b, nd, w, y, off, scratch, out,
                                passes=passes, **kwl)
                e1.record()
                torch.cuda.synchronize()
                check(err == 0, f"cross-rank {step}: CUDA error {err}")
                t.append(e0.elapsed_time(e1))
            best = t if best is None or sum(t) < sum(best) else best
        check(torch.equal(out.view(torch.int32), got.view(torch.int32)),
              f"the timed cross-rank steps at S={S} differ from "
              "hist_gather's")
        rows.append({"n": hi - lo, "S": S, "bitwise": same,
                     "ms": dict(zip(("scale", "all_reduce_max",
                                     "accumulate", "all_reduce_sum",
                                     "finalise"), best))})
    return rows


def _check_slice(mine, theirs, munge_ref, munge_rows, one_stats, aml_ref):
    """Phase 3y's checks of the munging and trains: every rank's munging
    results, CV GBM, XGBoost forest and AutoML leaderboard against the
    one-process ones, DeepLearning's weights the same on both ranks; the
    metrics. Returns the kernel's launches of the sharded trains (rank
    0)."""
    kw_levels = FLAGSHIP["ntrees"] * FLAGSHIP["max_depth"]
    cv_ref, (xgb_dig, xgb_s) = RUN["cv_ref"], RUN["xgb_ref"]
    for r in (mine, theirs):
        rk = r["rank"]
        for k, dig in r["munge_digests"].items():
            check(r["munge_shards"][k] == list(_blk(munge_rows[k], rk)),
                  f"rank {rk}: {k} holds {r['munge_shards'][k]}")
            check(dig == munge_ref[k][rk], f"rank {rk}: the sharded {k} "
                  "differs from the one-process one")
        check(r["gathered_in_munge_cv"] == 0, f"rank {rk} gathered "
              f"{r['gathered_in_munge_cv']} rows munging and in CV")
        cv = r["cv"]
        check(cv["forest"] == cv_ref["forest"]
              and cv["folds"] == cv_ref["folds"],
              f"rank {rk}: the sharded CV forests differ from phase 3n's")
        check((cv["auc"], cv["logloss"], cv["fold_digest"])
              == (cv_ref["auc"], cv_ref["logloss"], cv_ref["fold_digest"]),
              f"rank {rk}: CV metrics {cv['auc']!r}/{cv['logloss']!r} vs "
              f"phase 3n's {cv_ref['auc']!r}/{cv_ref['logloss']!r}")
        check(cv["holdout"] == cv_ref["holdout"][rk],
              f"rank {rk}: its holdout predictions differ from phase 3n's")
        check(r["cv_launches"] == (FRAMEWORK["nfolds"] + 1) * kw_levels,
              f"rank {rk}: {r['cv_launches']} CV launches")
        check(r["xgb_digest"] == xgb_dig, f"rank {rk}: the sharded XGBoost "
              "forest differs from phase 3e's")
        check(r["xgb_launches"] == XGB["ntrees"] * XGB["max_depth"],
              f"rank {rk}: {r['xgb_launches']} XGBoost launches")
        check(r["dl"]["auc"] > 0.5 and r["dl"]["dl_batch_rows"] > 0,
              f"rank {rk}: DeepLearning AUC {r['dl']['auc']!r}")
        check(_same_leaderboard(r["automl_leaderboard"], aml_ref[0]),
              f"rank {rk}: AutoML leaderboard {r['automl_leaderboard']} vs "
              f"one process's {aml_ref[0]}")
        check(r["automl_launches"] == aml_ref[1],
              f"rank {rk}: {r['automl_launches']} AutoML launches, the "
              f"one-process AutoML's {aml_ref[1]}")
        for row in r["xgb_kernel_times"]:
            check(row["bitwise"], f"rank {rk}: the cross-rank kernel at "
                  f"XGBoost's S={row['S']} differs from its plain version")
    check(mine["dl"]["weights"] == theirs["dl"]["weights"],
          "DeepLearning's weights differ between the ranks")
    print("sharded split, sort, merge and group-by bitwise with one "
          "process's on both ranks; CV GBM forests, metrics and holdout "
          "predictions bitwise with phase 3n's; XGBoost's forest bitwise "
          "with phase 3e's; AutoML's leaderboard one process's (its GBM "
          "bitwise, its GLM and ensembles within C46)")
    n = FLAGSHIP["n_rows"]
    for name in ("split", "merge", "groupby"):
        metric(f"sharded_{name}_s", mine["munge"][name]["s"],
               f"(one process {one_stats[name]['s']!r})")
    metric("sharded_sort_rows_per_sec", n / mine["munge"]["sort"]["s"],
           f"(one process {n / one_stats['sort']['s']!r})")
    for name, st in mine["munge"].items():
        print(f"exchanged_bytes {name} {st['exchanged_bytes']} (rank 0), "
              f"{theirs['munge'][name]['exchanged_bytes']} (rank 1)")
    metric("sharded_cv_train_s", mine["sharded_cv_train_s"],
           f"(phase 3n gbm_cv_train_s {RUN['gbm_cv_train_s']!r})")
    metric("sharded_xgb_train_s", mine["sharded_xgb_train_s"],
           f"(phase 3e xgb_train_s {xgb_s!r})")
    d = mine["dl"]
    metric("sharded_dl_train_s", mine["sharded_dl_train_s"],
           f"({d['steps']} steps, {d['graph_replays']} graph replays, "
           f"{d['collectives']} collectives, {d['dl_batch_rows']} batch "
           "rows fetched)")
    metric("sharded_automl_train_s", mine["sharded_automl_train_s"],
           f"(one process {aml_ref[2]!r}; {len(aml_ref[0])} models)")
    RUN["cross_rank_xgb"] = (mine["xgb_kernel_times"],
                             theirs["xgb_kernel_times"])
    return {"sharded_cv": mine["cv_launches"],
            "sharded_xgb": mine["xgb_launches"],
            "sharded_automl": mine["automl_launches"]}


def _c47_window(h2o, dev, tmp, csv_path, sort_ref):
    """ROADMAP C47 on the card: a REST cloud of two processes; the cost of
    the checkpoint a Rapids statement ends in (`op_ckpt_ms` and bytes);
    then the follower killed in the window of a sort statement (after
    its last collective, before its rank section and ack), and its rejoin
    through the joint replay: its rows of the sorted frame bitwise the
    one-process rows."""
    import datetime
    import os

    import torch.distributed as dist

    from h2o3_tpu_torch.api.server import start_server
    from h2o3_tpu_torch.parallel import ckpt, oplog, supervisor, watchdog
    from h2o3_tpu_torch.parallel import distributed as D

    cdir = os.path.join(tmp, "c47")
    os.makedirs(cdir, exist_ok=True)
    folls, srv = [], None
    costs = []
    write, commit = ckpt.write_checkpoint, ckpt.commit

    def timed_write(seq):
        t0 = time.perf_counter()
        path = write(seq)
        costs.append({"seq": seq, "write_ms": (time.perf_counter() - t0)
                      * 1e3, "bytes": os.path.getsize(path)})
        return path

    def timed_commit(rec):
        t0 = time.perf_counter()
        commit(rec)
        for c in costs:
            if c["seq"] == rec["seq"]:
                c["commit_ms"] = (time.perf_counter() - t0) * 1e3
                sec = ckpt._section_path(rec["seq"], 1)
                c["section_bytes"] = (os.path.getsize(sec)
                                      if os.path.exists(sec) else 0)

    env = dict(CLOUD, H2O_TPU_AUTO_RECOVER="0",
               H2O_TPU_OPLOG_CHECKPOINT_OPS="0")
    with _env(H2O_TPU_OPLOG_CKPT_DIR=os.path.join(cdir, "ckpt"), **env):
        store = dist.TCPStore("127.0.0.1", 0, 2, True,
                              timeout=datetime.timedelta(seconds=60),
                              wait_for_workers=False)
        D.initialize(store=store, num_processes=2, process_id=0)
        oplog.reset()
        supervisor.reset()
        watchdog.reset()
        ckpt.write_checkpoint, ckpt.commit = timed_write, timed_commit
        try:
            srv = start_server(port=0)
            R = _Rest(srv.port)
            folls.append(_Follower(store.port, cdir, rejoin=False,
                                   die_at="sort"))
            folls[0].wait("ready.json", what="the follower's boot")
            _until(lambda: supervisor.state() == supervisor.HEALTHY,
                   "the two-process cloud HEALTHY")
            R.import_parse(csv_path, "cloud_c47.hex")
            costs.clear()
            for i in range(3):
                R.json("POST", "/99/Rapids", {
                    "ast": f"(assign cloud_c47_gb{i} (GB cloud_c47.hex [8] "
                           "'mean' 0 'all' 'nrow' 0 'all'))",
                    "session_id": "c47"})
            done = [c for c in costs if "commit_ms" in c]
            check(len(done) == 3, f"{len(done)} of 3 Rapids statements "
                  "ended in a booked checkpoint")
            ms = [c["write_ms"] + c["commit_ms"] for c in done]
            metric("op_ckpt_ms", float(np.median(ms)),
                   f"(median of {ms!r}; snapshot bytes "
                   f"{[c['bytes'] for c in done]}, follower section bytes "
                   f"{[c['section_bytes'] for c in done]})")
            t0 = time.perf_counter()
            R.call("POST", "/99/Rapids", {
                "ast": "(assign cloud_c47_sort (sort cloud_c47.hex [0] "
                       "[1]))", "session_id": "c47"}, status=None)
            folls[0].proc.wait(CLOUD_DEADLINE_S)
            check(folls[0].proc.returncode == -9, "the follower was not "
                  f"killed in the window: {folls[0].tail()}")
            _until(lambda: supervisor.state() != supervisor.HEALTHY,
                   "the supervisor seeing the follower gone")
            folls.append(_Follower(store.port, cdir, rejoin=True))
            st = folls[1].wait("status.json", lambda d: "cloud_c47_sort"
                               in d["digests"], "the rejoined sort")
            check(st["digests"]["cloud_c47_sort"] == sort_ref[1],
                  "the rejoined follower's rows of the sorted frame differ "
                  "from the one-process rows")
            check(_digest(h2o.DKV.get("cloud_c47_sort")) == sort_ref[0],
                  "the coordinator's rows of the sorted frame differ")
            _until(lambda: supervisor.state() == supervisor.HEALTHY,
                   "HEALTHY after the joint replay")
            metric("c47_rejoin_s", time.perf_counter() - t0,
                   "(the statement, the kill, the rejoin's joint replay)")
            oplog.publish("shutdown", {})
            folls[-1].proc.wait(60)
        finally:
            ckpt.write_checkpoint, ckpt.commit = write, commit
            for f in folls:
                f.kill()
            if srv is not None:
                srv.stop()
            D.shutdown()
            oplog.reset()
            supervisor.reset()
            watchdog.reset()
    for k in [k for k in h2o.DKV.keys() if str(k).startswith("cloud_c47")]:
        h2o.DKV.remove(k)
    print("C47: the follower killed after the sort's last collective "
          "rejoined through a joint replay; its rows of the sorted frame "
          "bitwise the one-process rows")


def _cross_rank_times_xgb(dev, m):
    """The cross-rank histogram at XGBoost's level shapes on the flagship
    (n = 500k a rank, 10 features of 257 bins as int16, S = 1..32): each
    call held bitwise against the cross-rank plain version on the same
    rows, and timed whole on the host clock (its all-reduces stage
    through the host), best of `time_reps`. Timing launches are not
    main-path launches."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    rows = []
    n_all = FLAGSHIP["n_rows"]
    for i, (_k, _n, S) in enumerate(xgb_level_shapes()):
        *arrays, TB = hist_case(300 + i, n_all, 10, 257, S)
        lo, hi = m.rows(n_all)
        b, nd, w, y, off = _to(dev, *(a[lo:hi] if j < 4 else a
                                      for j, a in enumerate(arrays)),
                               bin_dtype=np.int16)
        saved = hg.launches
        best = None
        for _ in range(SHARD["time_reps"]):
            got, dt = _timed(lambda: hg.hist_gather(
                b, nd, w, y, offsets=off, TB=TB, S=S, mesh=m,
                n_global=n_all))
            best = dt if best is None else min(best, dt)
        hg.launches = saved
        ref = hg.hist_gather_ref(b, nd, w, y, offsets=off, TB=TB, S=S,
                                 mesh=m, n_global=n_all)
        err = float((got - ref).abs().nan_to_num(0.0).max())
        rows.append({"n": hi - lo, "S": S, "maxB": 257, "bins": "int16",
                     "bitwise": bool(torch.equal(got.view(torch.int32),
                                                 ref.view(torch.int32))),
                     "max_abs_err": err, "ms": best * 1e3})
    return rows


def shard_child(outdir: str, csv_path: str) -> None:
    """Phase 3y's rank 1, on the card as rank 0 is: it joins the cloud
    from ``H2O_TPU_COORDINATOR``, ``H2O_TPU_NUM_PROCESSES`` and
    ``H2O_TPU_PROCESS_ID``, runs `_shard_steps` in step with rank 0 and
    writes its results to ``shard.npz``/``shard.json``."""
    import os

    t0 = time.perf_counter()
    from h2o3_tpu_torch.parallel import distributed as D

    D.initialize()
    import h2o3_tpu_torch as h2o

    dev = h2o.init().device
    if dev.type != "cuda" or D.process_index() != 1:
        raise SystemExit(f"shard child on {dev}, process "
                         f"{D.process_index()} of {D.process_count()}")
    boot_s = time.perf_counter() - t0
    res = _shard_steps(h2o, dev, 1, csv_path, outdir)
    res["boot_s"] = boot_s
    arrays = {"pred": res.pop("pred"), "glm_beta": res.pop("glm_beta")}
    for k, v in res.pop("multi_arrays").items():
        arrays[f"multi_{k}"] = v
    for key in ("prims", "reshape"):
        for k, v in res.pop(f"{key}_arrays").items():
            arrays[f"{key}_{k}"] = v
    for k in ("gbm_forest", "drf_forest"):
        for a, v in res.pop(k).items():
            arrays[f"{k}_{a}"] = v
    np.savez(os.path.join(outdir, "shard.npz"), **arrays)
    _write_json(os.path.join(outdir, "shard.json"), res)


def _same_forest_bits(label, got, want):
    for a in want:
        check(np.array_equal(np.asarray(got[a]), np.asarray(want[a])),
              f"{label}: the forest's {a} differs")


def phase_sharded(h2o, dev, tmp, csv_path):
    """Phase 3y: this process is rank 0 of a two-rank row mesh on the one
    card (gloo: NCCL refuses two ranks on one device), a child process
    rank 1; then a one-rank NCCL mesh trains the flagship. Returns the
    kernel's launches per path of this process."""
    import datetime
    import os

    import torch.distributed as dist

    from h2o3_tpu_torch.core import sharded_frame
    from h2o3_tpu_torch.models.tree import hist_gather as hg
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import mesh as M

    sdir = os.path.join(tmp, "sharded")
    os.makedirs(sdir, exist_ok=True)
    # the one-process DRF the sharded one must equal (built first: once
    # the mesh is current every new column is a shard)
    ref_fr = h2o.import_file(csv_path, destination_frame="shard_ref.hex")
    drf_ref = _forest_bits(h2o.DRF(ntrees=SHARD["drf_trees"],
                                   max_depth=SHARD["drf_depth"],
                                   seed=1).train(y="y",
                                                 training_frame=ref_fr))
    # the one-process munging and AutoML the sharded ones must equal
    out, one_stats = _munge_steps(h2o, ref_fr)
    munge_ref = {k: [_digest(f, _blk(f.nrows, r)) for r in (0, 1)]
                 for k, f in out.items()}
    munge_rows = {k: f.nrows for k, f in out.items()}
    del out
    prims_ref, prims_ref_s = _timed(lambda: _prim_steps(h2o, ref_fr, "ref"))
    reshape_ref, reshape_ref_s = _timed(lambda: _reshape_steps(h2o, ref_fr,
                                                               "ref"))
    hg.launches = 0
    aml, aml_s = _timed(lambda: h2o.H2OAutoML(
        project_name="shard_aml_ref", **SHARD_AML).train(
        y="y", training_frame=ref_fr))
    aml_ref = (_leaderboard(aml), hg.launches, aml_s)
    for k in [k for k in h2o.DKV.keys() if str(k).startswith("shard_aml")]:
        h2o.DKV.remove(k)
    gref = h2o.GBM(ntrees=FLAGSHIP["ntrees"],
                   max_depth=FLAGSHIP["max_depth"]).train(
        y="y", training_frame=ref_fr)
    multi_ref, multi_arr_ref = _multiclass_steps(h2o, ref_fr, gref, "ref")
    h2o.DKV.remove(str(gref.key))
    h2o.DKV.remove("shard_ref.hex")
    del ref_fr, aml, gref
    launches = {}
    with _env(H2O_TPU_MESH_TIMEOUT_S=SHARD["mesh_timeout_s"]):
        store = dist.TCPStore("127.0.0.1", 0, 2, True,
                              timeout=datetime.timedelta(seconds=60),
                              wait_for_workers=False)
        env = dict(os.environ, H2O_TPU_COORDINATOR=f"127.0.0.1:{store.port}",
                   H2O_TPU_NUM_PROCESSES="2", H2O_TPU_PROCESS_ID="1",
                   TORCH_CPP_LOG_LEVEL="ERROR")
        root = str(Path(__file__).resolve().parent)
        log = open(os.path.join(sdir, "child.log"), "w")
        t_spawn = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke."
             f"shard_child({sdir!r}, {csv_path!r})"], cwd=root, env=env,
            stdout=log, stderr=subprocess.STDOUT)
        try:
            D.initialize(store=store, num_processes=2, process_id=0)
            m = M.current()
            check(m is not None and m.size == 2 and m.rank == 0,
                  f"row mesh {m and m.describe()}")
            print(f"row mesh: {m.describe()}")
            mine = _shard_steps(h2o, dev, 0, csv_path, sdir)
            child.wait(120)
            log.close()
            check(child.returncode == 0, "the shard child failed: "
                  + open(os.path.join(sdir, "child.log")).read()[-3000:])
            with open(os.path.join(sdir, "shard.json")) as f:
                theirs = json.load(f)
            arr = dict(np.load(os.path.join(sdir, "shard.npz")))
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(30)
            D.shutdown()
    print(f"child boot {theirs['boot_s']!r} s; spawn to done "
          f"{time.perf_counter() - t_spawn!r} s")
    n = FLAGSHIP["n_rows"]
    for r in (mine, theirs):
        rk = r["rank"]
        check(r["backend"] == "gloo", f"rank {rk} backend {r['backend']}")
        check(r["shard"] == list(M.row_block(n, rk, 2)) and r["on_card"]
              and r["local_rows"] == n // 2,
              f"rank {rk} holds {r['shard']} ({r['local_rows']} rows)")
        ratio = r["frame_bytes"] / RUN["flagship_frame_bytes"]
        print(f"rank {rk}: rows {r['shard']} on the card, {r['frame_bytes']} "
              f"device bytes = {ratio:.3f} of phase 3's frame")
        check(0.45 <= ratio <= 0.55, f"rank {rk} frame bytes ratio {ratio}")
        check(r["gbm_launches"] == FLAGSHIP["ntrees"] * FLAGSHIP["max_depth"],
              f"rank {rk}: {r['gbm_launches']} hist_gather launches")
        check(r["gathered_in_train"] == 0,
              f"rank {rk} gathered {r['gathered_in_train']} rows in the "
              "train")
        check(r["fetched"] == {"alpha": 0.5, "rank": 0}
              and len(r["global_keys"]) == 2,
              f"rank {rk} DKV: {r['fetched']} {r['global_keys']}")
        print(f"rank {rk}: sharded_gbm_train_s {r['sharded_gbm_train_s']!r} "
              f"(phase 3 gbm_train_s {RUN.get('gbm_train_s')!r}); "
              f"all-reduce ms per level {r['allreduce_ms_per_level']!r} "
              f"({r['collectives_per_level']!r} collectives a level, "
              f"{r['staged_bytes']} bytes staged through the host); "
              f"hist_gather launches {r['gbm_launches']} (DRF "
              f"{r['drf_launches']})")
        print(f"rank {rk}: sharded_glm_train_s {r['sharded_glm_train_s']!r}"
              f", sharded_predict_s {r['sharded_predict_s']!r}, import_s "
              f"{r['import_s']!r}")
    metric("sharded_gbm_train_s", mine["sharded_gbm_train_s"],
           f"(rank 0 of 2 on one card; phase 3: gbm_train_s "
           f"{RUN.get('gbm_train_s')!r})")
    metric("allreduce_ms_per_level", mine["allreduce_ms_per_level"],
           "(rank 0, host clock over the train's collectives / levels)")
    _same_forest_bits("the sharded flagship (rank 0)", mine["gbm_forest"],
                      RUN["flagship_forest"])
    _same_forest_bits("the sharded flagship (rank 1)",
                      {a: arr[f"gbm_forest_{a}"] for a in mine["gbm_forest"]},
                      RUN["flagship_forest"])
    print("sharded flagship forest bitwise with phase 3's on both ranks")
    _same_forest_bits("the sharded DRF (rank 0)", mine["drf_forest"],
                      drf_ref)
    _same_forest_bits("the sharded DRF (rank 1)",
                      {a: arr[f"drf_forest_{a}"] for a in drf_ref}, drf_ref)
    print(f"sharded {SHARD['drf_trees']}-tree DRF bitwise with the "
          "one-process DRF on both ranks")
    want = RUN["glm_bench_beta"]
    for rk, beta in ((0, mine["glm_beta"]), (1, arr["glm_beta"])):
        gap = float(np.max(np.abs(beta - want) / np.maximum(np.abs(want),
                                                             1e-12)))
        print(f"rank {rk}: sharded bench GLM coefficients "
              f"{'bitwise' if np.array_equal(beta, want) else 'differ'}"
              f" from phase 3i's; max relative gap {gap!r} (C46)")
        check(gap <= SHARD["glm_rtol"], f"GLM coefficient gap {gap}")
    for rk, pred in ((0, mine["pred"]), (1, arr["pred"])):
        check(np.array_equal(pred.view(np.int32),
                             RUN["flagship_pred"].view(np.int32)),
              f"rank {rk}: the gathered 1M predictions differ from "
              "phase 3's")
    check(mine["gbm_auc"] == theirs["gbm_auc"] == RUN["flagship_auc"],
          f"sharded AUC {mine['gbm_auc']!r} / {theirs['gbm_auc']!r} vs "
          f"phase 3's {RUN['flagship_auc']!r}")
    print(f"gathered 1M predictions bitwise with phase 3's on both ranks; "
          f"AUC {mine['gbm_auc']!r} equals phase 3's")
    check(mine["merged_trees_built"] == mine["trees_built"]
          + theirs["trees_built"], f"/3/Metrics merge: "
          f"{mine['merged_trees_built']} != {mine['trees_built']} + "
          f"{theirs['trees_built']}")
    print(f"/3/Metrics merged h2o3_tree_trees_built_total "
          f"{mine['merged_trees_built']!r} = {mine['trees_built']!r} + "
          f"{theirs['trees_built']!r}")
    for row in mine["kernel_times"]:
        check(row["bitwise"], f"cross-rank kernel at S={row['S']} differs "
                              "from its plain version")
    RUN["cross_rank_times"] = (mine["kernel_times"], theirs["kernel_times"])
    launches["sharded"] = mine["gbm_launches"]
    launches.update(_check_slice(mine, theirs, munge_ref, munge_rows,
                                 one_stats, aml_ref))
    _check_prims(mine, theirs, {k[len("prims_"):]: v for k, v in arr.items()
                                if k.startswith("prims_")}, prims_ref)
    print(f"3y's prim step: one-process references {prims_ref_s!r} s, "
          f"rank 0 {mine['prims_wall_s']!r} s, rank 1 "
          f"{theirs['prims_wall_s']!r} s (wall, digests included)")
    _check_prims(mine, theirs, {k[len("reshape_"):]: v for k, v in
                                arr.items() if k.startswith("reshape_")},
                 reshape_ref, SHARD_RESHAPE, "reshape", "sharded_reshape_s",
                 RESHAPE_GATHERED)
    print(f"3y's part 1b step: one-process references {reshape_ref_s!r} s, "
          f"rank 0 {mine['reshape_wall_s']!r} s, rank 1 "
          f"{theirs['reshape_wall_s']!r} s (wall, digests included)")
    launches.update(_check_multiclass(
        mine, theirs, {k[len("multi_"):]: v for k, v in arr.items()
                       if k.startswith("multi_")}, multi_ref, multi_arr_ref))
    _c47_window(h2o, dev, tmp, csv_path, munge_ref["sort"])
    print(f"follower hist_gather launches (sharded flagship) "
          f"{theirs['gbm_launches']}")

    # one rank over NCCL: its dtypes and its stream order on the card
    m1 = M.RowMesh(0, 1, dev, dist.HashStore())
    check(m1.backend == "nccl", f"one-rank mesh backend {m1.backend}")
    with M.use(m1):
        fr1 = h2o.import_file(csv_path, destination_frame="nccl_flag.hex")
        check(fr1.shard == (0, n), f"one-rank shard {fr1.shard}")
        hg.launches = 0
        sharded_frame.reset_counters()
        g1, dt = _timed(lambda: h2o.GBM(
            ntrees=FLAGSHIP["ntrees"], max_depth=FLAGSHIP["max_depth"]
        ).train(y="y", training_frame=fr1))
        launches["nccl"] = hg.launches
        st = m1.stats()
    _same_forest_bits("the one-rank NCCL flagship", _forest_bits(g1),
                      RUN["flagship_forest"])
    print(f"one-rank NCCL mesh: flagship forest bitwise with phase 3's, "
          f"{launches['nccl']} launches, {dt!r} s, {st['collectives']} "
          f"collectives in {st['seconds']!r} s")
    check(launches["nccl"] == FLAGSHIP["ntrees"] * FLAGSHIP["max_depth"],
          f"{launches['nccl']} launches on the NCCL mesh")
    m1.shutdown()
    for k in ("nccl_flag.hex", str(g1.key)):
        h2o.DKV.remove(k)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    import h2o3_tpu_torch as h2o

    dev = h2o.init().device
    banner("phase 0b: the port's invariant analyzer")
    phase_analysis()
    banner("phase 1: build")
    phase_build()
    banner("phase 2: kernels vs plain versions")
    max_err = max(phase_kernels(dev), phase_kernels_drf(dev),
                  phase_kernels_new(dev))
    launches = {}
    banner("phase 3: flagship GBM train + score")
    launches["gbm_flagship"], fr, flagship_model = phase_flagship(h2o, dev)
    banner("phase 3b: where the time goes (flagship, XGBoost, "
          "IsolationForest trains; IsolationForest predict)")
    phase_profile("5-tree flagship train", lambda: h2o.GBM(
        ntrees=5, max_depth=FLAGSHIP["max_depth"]).train(
            y="y", training_frame=fr))
    phase_leaf_sums(h2o, fr)
    phase_profile("5-tree XGBoost train", lambda: h2o.XGBoost(
        ntrees=5, seed=XGB["seed"]).train(y="y", training_frame=fr))
    banner("phase 3c: deep DRF (200k rows, depth 20)")
    launches["drf_deep"] = phase_drf_deep(h2o, dev)
    banner("phase 3d: multinomial GBM with validation and early stopping")
    launches["gbm_multinomial"] = phase_multinomial(h2o, dev)
    banner("phase 3e: XGBoost gbtree at its defaults (flagship frame)")
    launches["xgboost"] = phase_xgboost(h2o, dev, fr)
    banner("phase 3f: XGBoost dart (flagship frame)")
    launches["xgboost_dart"] = phase_xgboost_dart(h2o, dev, fr)
    banner("phase 3m: DeepLearning at the reference's defaults "
          "(flagship frame, 1 epoch)")
    dl_model = phase_deeplearning(h2o, dev, fr)
    banner("phase 3n: the model framework (flagship frame): CV, "
          "calibration, checkpoints, save/load, leaf assignment, gains/lift")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_models_")
    try:
        launches.update(phase_framework(h2o, dev, fr, dl_model, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    banner("phase 3p: the remaining builders (KMeans, PCA, SVD, "
          "NaiveBayes, Word2Vec, TargetEncoder, GLRM, CoxPH, PSVM, "
          "Aggregator, IsotonicRegression, segments)")
    launches.update(phase_builders(h2o, dev, fr))
    banner("phase 3q: search on the flagship frame (the dryrun's AutoML, "
           "a GBM grid, a GLM grid sequential and parallel, a cancelled "
           "train)")
    launches.update(phase_search(h2o, dev, fr))
    banner("phase 3r: MOJO/POJO export and import, the Generic model and "
           "the explanation suite (flagship GBM, phase 3m's DeepLearning, "
           "a GLM)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mojo_")
    try:
        launches["explain_export"], glm = phase_explain_export(
            h2o, dev, fr, flagship_model, dl_model, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    banner("phase 3s: serving (the flagship GBM's session on CUDA graphs, "
           "micro-batching and admission, the memory ladder, the cleaner "
           "and spill, standalone artifacts)")
    serving_tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    launches["serving"], serving_art = phase_serving(
        h2o, dev, fr, flagship_model, glm, serving_tmp)
    del fr, dl_model, glm
    banner("phase 3g: IsolationForest (1M rows, 1% moved 6 sigma out)")
    launches["isolationforest"], ofr, moved, iso = phase_isofor(h2o, dev)
    phase_profile("50-tree IsolationForest train", lambda: h2o.IsolationForest(
        ntrees=ISOFOR["ntrees"], seed=ISOFOR["seed"]).train(
            training_frame=ofr))
    phase_profile("IsolationForest predict (1M rows)",
                  lambda: iso.predict(ofr))
    del iso
    banner("phase 3m: DeepLearning autoencoder (phase 3g's frame)")
    phase_dl_autoencoder(h2o, dev, ofr, moved)
    banner("phase 3h: Extended Isolation Forest (same frame)")
    phase_eif(h2o, dev, ofr, moved)
    del ofr
    banner("phase 3i: GLM binomial at the reference bench's width "
          "(1M rows, 32 features)")
    gfr = phase_glm_bench(h2o, dev)
    banner("phase 3b: where the time goes (GLM binomial train)")
    phase_profile("GLM binomial train (1M x 32)", lambda: h2o.GLM(
        family="binomial", lambda_=0.0).train(y="y", training_frame=gfr))
    del gfr
    banner("phase 3j: GLM's other solvers (flagship frames)")
    phase_glm_solvers(h2o, dev, flagship_frame(h2o, dev, FLAGSHIP["n_rows"]))
    banner("phase 3k: GAM and RuleFit (200k flagship rows; RuleFit "
          "profiled)")
    launches["rulefit"] = phase_gam_rulefit(h2o, dev)
    banner("phase 3l: ingest (run_parse file, streaming append, the "
          "flagship from CSV)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    try:
        launches["gbm_imported_csv"], parse_path, flag_csv, flag_fr, \
            flag_model = phase_ingest(h2o, dev, tmp, flagship_model)
        del flagship_model
        banner("phase 3o: Rapids and the frame ops (run_rapids' 2M-row "
              "frame, sort, joins, group-by, the verify recipe)")
        launches["rapids"] = phase_rapids(h2o, dev, tmp)
        banner("phase 3t: statement fusion, lazy sessions and the "
               "munge→score pipeline (run_rapids' statements and chained "
               "session, run_pipeline's shape, a pipeline artifact)")
        launches["pipeline"], pipe_model, fused = phase_fusion(h2o, dev, tmp)
        banner("phase 3u: the REST server, the thin client and the "
               "observability plane (the flagship over HTTP, run_rapids' "
               "statements, serving during a REST train)")
        launches["rest"] = phase_rest(h2o, dev, flag_csv, flag_fr,
                                      flag_model, fused)
        del flag_model, fused
        banner("phase 3v: crash-survivable training and search (the "
               "flagship GBM killed and resumed, the deep DRF, the bench "
               "GLM, KMeans, DeepLearning, a grid's recovery_dir, REST) "
               "and the S3 reader")
        launches.update(phase_resume(h2o, dev, tmp, flag_csv, flag_fr))
        del flag_fr
        banner("phase 3w: bf16 numeric storage (the flagship frame, GBM "
               "and scoring session, the bench GLM, an import, a fused "
               "statement, card vs CPU)")
        launches["bf16"] = phase_bf16(h2o, dev, parse_path)
        banner("phase 3x: the cross-process control plane (a follower "
               "process on the same card: the flagship replayed over REST, "
               "the follower killed mid-train, rejoined from a checkpoint "
               "and the job resumed by the watchdog; the recovery drills)")
        launches.update(phase_cloud(h2o, dev, tmp, flag_csv))
        banner("phase 3y: frame rows sharded across two processes (two "
               "ranks on the one card over gloo: the flagship imported and "
               "trained, a DRF, the bench GLM, 1M predictions, the DKV and "
               "/3/Metrics across processes; split, sort, merge, group-by, "
               "5-fold CV, XGBoost, DeepLearning and AutoML across the "
               "ranks; the cross-rank kernel timed; a follower killed after "
               "a sort's last collective rejoins; then a one-rank NCCL "
               "train)")
        launches.update(phase_sharded(h2o, dev, tmp, flag_csv))
        banner("phase 4: card vs CPU")
        phase_card_vs_cpu(h2o, dev, parse_path)
        phase_card_vs_cpu_framework(h2o, dev)
        phase_card_vs_cpu_rapids(h2o, dev)
        phase_card_vs_cpu_builders(h2o, dev)
        phase_card_vs_cpu_search(h2o, dev)
        phase_card_vs_cpu_explain(h2o, dev)
        phase_card_vs_cpu_serving(h2o, dev, serving_art)
        phase_card_vs_cpu_fusion(h2o, dev, pipe_model)
        phase_card_vs_cpu_rest(h2o, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(serving_tmp, ignore_errors=True)
    banner("phase 5: kernel times at each configuration's level shapes")
    kernels = phase_times(dev, launches, max_err)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
