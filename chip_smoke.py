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
  run the kernel) per level of the other.
It checks the card's models and imports against the same port on the
CPU and times
the kernel at the level shapes of each configuration beside its memory
bound and a PyTorch library call, with the kernel's time split by pass.
Any failed check exits non-zero. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
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
# phase 3p: k-means and PCA/SVD/GLRM widths; KMeans' estimate_k, GLRM,
# CoxPH, Aggregator and IsotonicRegression on 200k rows; Word2Vec on a
# seeded Zipf
# corpus of 1M tokens over a 10k vocabulary, vec_size 100; PSVM on 20k
# rows (its ICF rank is sqrt(n) + 1); phase 4 on 100k rows (100k tokens)
BUILDERS = dict(k=10, pca_k=5, aux_rows=200_000, w2v_tokens=1_000_000,
                vocab=10_000, vec_size=100, psvm_rows=20_000,
                cvc_rows=100_000, cvc_tokens=100_000)
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
# card vs CPU: libm's float32 functions differ in the last ulps between
# the card and the CPU, the gamma family's reflection subtracts terms of
# order 1, and cumulative sums scan in parallel on the card (ROADMAP C16)
UNARY_CVC = dict(rtol=1e-6, scale=0.1)
GAMMA_CVC = dict(rtol=4e-6, scale=1.0)
CUMSUM_CVC = 1e-5


class SmokeFailure(RuntimeError):
    pass


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
    launches and the run_parse file's path (phase 4 imports it again)."""
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
    print(f"gbm_train_s (imported flagship) {time.perf_counter() - t0!r}")
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
    os.remove(fpath)
    return launches, path


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
    from h2o3_tpu_torch.ops.groupby import GroupBy
    from h2o3_tpu_torch.ops.merge import merge
    from h2o3_tpu_torch.ops.sort import sort_frame, sort_order

    hg.launches = 0
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
    launches = hg.launches
    check(launches == 0, f"the frame ops launched hist_gather {launches} "
                         "times")
    return launches


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


def _forest_arrays(m):
    fo = m.forest
    return {k: np.asarray(getattr(fo, k)) for k in
            ("feat", "thresh_bin", "na_left", "left", "right", "cat_split")}


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
    return [{"name": "hist_gather", "route": "cuda",
             "source": "h2o3_tpu_torch/csrc/hist_gather.cu",
             "replaces": "h2o3_tpu/models/tree/pallas_hist.py:362",
             # the main paths of the flagship: phase 3's numpy-built frame
             # and phase 3l's frame imported from CSV
             "launches": int(launches["gbm_flagship"]
                             + launches["gbm_imported_csv"]),
             "max_abs_err": max_err,
             "ms": mean[0], "plain_ms": mean[1], "bound_ms": mean[3],
             "bound_by": "bytes", "library_ms": mean[2],
             "launches_by_path": launches,
             "drf_shapes": _block([s[3] for s in drf_level_shapes()], drf,
                                  int(launches["drf_deep"])),
             "xgb_shapes": _block([s[2] for s in xgb_level_shapes()], xgb,
                                  int(launches["xgboost"])),
             "isofor_shapes": _block([s[2] for s in isofor_level_shapes()],
                                     iso, int(launches["isolationforest"]))}]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    import h2o3_tpu_torch as h2o

    dev = h2o.init().device
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
    del fr, dl_model
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
        launches["gbm_imported_csv"], parse_path = phase_ingest(
            h2o, dev, tmp, flagship_model)
        del flagship_model
        banner("phase 3o: Rapids and the frame ops (run_rapids' 2M-row "
              "frame, sort, joins, group-by, the verify recipe)")
        launches["rapids"] = phase_rapids(h2o, dev, tmp)
        banner("phase 4: card vs CPU")
        phase_card_vs_cpu(h2o, dev, parse_path)
        phase_card_vs_cpu_framework(h2o, dev)
        phase_card_vs_cpu_rapids(h2o, dev)
        phase_card_vs_cpu_builders(h2o, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
