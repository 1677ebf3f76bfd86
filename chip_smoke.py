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
- the GLM family: a binomial GLM at the reference bench's width (1M
  rows, 32 features, IRLS); lambda search (ADMM), p-values, multinomial
  and ordinal (L-BFGS) GLMs and XGBoost gblinear on the flagship's
  frames; GAM (one column per basis type) and RuleFit at its defaults
  (50 DRF trees of depth 3, so the kernel runs, then a lasso lambda
  search) on 200k flagship rows.
It checks the card's models against the same port on the CPU and times
the kernel at the level shapes of each configuration beside its memory
bound and a PyTorch library call, with the kernel's time split by pass.
Any failed check exits non-zero. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
# card vs CPU (phase 4): cuBLAS and the CPU's BLAS sum in different
# orders, so GLM coefficients and predictions agree to rounding of
# well-conditioned float32 solves; GAM's spline designs and RuleFit's
# rule designs are ill-conditioned or rank-deficient (ROADMAP C10), so
# only their fitted values are held, and more loosely
GLM_COEF_TOL = dict(rtol=1e-4, atol=1e-4)
GLM_PRED_ATOL = 1e-4
C10_PRED_ATOL = 5e-3


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


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


def flagship_frame(h2o, device, n_rows, n_num=8, n_cat=2, seed=0):
    rng = np.random.default_rng(seed)
    fr = h2o.Frame()
    logit = np.zeros(n_rows)
    for i in range(n_num):
        x = rng.standard_normal(n_rows)
        logit += x * rng.uniform(-1, 1)
        fr.add(f"n{i}", h2o.Column.from_numpy(x, device=device))
    doms = [np.array(["a", "b", "c", "d"]), np.array(["x", "y", "z"])]
    for i in range(n_cat):
        codes = rng.integers(0, len(doms[i % 2]), n_rows)
        logit += (codes - 1) * 0.3
        fr.add(f"c{i}", h2o.Column.from_numpy(doms[i % 2][codes],
                                              ctype="enum", device=device))
    y = np.where(rng.random(n_rows) < 1 / (1 + np.exp(-logit)), "Y", "N")
    fr.add("y", h2o.Column.from_numpy(y, ctype="enum", device=device))
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
    t0 = time.perf_counter()
    names = kernels.build_all()
    print(f"build_s {time.perf_counter() - t0:.3f} kernels {names}")
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
    return launches, fr


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


def phase_profile(label, train, top=12):
    """Where a train's time goes: device time by kernel from
    torch.profiler over one call of `train`, the device-busy share of
    the same train's unprofiled wall time, and the host time by
    function."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        print("profile: the profiler recorded no device time (not measured)")
    else:
        print(f"profile {label}: unprofiled wall {wall_us / 1e3:.1f} ms, "
              f"device busy {busy_us / 1e3:.1f} ms = "
              f"{100 * busy_us / wall_us:.1f}% of it")
    # the top rows, then the port's own kernels wherever they rank
    for rank, (dev_us, count, key) in enumerate(sorted(rows, reverse=True)):
        if rank < top or "hist_" in key:
            print(f"  {dev_us / 1e3:9.3f} ms {100 * dev_us / busy_us:5.1f}% "
                  f"x{count:<6d} {key[:90]}")
    host_profile(label, train)


def _forest_arrays(m):
    fo = m.forest
    return {k: np.asarray(getattr(fo, k)) for k in
            ("feat", "thresh_bin", "na_left", "left", "right", "cat_split")}


def phase_card_vs_cpu(h2o, dev):
    """The same port on the card and on the CPU grows the same models."""
    cpu = torch.device("cpu")
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
             "launches": int(launches["gbm_flagship"]),
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
    print("== phase 1: build")
    phase_build()
    print("== phase 2: kernels vs plain versions")
    max_err = max(phase_kernels(dev), phase_kernels_drf(dev),
                  phase_kernels_new(dev))
    launches = {}
    print("== phase 3: flagship GBM train + score")
    launches["gbm_flagship"], fr = phase_flagship(h2o, dev)
    print("== phase 3b: where the time goes (flagship, XGBoost, "
          "IsolationForest trains; IsolationForest predict)")
    phase_profile("5-tree flagship train", lambda: h2o.GBM(
        ntrees=5, max_depth=FLAGSHIP["max_depth"]).train(
            y="y", training_frame=fr))
    phase_profile("5-tree XGBoost train", lambda: h2o.XGBoost(
        ntrees=5, seed=XGB["seed"]).train(y="y", training_frame=fr))
    print("== phase 3c: deep DRF (200k rows, depth 20)")
    launches["drf_deep"] = phase_drf_deep(h2o, dev)
    print("== phase 3d: multinomial GBM with validation and early stopping")
    launches["gbm_multinomial"] = phase_multinomial(h2o, dev)
    print("== phase 3e: XGBoost gbtree at its defaults (flagship frame)")
    launches["xgboost"] = phase_xgboost(h2o, dev, fr)
    print("== phase 3f: XGBoost dart (flagship frame)")
    launches["xgboost_dart"] = phase_xgboost_dart(h2o, dev, fr)
    del fr
    print("== phase 3g: IsolationForest (1M rows, 1% moved 6 sigma out)")
    launches["isolationforest"], ofr, moved, iso = phase_isofor(h2o, dev)
    phase_profile("50-tree IsolationForest train", lambda: h2o.IsolationForest(
        ntrees=ISOFOR["ntrees"], seed=ISOFOR["seed"]).train(
            training_frame=ofr))
    phase_profile("IsolationForest predict (1M rows)",
                  lambda: iso.predict(ofr))
    del iso
    print("== phase 3h: Extended Isolation Forest (same frame)")
    phase_eif(h2o, dev, ofr, moved)
    del ofr
    print("== phase 3i: GLM binomial at the reference bench's width "
          "(1M rows, 32 features)")
    gfr = phase_glm_bench(h2o, dev)
    print("== phase 3b: where the time goes (GLM binomial train)")
    phase_profile("GLM binomial train (1M x 32)", lambda: h2o.GLM(
        family="binomial", lambda_=0.0).train(y="y", training_frame=gfr))
    del gfr
    print("== phase 3j: GLM's other solvers (flagship frames)")
    phase_glm_solvers(h2o, dev, flagship_frame(h2o, dev, FLAGSHIP["n_rows"]))
    print("== phase 3k: GAM and RuleFit (200k flagship rows; RuleFit "
          "profiled)")
    launches["rulefit"] = phase_gam_rulefit(h2o, dev)
    print("== phase 4: card vs CPU")
    phase_card_vs_cpu(h2o, dev)
    print("== phase 5: kernel times at each configuration's level shapes")
    kernels = phase_times(dev, launches, max_err)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
