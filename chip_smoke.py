"""Smoke test of the PyTorch/CUDA port (h2o3_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the port's CUDA kernels from h2o3_tpu_torch/csrc, holds every
kernel against its plain PyTorch version bit for bit (at the flagship's
level shapes and at depth-20 DRF's, up to a 4096-slot frontier), and
drives three paths through the port's public entry points: the flagship
GBM (1M rows, 8 numeric + 2 categorical features, bernoulli, 20 trees,
depth 5), the reference's deep DRF stage (200k rows, 6 numeric features,
binomial, 5 trees, depth 20) and a multinomial GBM (the flagship's
features, a 4-class response, sampling, a validation frame and early
stopping). It checks the card's forests against the same port on the
CPU and times each kernel at the level shapes of both configurations
beside its memory bound and a PyTorch library call, with the kernel's
time split by pass. Any failed check exits non-zero. The last line is
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
PRED_ATOL = 1e-5            # card vs CPU predictions of the same forest


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
    again = h2o.GBM(ntrees=FLAGSHIP["ntrees"],
                    max_depth=FLAGSHIP["max_depth"]).train(y="y",
                                                           training_frame=fr)
    a, b = _forest_arrays(m), _forest_arrays(again)
    for k in a:
        check(np.array_equal(a[k], b[k]), f"retrain changed forest {k}")
    check(np.array_equal(m.forest.leaf_val, again.forest.leaf_val),
          "retrain changed a leaf value")
    print("retrain on the card: forest bitwise identical")
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
    again = h2o.DRF(ntrees=c["ntrees"], **kw).train(y="y", training_frame=fr)
    a, b = _forest_arrays(m), _forest_arrays(again)
    for k in a:
        check(np.array_equal(a[k], b[k]), f"DRF retrain changed forest {k}")
    check(np.array_equal(m.forest.leaf_val, again.forest.leaf_val),
          "DRF retrain changed a leaf value")
    print("DRF retrain on the card: forest bitwise identical")
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
    """The same port on the card and on the CPU grows the same forests."""
    cpu = torch.device("cpu")
    cases = [
        ("600-row fixture", lambda d: small_frame(h2o, d), h2o.GBM,
         dict(ntrees=4, max_depth=3, seed=3), "Y"),
        ("50k flagship rows", lambda d: flagship_frame(h2o, d, 50_000),
         h2o.GBM, dict(ntrees=5, max_depth=FLAGSHIP["max_depth"], seed=1),
         "Y"),
        ("DRF 20k deep-stage rows", lambda d: drf_deep_frame(h2o, d, 20_000),
         h2o.DRF, dict(ntrees=3, max_depth=12, seed=1), "Y"),
        ("multinomial GBM 5k rows",
         lambda d: multinomial_frames(h2o, d, 5_000, 0)[0], h2o.GBM,
         dict(ntrees=5, max_depth=5, sample_rate=0.8, col_sample_rate=0.8,
              seed=1), "k0")]
    for label, make, builder, kw, col in cases:
        models, preds = [], []
        for d in (dev, cpu):
            fr = make(d)
            m = builder(**kw).train(y="y", training_frame=fr)
            models.append(m)
            preds.append(m.predict(fr).col(col).data.cpu().numpy())
        a, b = (_forest_arrays(m) for m in models)
        for k in a:
            check(np.array_equal(a[k], b[k]), f"{label}: forest {k} differs "
                                              "between card and CPU")
        diff = float(np.abs(preds[0] - preds[1]).max())
        check(diff <= PRED_ATOL, f"{label}: card vs CPU predictions differ "
                                 f"by {diff}")
        print(f"card vs cpu {label}: {models[0].forest.n_trees} trees, "
              f"forests equal, max pred diff {diff:.3e}")


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


def _time_shape(dev, lib, flush, rate, seed, n, F, maxB, S):
    """Kernel, plain version and library call at one level shape, the
    bound, and the kernel's passes each alone through the same C entry
    point. Timing launches are not main-path launches."""
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    b, nd, w, y, off = _to(dev, *hist_case(seed, n, F, maxB, S)[:5],
                           bin_dtype=np.uint8)
    TB = F * maxB
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
    nbytes = 4 * n + n_live * (F * 1 + 8) + 4 * F + 12 * S * TB
    ops = 3 * n_live * F
    bound_ms = max(nbytes / rate, ops / F32_PEAK) * 1e3
    print(f"time hist_gather n={n} F={F} maxB={maxB} S={S}: kernel "
          f"{k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, library "
          f"index_put_ {l_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} "
          f"us ({nbytes / 1e6:.1f} MB at {rate / 1e12:.2f} TB/s)")
    print(f"  passes alone: scale {split[0] * 1e3:.1f} us, accumulate "
          f"{split[1] * 1e3:.1f} us, finalise {split[2] * 1e3:.1f} us "
          f"(tile_S={tile_S}, {n_tiles} tiles)")
    return (k_ms, p_ms, l_ms, bound_ms), split


def _means(dev, lib, flush, rate, seed0, shapes, label):
    rows, splits = [], []
    for i, shape in enumerate(shapes):
        r, sp = _time_shape(dev, lib, flush, rate, seed0 + i, *shape)
        rows.append(r)
        splits.append(sp)
    mean = [float(np.mean([r[j] for r in rows])) for j in range(4)]
    pmean = [float(np.mean([s[j] for s in splits])) for j in range(3)]
    print(f"hist_gather mean per launch at the {label} shapes: kernel "
          f"{mean[0] * 1e3:.1f} us = {100 * mean[3] / mean[0]:.1f}% of the "
          f"bound; passes alone: scale {pmean[0] * 1e3:.1f} us, accumulate "
          f"{pmean[1] * 1e3:.1f} us, finalise {pmean[2] * 1e3:.1f} us")
    return mean


def phase_times(dev, launches, max_err):
    """Kernel, plain version and library call at the flagship's and the
    deep DRF's level shapes, beside the bound, with the kernel's time
    split by pass. `launches` holds each main path's count."""
    from h2o3_tpu_torch import kernels

    name = torch.cuda.get_device_name(dev)
    rate = memory_rate(name)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=dev)
    lib = kernels.load("hist_gather")
    flag = _means(dev, lib, flush, rate, 20, flagship_level_shapes(),
                  "flagship")
    drf = _means(dev, lib, flush, rate, 60, drf_level_shapes(),
                 "deep DRF")
    return [{"name": "hist_gather", "route": "cuda",
             "source": "h2o3_tpu_torch/csrc/hist_gather.cu",
             "replaces": "h2o3_tpu/models/tree/pallas_hist.py:362",
             "launches": int(launches["gbm_flagship"]),
             "max_abs_err": max_err,
             "ms": flag[0], "plain_ms": flag[1], "bound_ms": flag[3],
             "bound_by": "bytes", "library_ms": flag[2],
             "launches_by_path": launches,
             "drf_shapes": {"S": [s[3] for s in drf_level_shapes()],
                            "ms": drf[0], "plain_ms": drf[1],
                            "bound_ms": drf[3], "library_ms": drf[2],
                            "launches": int(launches["drf_deep"])}}]


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
    max_err = max(phase_kernels(dev), phase_kernels_drf(dev))
    launches = {}
    print("== phase 3: flagship GBM train + score")
    launches["gbm_flagship"], fr = phase_flagship(h2o, dev)
    print("== phase 3b: where the flagship train's time goes")
    phase_profile("5-tree flagship train", lambda: h2o.GBM(
        ntrees=5, max_depth=FLAGSHIP["max_depth"]).train(
            y="y", training_frame=fr))
    del fr
    print("== phase 3c: deep DRF (200k rows, depth 20)")
    launches["drf_deep"] = phase_drf_deep(h2o, dev)
    print("== phase 3d: multinomial GBM with validation and early stopping")
    launches["gbm_multinomial"] = phase_multinomial(h2o, dev)
    print("== phase 4: card vs CPU")
    phase_card_vs_cpu(h2o, dev)
    print("== phase 5: kernel times at the flagship and deep-DRF level "
          "shapes")
    kernels = phase_times(dev, launches, max_err)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
