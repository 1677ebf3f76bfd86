"""Build-time variants of the histogram kernel, timed beside the shipped
source on one CUDA card.

    python3 -m h2o3_tpu_torch.kernel_variants

Run from the root of a checkout (it takes its fixtures and timer from
``chip_smoke.py``). Each variant is ``csrc/hist_gather.cu`` with a few
text edits, built by nvcc into its own library in ``_build/variants/``,
all builds started together. At the flagship level shapes it times the
accumulate pass alone (the same C entry point with ``passes=2``, best of
5 with an L2 flush before each launch) and says whether the variant's
whole function is still bitwise equal to the plain version. The edits
name what each design choice of the shipped kernel buys:

* ``cas64``: the shared 64-bit sums added with one 64-bit atomicAdd, which
  sm_90a compiles to a compare-and-swap loop (ATOMS.CAST.SPIN.64);
* ``loads_only``: the shared adds removed (kept alive by a store that
  never runs), the floor of the loads and index arithmetic; not exact;
* ``unroll2``, ``unroll8``: rows in flight per thread;
* ``threads256``: blocks of 256 threads instead of 512.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

from h2o3_tpu_torch import kernels

_SHIPPED_ADD = """  const unsigned lo = (unsigned)(u64)q;
  const unsigned hi = (unsigned)((u64)q >> 32);
  const unsigned old = atomicAdd(p, lo);
  const unsigned carried = hi + ((unsigned)(old + lo) < lo ? 1u : 0u);
  if (carried) atomicAdd(p + 1, carried);"""

# name -> ([(old, new) text edits of csrc/hist_gather.cu], exact)
VARIANTS = {
    "shipped": ([], True),
    "cas64": ([(_SHIPPED_ADD, "  atomicAdd((u64*)p, (u64)q);")], True),
    "loads_only": ([(_SHIPPED_ADD,
                     "  if (q == (long long)0x8000000000000001ull) *p = 0u;")],
                   False),
    "unroll2": ([("kUnroll = 4;", "kUnroll = 2;")], True),
    "unroll8": ([("kUnroll = 4;", "kUnroll = 8;")], True),
    "threads256": ([("kThreads = 512;", "kThreads = 256;"),
                    ("__launch_bounds__(kThreads, 2)",
                     "__launch_bounds__(kThreads, 4)")], True),
}


def build(name="hist_gather"):
    """Build every variant of csrc/<name>.cu; returns {variant: CDLL}."""
    src = (kernels.CSRC / f"{name}.cu").read_text()
    out = kernels.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for var, (edits, _) in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {var}: {old!r} not in {name}.cu")
            text = text.replace(old, new)
        cu = out / f"{name}_{var}.cu"
        cu.write_text(text)
        procs[var] = subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for var, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {var}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}_{var}.so"))
        for fn, (restype, argtypes) in kernels.SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[var] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.nvidia_smi())
    libs = build()
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=dev)
    table = {var: [] for var in libs}
    for i, (n, F, maxB, S) in enumerate(cs.flagship_level_shapes()):
        b, nd, w, y, off = cs._to(
            dev, *cs.hist_case(20 + i, n, F, maxB, S)[:5], bin_dtype=np.uint8)
        TB = F * maxB
        ref = hg.hist_gather_ref(b, nd, w, y, offsets=off, TB=TB, S=S)
        tile_S, n_tiles = hg.plan_tiles(TB, S)
        cells = []
        for var, lib in libs.items():
            scratch = torch.zeros(2 + S * TB * 3, dtype=torch.int64,
                                  device=dev)
            out = torch.empty(S * TB, 3, dtype=torch.float32, device=dev)

            def run(passes, lib=lib, scratch=scratch, out=out):
                err = hg.launch(lib, b, nd, w, y, off, scratch, out, TB=TB,
                                S=S, tile_S=tile_S, n_tiles=n_tiles,
                                passes=passes)
                cs.check(err == 0, f"variant {var}: CUDA error {err}")

            run(hg.ALL_PASSES)
            torch.cuda.synchronize()
            exact = cs.same_bits(out, ref)
            cs.check(exact or not VARIANTS[var][1],
                     f"variant {var} != plain at S={S}")
            ms = cs._time_ms(lambda: run(hg.PASS_ACCUMULATE), flush)
            table[var].append(ms)
            cells.append(f"{var} {ms * 1e3:.1f}")
        print(f"accumulate pass alone, n={n} F={F} maxB={maxB} S={S} (us): "
              + ", ".join(cells))
    means = {var: float(np.mean(v)) * 1e3 for var, v in table.items()}
    print(json.dumps({"accumulate_us_mean": means,
                      "accumulate_us": {var: [t * 1e3 for t in v]
                                        for var, v in table.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
