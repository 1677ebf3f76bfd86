"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc into a shared library with a
plain C interface (no PyTorch headers), loaded with ctypes. Libraries land
in ``h2o3_tpu_torch/_build/`` keyed by a hash of the sources and the nvcc
flags, so a rebuilt source never loads a stale library. Nothing builds at
import: the first launch of a kernel builds it, and :func:`build_all`
builds every kernel at once, one nvcc process per source, all started
together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C signatures per library: function name -> (restype, argtypes)
SIGNATURES = {
    "hist_gather": {
        "hist_gather_launch": (_I, [_P, _I, _P, _P, _P, _P, _L, _I, _I, _I,
                                    _I, _I, _L, _I, _I, _I, _P, _P, _P]),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report per kernel, from the build that made the library
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + \
            [Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return found


def lib_path(name: str) -> Path:
    """Where kernel `name`'s library is (or will be) built."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library is already built;
    returns (final path, temp path, process) or None when nothing to do."""
    out = lib_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, job) -> None:
    out, tmp, proc = job
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(rc={proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: concurrent builds agree


def build_all() -> List[str]:
    """Build every kernel library, one nvcc per source started together;
    returns the kernel names. Already-built libraries are reused."""
    names = sorted(SIGNATURES)
    jobs = {n: _start(n) for n in names}
    errors = []
    for n, job in jobs.items():
        if job is not None:
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for n in names:
        load(n)
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    job = _start(name)
    if job is not None:
        _finish(name, job)
    lib = ctypes.CDLL(str(lib_path(name)))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    _LIBS[name] = lib
    return lib
