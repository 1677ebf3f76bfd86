"""Build and load the port's host C++ library: ``csrc/csv_parser.cpp``,
the CSV parser of the ingest path and its time-column parser, and
``csrc/threefry.cpp``, the host walk of DeepLearning's key chain, and
``csrc/sha1.cpp``, SHA-1's blocks with their state handed from rank to
rank (`chained_sha1`), and ``csrc/treeshap.cpp``, the path-dependent
TreeSHAP walk of ``predict_contributions``, compiled together into one
shared library.

Counterpart of h2o3_tpu/native/loader.py (`_build` :27, `get_lib` :64):
the sources compile with the host C++ compiler (``$CXX``, else ``g++``,
the compiler nvcc drives) into ``h2o3_tpu_torch/_build/``, keyed by a
hash of the sources and the flags, on first use; the library is loaded
with ctypes. A failed build raises: no path parses CSV, walks the key
chain or explains a forest another way.

ctypes releases the GIL for the length of each call, so parses of
different byte ranges run in parallel on a thread pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "csv_parser.cpp"
THREEFRY_SOURCE = SOURCE.with_name("threefry.cpp")
TREESHAP_SOURCE = SOURCE.with_name("treeshap.cpp")
SHA1_SOURCE = SOURCE.with_name("sha1.cpp")
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# -ffp-contract=off: the number parser's multiply-adds must round as
# written, never fuse, or a float could differ from the reference's
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
SIGNATURES = {
    "h2o_csv_parse": (_P, [_P, _L, ctypes.c_char, _I, _I, _I, _P, _P, _P,
                           _L, _I, _P, _P, ctypes.c_int32, _P,
                           ctypes.c_int32]),
    "h2o_csv_rows": (_L, [_P]),
    "h2o_csv_error": (ctypes.c_char_p, [_P]),
    "h2o_csv_sizes": (None, [_P, _I, _P, _P]),
    "h2o_csv_copy": (None, [_P, _I, _P, _P, _P]),
    "h2o_csv_free": (None, [_P]),
    "h2o_record_ends": (_L, [_P, _L, _I, _L, _P, _L, _P]),
    "h2o_time_format": (_I, [_P, _L]),
    "h2o_parse_times": (None, [_P, _P, _P, _L, _I, _P]),
    "h2o_split_chain": (None, [ctypes.c_uint32, ctypes.c_uint32, _L,
                               ctypes.c_int32, _P, _P]),
    "h2o_treeshap": (None, [_P, ctypes.c_longlong, _I, _P, _P, _P, _P, _P,
                            _P, _P, _P, _I, _P, _P, _I, _I, _P, _I]),
    "h2o_sha1_blocks": (None, [_P, _P, _L]),
}

_LOCK = threading.Lock()
_LIB = None


def cxx() -> str:
    """The host C++ compiler: $CXX, else g++ on PATH."""
    cand = os.environ.get("CXX") or shutil.which("g++")
    if not cand:
        raise RuntimeError("no host C++ compiler: the port's host library "
                           "builds with g++ (or $CXX)")
    return cand


def sources() -> tuple:
    """The library's C++ sources, in link order."""
    return (SOURCE, THREEFRY_SOURCE, SHA1_SOURCE, TREESHAP_SOURCE)


def lib_path() -> Path:
    h = hashlib.sha256()
    for source in sources():
        h.update(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"host-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; raises on failure."""
    out = lib_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    from h2o3_tpu_torch.obs import compiles, phases

    srcs = sources()
    with phases.first("first_compile", build="g++ host library"), \
            compiles.timed("kernel", out.name, program="g++ host library"):
        proc = subprocess.run([cxx(), *CXX_FLAGS, "-o", str(tmp),
                               *map(str, srcs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            names = " + ".join(s.name for s in srcs)
            raise RuntimeError(f"building {names} failed "
                               f"(rc={proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)       # atomic: concurrent builds agree
    return out


def lib() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for fn, (restype, argtypes) in SIGNATURES.items():
                f = getattr(handle, fn)
                f.restype = restype
                f.argtypes = argtypes
            _LIB = handle
        return _LIB


# ---------------------------------------------------------------------------
# thin wrappers
# ---------------------------------------------------------------------------

KIND_NUM, KIND_CAT, KIND_RAW = 0, 1, 2


class NaSpec:
    """The NA strings and numeric NA values of one parse, packed for C."""

    def __init__(self, strings, floats):
        enc = [s.encode("utf-8") for s in strings]
        self.blob = b"".join(enc) or b"\0"
        self.offs = np.zeros(len(enc) + 1, np.int64)
        np.cumsum([len(e) for e in enc], out=self.offs[1:])
        self.n = len(enc)
        self.floats = np.asarray(sorted(floats), np.float64)


def _ptr(a) -> int:
    return 0 if a is None else int(a.ctypes.data)


class Parsed:
    """Result of one h2o_csv_parse call: rows parsed, the error ("" when
    none), and the variable-size outputs (enum domains, raw tokens)."""

    def __init__(self, handle: int):
        self._h = handle
        L = lib()
        self.rows = int(L.h2o_csv_rows(handle))
        self.error = L.h2o_csv_error(handle).decode("utf-8", "replace")

    def _sizes(self, col: int):
        count, nbytes = ctypes.c_int64(), ctypes.c_int64()
        lib().h2o_csv_sizes(self._h, col, ctypes.byref(count),
                            ctypes.byref(nbytes))
        return count.value, nbytes.value

    def domain(self, col: int):
        """An enum column's local domain, sorted (list of str)."""
        count, nbytes = self._sizes(col)
        raw = np.empty(max(nbytes, 1), np.uint8)
        offs = np.empty(count + 1, np.int64)
        lib().h2o_csv_copy(self._h, col, _ptr(raw), _ptr(offs), None)
        b = raw.tobytes()
        return [b[offs[i]:offs[i + 1]].decode("utf-8")
                for i in range(count)]

    def tokens(self, col: int):
        """A raw column's tokens: (bytes ndarray, int64 offsets, uint8 NA
        flags)."""
        count, nbytes = self._sizes(col)
        raw = np.empty(max(nbytes, 1), np.uint8)
        offs = np.empty(count + 1, np.int64)
        na = np.empty(max(count, 1), np.uint8)
        lib().h2o_csv_copy(self._h, col, _ptr(raw), _ptr(offs), _ptr(na))
        return raw, offs, na[:count]

    def free(self) -> None:
        if self._h:
            lib().h2o_csv_free(self._h)
            self._h = 0

    def __del__(self):
        self.free()


def csv_parse(address: int, length: int, *, sep: str, quote: str,
              skip_header: bool, kinds, na: NaSpec, num_ptrs=None,
              code_ptrs=None, cap: int = 0, count_only: bool = False
              ) -> Parsed:
    """Parse the `length` bytes at `address` (see h2o_csv_parse).
    num_ptrs / code_ptrs: per column, the address of the float32 / int32
    output buffer of `cap` rows (0 for columns of another kind)."""
    ncols = len(kinds)
    kinds_a = np.asarray(kinds, np.int32)
    nums = (ctypes.c_void_p * max(ncols, 1))(*(num_ptrs or [0] * ncols))
    codes = (ctypes.c_void_p * max(ncols, 1))(*(code_ptrs or [0] * ncols))
    q = ord(quote) if quote else -1
    h = lib().h2o_csv_parse(
        address, length, sep.encode("utf-8"), q, int(skip_header), ncols,
        _ptr(kinds_a), ctypes.addressof(nums), ctypes.addressof(codes),
        int(cap), int(count_only), na.blob, _ptr(na.offs), na.n,
        _ptr(na.floats), len(na.floats))
    return Parsed(h)


def record_ends(address: int, length: int, quote: int, parity: int):
    """-> (offsets of the record-ending newlines in the `length` bytes at
    `address`, count of quote bytes there); see h2o_record_ends."""
    cap = max(length // 32, 16)
    nq = ctypes.c_int64()
    while True:
        out = np.empty(cap, np.int64)
        n = int(lib().h2o_record_ends(address, length, quote, parity,
                                      _ptr(out), cap, ctypes.byref(nq)))
        if n <= cap:
            return out[:n], nq.value
        cap = n


def time_format(token: bytes) -> int:
    """Format code of a time token (its column's format), -1 if none."""
    return int(lib().h2o_time_format(token, len(token)))


def parse_times(raw: np.ndarray, offs: np.ndarray, na: np.ndarray,
                fmt: int) -> np.ndarray:
    """float64 epoch milliseconds of tokens under format `fmt`; NaN for
    NA tokens and tokens that do not match it."""
    n = len(offs) - 1
    out = np.empty(n, np.float64)
    if n:
        na = np.ascontiguousarray(na, np.uint8)
        lib().h2o_parse_times(_ptr(raw), _ptr(offs), _ptr(na), n, fmt,
                              _ptr(out))
    return out


def split_chain(key, steps: int, num: int):
    """Walk `steps` links of key <- split(key, num)[0] from the (2,) key
    `key` (see h2o_split_chain). -> ((steps, num - 1, 2) int64 subkeys of
    each step, the (2,) int64 key after the last step), on the CPU."""
    import torch

    k0, k1 = (int(v) for v in key.tolist())
    out = np.empty((max(int(steps), 0), num - 1, 2), np.uint32)
    key_out = np.empty(2, np.uint32)
    lib().h2o_split_chain(k0, k1, int(steps), int(num), _ptr(out),
                          _ptr(key_out))
    return (torch.from_numpy(out.astype(np.int64)),
            torch.from_numpy(key_out.astype(np.int64)))


# treeshap.cpp's unique-path buffer holds 72 entries (PE m[MAXP]); a walk
# extends it once per level, so deeper forests would overflow it
TREESHAP_MAX_DEPTH = 68


def native_treeshap(binned: np.ndarray, forest, nthreads: int = 0
                    ) -> np.ndarray:
    """TreeSHAP of every row of the (n, F) bin matrix through every tree
    of a CompressedForest with covers (see h2o_treeshap): -> (n, F+1)
    float64 contributions, the last (bias) column left 0. A forest
    deeper than TREESHAP_MAX_DEPTH raises ValueError."""
    if forest.max_depth > TREESHAP_MAX_DEPTH:
        raise ValueError(f"TreeSHAP walks forests up to depth "
                         f"{TREESHAP_MAX_DEPTH}, not {forest.max_depth}")
    n, F = binned.shape
    T, M = forest.feat.shape
    if len(forest.na_bins) != F or forest.cover.shape != (T, M):
        raise ValueError(f"TreeSHAP: a bin matrix of {F} features for a "
                         f"forest of {len(forest.na_bins)}, covers "
                         f"{forest.cover.shape} for nodes {(T, M)}")
    b = np.ascontiguousarray(binned, np.int32)
    tables = [np.ascontiguousarray(getattr(forest, name), dt) for name, dt in
              (("feat", np.int32), ("thresh_bin", np.int32),
               ("na_left", np.uint8), ("left", np.int32),
               ("right", np.int32), ("leaf_val", np.float32),
               ("cat_split", np.int32))]
    cat_table = np.ascontiguousarray(forest.cat_table, np.uint8)
    na_bins = np.ascontiguousarray(forest.na_bins, np.int32)
    cover = np.ascontiguousarray(forest.cover, np.float32)
    phi = np.zeros((n, F + 1), np.float64)
    lib().h2o_treeshap(
        _ptr(b), n, F, *map(_ptr, tables), _ptr(cat_table),
        int(cat_table.shape[1]), _ptr(na_bins), _ptr(cover), T, M,
        _ptr(phi), nthreads or min(os.cpu_count() or 4, 16))
    return phi


_SHA1_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)


def _sha1_blocks(state: np.ndarray, data: bytes) -> None:
    """Run the whole 64-byte blocks of `data` through `state` (5 uint32,
    updated in place)."""
    nb = len(data) // 64
    if nb:
        buf = np.frombuffer(data, np.uint8, nb * 64)
        lib().h2o_sha1_blocks(_ptr(state), _ptr(buf), nb)


def chained_sha1(data: bytes, mesh=None) -> str:
    """hashlib.sha1 of the bytes every rank of `mesh` holds, in rank
    order, without moving them: each rank in turn runs its bytes through
    the state and tail the rank before it handed on (one all-gather of
    a few words a rank), and every rank pads and finishes the last
    state. Without a mesh, the digest of `data`."""
    state = np.array(_SHA1_INIT, np.uint32)
    tail, total = b"", 0
    ranks = 1 if mesh is None else mesh.size
    for s in range(ranks):
        if mesh is None or mesh.rank == s:
            buf = tail + bytes(data)
            cut = len(buf) // 64 * 64
            _sha1_blocks(state, buf[:cut])
            tail, total = buf[cut:], total + len(data)
        if mesh is not None:
            from h2o3_tpu_torch.core.sharded_frame import all_gather_object

            got = all_gather_object(
                mesh, (state.tolist(), tail, total) if mesh.rank == s
                else None)[s]
            state = np.array(got[0], np.uint32)
            tail, total = got[1], got[2]
    pad = tail + b"\x80" + b"\x00" * ((55 - len(tail)) % 64) \
        + (8 * total).to_bytes(8, "big")
    _sha1_blocks(state, pad)
    return "".join(f"{int(v):08x}" for v in state)
