"""Columnar store: Frame / Column on torch tensors (counterpart of
h2o3_tpu/core/frame.py).

Storage rules are the reference's: one dense tensor per column, numeric
columns float32 with NaN as NA (T_NUM columns bfloat16 when the
runtime's `numeric_dtype` opts in: `numeric_store_dtype`), categorical
columns integer codes of the narrowest dtype that fits the domain
(`code_dtype`) with -1 as NA, and domains kept on the host. Time
columns are float32 epoch milliseconds
(NaN = NA); a column built from datetime64 or integer input also keeps
the exact values on the host (`host_data`, datetime64[ms] or the
integers), since float32 holds epoch milliseconds only to ~2e5 ms.
String and uuid columns live on the host only. The reference pads rows
to a multiple of its mesh; the port pads nothing, so a column holds
exactly `nrows` values, or on a row-sharded cloud (parallel/mesh.py)
its rank's block of them: `nrows` is then the frame's global row count,
`shard` the rank's rows ``(lo, hi)`` and `local_rows` their number
(the reference's addressable shards). `to_numpy` of a sharded column
gathers every rank's block and counts the rows
(core/sharded_frame.note_gathered).

A Frame lives under a DKV key (`install`/`delete`); columns are
immutable, so column replacement and Rapids assignment are
copy-on-write. Every Column carries a process-unique `token`, the
identity Rapids sessions count references by.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from h2o3_tpu_torch.core import cleaner
from h2o3_tpu_torch.core.dkv import Key, Keyed

T_NUM = "real"
T_INT = "int"
T_CAT = "enum"
T_TIME = "time"
T_STR = "string"
T_UUID = "uuid"

NA_CAT = -1

# Column identity tokens; next() on a count is atomic under the GIL
_COLUMN_TOKENS = itertools.count(1)


def code_dtype(n_levels: int):
    """Narrowest signed code dtype that fits the domain plus the -1 NA
    sentinel (h2o3_tpu/core/frame.py:48)."""
    if n_levels <= 126:
        return np.int8
    if n_levels <= 32766:
        return np.int16
    return np.int32


def torch_code_dtype(n_levels: int) -> torch.dtype:
    """code_dtype as a torch dtype."""
    return torch.from_numpy(np.zeros(0, code_dtype(n_levels))).dtype


def numeric_host(arr, ctype: str) -> np.ndarray:
    """The float32 host values of a numeric or time column: the
    counterpart of the reference's pad_numeric_host
    (h2o3_tpu/core/frame.py:72) on one device, where nothing is padded.
    Values round through float64 to nearest float32; datetime64 input
    becomes epoch milliseconds, NaT becomes NaN. A bfloat16 column is
    stored from these float32 values (`store_numeric`): the reference's
    float64 -> bfloat16 cast rounds through float32 too, so the bits
    agree (NaN payloads aside)."""
    a = np.asarray(arr)
    if a.dtype.kind == "M":
        ms = a.astype("datetime64[ms]")
        out = ms.astype(np.int64).astype(np.float64)
        out[np.isnat(ms)] = np.nan
        return out.astype(np.float32)
    return a.astype(np.float64).astype(np.float32)


def numeric_store_dtype(ctype: str) -> torch.dtype:
    """The one numeric storage rule (the reference's numeric_store_dtype,
    h2o3_tpu/core/frame.py:65): T_NUM follows the runtime's
    `numeric_dtype` opt-in; T_TIME and T_INT stay float32."""
    return _numeric_dtype() if ctype == T_NUM else torch.float32


def _numeric_dtype() -> torch.dtype:
    """The T_NUM storage dtype of the booted runtime's options (of the
    environment's, before a boot)."""
    from h2o3_tpu_torch.core import runtime

    cl = runtime._CLUSTER
    args = cl.args if cl is not None else runtime.OptArgs.from_env()
    return runtime.numeric_torch_dtype(args.numeric_dtype)


def store_numeric(buf, ctype: str, device=None) -> torch.Tensor:
    """float32 values (a host array or a tensor) -> the column tensor of
    `ctype` on `device` (default: a tensor's own device, else the
    runtime's): copied there, then cast on the device to
    `numeric_store_dtype(ctype)`."""
    if isinstance(buf, torch.Tensor):
        t = buf if device is None else buf.to(torch.device(device))
    else:
        t = torch.from_numpy(np.ascontiguousarray(buf)).to(_device(device))
    dt = numeric_store_dtype(ctype)
    return t if t.dtype == dt else t.to(dt)


def widen(d: torch.Tensor) -> torch.Tensor:
    """A bfloat16 tensor widened exactly to float32; any other tensor as
    it is."""
    return d.float() if d.dtype == torch.bfloat16 else d


def _device(device):
    if device is not None:
        return torch.device(device)
    from h2o3_tpu_torch.core.runtime import cluster

    return cluster().device


class Column:
    """One column: `data` is an (nrows,) tensor (float32 for real/int,
    bfloat16 for real under the bf16 opt-in, a narrow integer code dtype
    for enum) or None for host-only strings,
    whose values live in `host_data`."""

    __slots__ = ("_data", "_evicted", "_loader", "_touch", "ctype", "domain",
                 "host_data", "nrows", "_rollups", "_token", "_shard")

    def __init__(self, data, ctype: str, nrows: int,
                 domain: Optional[List[str]] = None,
                 host_data: Optional[np.ndarray] = None):
        self._data = data
        self._evicted = None       # host copy (or loader) while evicted
        self._loader = None        # file-backed source
        self._touch = 0            # LRU clock (core/cleaner.py)
        self.ctype = ctype
        self.domain = domain
        self.host_data = host_data
        self.nrows = int(nrows)
        self._rollups = None
        self._token = next(_COLUMN_TOKENS)
        self._shard = _shard_of(data if data is not None else host_data,
                                self.nrows)

    @property
    def shard(self) -> Optional[Tuple[int, int]]:
        """This rank's rows (lo, hi) on a row-sharded cloud, else None."""
        return getattr(self, "_shard", None)

    @property
    def local_rows(self) -> int:
        """Rows this process holds: the shard's, else `nrows`."""
        sh = self.shard
        return self.nrows if sh is None else sh[1] - sh[0]

    @property
    def token(self) -> int:
        """Process-unique identity of this column; unlike id() it is never
        reused, so it can key maps that outlive the column."""
        return self._token

    @property
    def data(self):
        """The column's tensor. A file-backed column loads it on first
        use (`file_backed`), and an evicted one faults back in (`evict`).
        The load runs outside the swap lock; the install happens under
        it only if the column still holds the same source (a racing
        evict/fault-in cycle retries). Every access stamps the cleaner's
        LRU clock."""
        d = self._data
        while d is None:
            src = self._evicted
            if src is None:
                d = self._data      # host-only column, or raced in
                break
            buf = src() if callable(src) else src
            with cleaner.SWAP_LOCK:
                if self._data is None and self._evicted is src:
                    self._data = buf.to(_device(None))
                    self._evicted = None
                d = self._data
        self._touch = cleaner.tick()
        return d

    @data.setter
    def data(self, v):
        # a rebound tensor is authoritative: eviction then copies it to
        # the host instead of reverting to a stale file source
        with cleaner.SWAP_LOCK:
            self._data = v
            self._evicted = None
            self._loader = None

    def evict(self) -> int:
        """Move the tensor off the device (water/Cleaner.java's swap):
        to a host copy, or back to its file source for a file-backed
        column; returns the tensor's bytes (0 for a host-only or already
        evicted column). A runtime on the CPU evicts the same way, its
        "host copy" being the tensor itself."""
        with cleaner.SWAP_LOCK:
            d = self._data
            if d is None:
                return 0
            freed = d.numel() * d.element_size()
            self._evicted = (self._loader if self._loader is not None
                             else d.to("cpu"))
            self._data = None
            return freed

    @property
    def is_evicted(self) -> bool:
        return self._data is None and self._evicted is not None

    @property
    def device_nbytes(self) -> int:
        """Bytes of the column's resident tensor (0 when evicted or
        host-only)."""
        d = self._data
        if d is None:
            return 0
        return d.numel() * d.element_size()

    @staticmethod
    def file_backed(loader, ctype: str, nrows: int,
                    domain: Optional[List[str]] = None) -> "Column":
        """A column whose tensor `loader()` returns on first access (the
        reference's Column.file_backed, water/fvec/FileVec.java);
        evicting it reverts to the loader."""
        c = Column(None, ctype, nrows, domain=domain)
        c._evicted = loader
        c._loader = loader
        return c

    @staticmethod
    def from_numpy(arr, ctype: Optional[str] = None,
                   domain: Optional[List[str]] = None,
                   device=None) -> "Column":
        """Host array -> column on `device` (default: the runtime's)."""
        arr = np.asarray(arr)
        n = len(arr)
        # on a row-sharded cloud the column keeps its rank's rows; enum
        # domains come from every row, so every rank's codes agree
        lo, hi = _rank_rows(n)
        if ctype is None:
            if arr.dtype.kind in "OUS":
                return Column(None, T_STR, n,
                              host_data=arr[lo:hi].astype(object))
            if arr.dtype.kind == "M":
                ctype = T_TIME
            elif arr.dtype.kind in "fiub":
                ctype = T_INT if arr.dtype.kind in "iub" else T_NUM
            else:
                raise TypeError(f"unsupported dtype {arr.dtype}")
        if ctype in (T_STR, T_UUID):
            return Column(None, ctype, n, host_data=arr[lo:hi].astype(object))
        host = None
        if ctype == T_CAT:
            if arr.dtype.kind in "OUS":
                domain, codes = _intern_domain(arr)
            elif arr.dtype.kind == "f":
                a = arr.astype(np.float64)
                codes = np.where(np.isnan(a), NA_CAT, a).astype(np.int32)
            else:
                codes = arr.astype(np.int32)
            card = (len(domain) if domain is not None
                    else int(max(codes.max(initial=0) + 1, 1)))
            buf = codes[lo:hi].astype(code_dtype(card))
        elif ctype in (T_NUM, T_INT, T_TIME):
            arr = arr[lo:hi]
            if ctype == T_TIME and arr.dtype.kind in "Mi":
                host = (arr.astype("datetime64[ms]") if arr.dtype.kind == "M"
                        else arr)          # exact epoch-millis on the host
            return Column(store_numeric(numeric_host(arr, ctype), ctype,
                                        device),
                          ctype, n, domain=domain, host_data=host)
        else:
            raise TypeError(f"cannot store ctype {ctype} on a device")
        data = torch.from_numpy(np.ascontiguousarray(buf)).to(_device(device))
        return Column(data, ctype, n, domain=domain, host_data=host)

    @staticmethod
    def _from_strings(arr) -> "Column":
        a = np.asarray(arr, dtype=object)
        return Column(None, T_STR, len(a), host_data=a)

    @staticmethod
    def from_device(data, ctype: str, nrows: int,
                    domain: Optional[List[str]] = None) -> "Column":
        return Column(data, ctype, nrows, domain=domain)

    def with_data(self, data, ctype: Optional[str] = None,
                  domain: Optional[List[str]] = None) -> "Column":
        return Column(data, ctype or self.ctype, self.nrows,
                      domain=domain if domain is not None else self.domain)

    def valid_mask(self) -> torch.Tensor:
        """Bool tensor of the non-NA rows."""
        if self.ctype == T_CAT:
            return self.data >= 0
        return ~torch.isnan(self.data)

    @property
    def device(self) -> torch.device:
        """The device of the column's tensor; host-only columns report
        the runtime's."""
        d = self.data
        return d.device if d is not None else _device(None)

    def min(self):
        return self.rollups.min

    def max(self):
        return self.rollups.max

    def mean(self):
        return self.rollups.mean

    def sigma(self):
        return self.rollups.sigma

    def na_count(self):
        return self.rollups.na_count

    @property
    def is_numeric(self) -> bool:
        return self.ctype in (T_NUM, T_INT)

    @property
    def is_categorical(self) -> bool:
        return self.ctype == T_CAT

    @property
    def is_string(self) -> bool:
        return self.ctype == T_STR

    @property
    def cardinality(self) -> int:
        return len(self.domain) if self.domain else 0

    @property
    def rollups(self):
        """min/max/mean/sigma/na/nz of the column, computed on first use
        (ops/rollups.py; columns are not written in place, so the cache
        stays valid)."""
        if self._rollups is None:
            from h2o3_tpu_torch.ops.rollups import compute_rollups

            self._rollups = compute_rollups(self)
        return self._rollups

    def to_numpy(self) -> np.ndarray:
        """The column's values on the host. numpy has no bfloat16, so a
        bfloat16 column comes back widened exactly to float32 (the
        reference returns an ml_dtypes bfloat16 array of the same
        values; ROADMAP C38)."""
        if self.shard is not None:
            from h2o3_tpu_torch.core import sharded_frame

            return sharded_frame.gather_column(self)
        if self.data is None:
            return self.host_data[: self.nrows]
        return widen(self.data).cpu().numpy()

    def values(self) -> np.ndarray:
        """User-facing values (enum codes -> labels, NA -> None)."""
        arr = self.to_numpy()
        if self.ctype == T_CAT and self.domain is not None:
            dom = np.asarray(self.domain, dtype=object)
            out = np.empty(len(arr), dtype=object)
            valid = arr >= 0
            out[valid] = dom[arr[valid]]
            out[~valid] = None
            return out
        return arr


def _rank_rows(n: int) -> Tuple[int, int]:
    """The rows [lo, hi) this process keeps of an n-row column: its
    rank's block on a row-sharded cloud, else all of them."""
    from h2o3_tpu_torch.parallel import mesh

    m = mesh.current()
    return (0, n) if m is None else m.rows(n)


def _shard_of(buf, nrows: int) -> Optional[Tuple[int, int]]:
    """A column's shard: with a current row mesh, a buffer holding this
    rank's block of `nrows` rows is that block; one holding all `nrows`
    rows of a frame that other ranks share too is replicated (None)."""
    from h2o3_tpu_torch.parallel import mesh

    m = mesh.current()
    if m is None or buf is None:
        return None
    lo, hi = m.rows(nrows)
    n = len(buf)
    if n == hi - lo:
        return (lo, hi)
    if n == nrows:
        return None
    raise ValueError(f"a column of {nrows} rows holds {n} on rank "
                     f"{m.rank} of {m.size}, whose block is [{lo}, {hi})")


def _intern_domain(a: np.ndarray) -> Tuple[List[str], np.ndarray]:
    """String labels -> (sorted domain, int32 codes); None/NaN/"" -> NA."""
    a = np.asarray(a, object)
    if set(map(type, a)) <= {str, type(None)}:
        none = np.asarray(a == None, bool)          # noqa: E711
        s = a.copy()
        s[none] = ""
        u = s.astype(str)
        # numpy's fixed-width strings sort by code point as str does; a
        # trailing NUL, which they drop, takes the loop below
        if np.array_equal(np.char.str_len(u),
                          np.fromiter(map(len, s), np.int64, len(s))):
            ok = u != ""
            dom, inv = np.unique(u[ok], return_inverse=True)
            codes = np.full(len(a), NA_CAT, np.int32)
            codes[ok] = inv.reshape(-1)
            return dom.tolist(), codes
    mask_na = np.array([x is None or (isinstance(x, float) and math.isnan(x))
                        or x == "" for x in a], bool)
    vals = np.asarray([("" if m else str(x)) for x, m in zip(a, mask_na)])
    dom = sorted(set(vals[~mask_na].tolist()))
    lookup = {v: i for i, v in enumerate(dom)}
    codes = np.array([NA_CAT if m else lookup[v]
                      for v, m in zip(vals, mask_na)], np.int32)
    return dom, codes


class Frame(Keyed):
    """Named, ordered collection of equal-length Columns under a DKV key
    (import_file's destination_frame, or a generated one); a frame parsed
    from CSV keeps its parse options in `_parse_opts` for streaming
    appends."""

    def __init__(self, columns: Optional[Dict[str, Column]] = None,
                 key: Optional[str] = None):
        super().__init__(key or Key.make("Frame"))
        self._parse_opts = None
        self._names: List[str] = []
        self._cols: Dict[str, Column] = {}
        for name, col in (columns or {}).items():
            self.add(name, col)

    @property
    def names(self) -> List[str]:
        return list(self._names)

    @property
    def columns(self) -> List[Column]:
        return [self._cols[n] for n in self._names]

    @property
    def ncols(self) -> int:
        return len(self._names)

    @property
    def nrows(self) -> int:
        return self._cols[self._names[0]].nrows if self._names else 0

    nrow = nrows  # h2o-py aliases
    ncol = ncols

    @property
    def shard(self) -> Optional[Tuple[int, int]]:
        """This rank's rows (lo, hi) on a row-sharded cloud, else None."""
        return self._cols[self._names[0]].shard if self._names else None

    @property
    def local_rows(self) -> int:
        """Rows this process holds (the shard's, else `nrows`)."""
        return (self._cols[self._names[0]].local_rows if self._names
                else 0)

    @property
    def types(self) -> Dict[str, str]:
        return {n: self._cols[n].ctype for n in self._names}

    def col(self, name_or_idx: Union[str, int]) -> Column:
        if isinstance(name_or_idx, int):
            return self._cols[self._names[name_or_idx]]
        return self._cols[name_or_idx]

    def __getitem__(self, sel):
        if isinstance(sel, (str, int)):
            return self.col(sel)
        if isinstance(sel, (list, tuple)):
            return self.subframe(sel)
        raise TypeError(f"bad frame selector {sel!r}")

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def add(self, name: str, col: Column) -> "Frame":
        if self._names and col.nrows != self.nrows:
            raise ValueError(f"column {name!r} has {col.nrows} rows, frame "
                             f"has {self.nrows}")
        if self._names and col.shard != self.col(0).shard:
            raise ValueError(f"column {name!r} holds rows {col.shard}, the "
                             f"frame's columns {self.col(0).shard}")
        if name in self._cols:
            raise ValueError(f"duplicate column {name!r}")
        self._names.append(name)
        self._cols[name] = col
        return self

    def replace(self, name: str, col: Column) -> "Frame":
        """Copy-on-write column replacement (adds an unknown name)."""
        if name not in self._cols:
            return self.add(name, col)
        if col.nrows != self.nrows:
            raise ValueError("row mismatch")
        self._cols[name] = col
        return self

    def swap_columns(self, mapping: Dict[str, Column]) -> "Frame":
        """Swap every column for a replacement of one new row count at
        once (streaming appends grow all columns together)."""
        if set(mapping) != set(self._names):
            raise ValueError("swap_columns must cover exactly the frame's "
                             "columns")
        rows = {c.nrows for c in mapping.values()}
        if len(rows) > 1:
            raise ValueError(f"swap_columns row counts disagree: {rows}")
        self._cols = {nm: mapping[nm] for nm in self._names}
        return self

    def drop(self, name: str) -> "Frame":
        self._names.remove(name)
        self._cols.pop(name)
        return self

    def rename(self, old: str, new: str) -> "Frame":
        i = self._names.index(old)
        self._names[i] = new
        self._cols[new] = self._cols.pop(old)
        return self

    def subframe(self, names: Sequence[Union[str, int]],
                 key: Optional[str] = None) -> "Frame":
        fr = Frame(key=key)
        for n in names:
            nm = self._names[n] if isinstance(n, int) else n
            fr.add(nm, self._cols[nm])
        return fr

    def cbind(self, other: "Frame") -> "Frame":
        """Columns of self, then other's; a clashing name gets "0"
        appended until it is unique (H2O's dedup)."""
        fr = Frame()
        for n in self._names:
            fr.add(n, self._cols[n])
        for n in other._names:
            nm = n
            while nm in fr._cols:
                nm = nm + "0"
            fr.add(nm, other._cols[n])
        return fr

    def summary(self) -> Dict[str, dict]:
        out = {}
        for n in self._names:
            c = self._cols[n]
            if c.is_numeric or c.ctype == T_TIME:
                r = c.rollups
                out[n] = {"type": c.ctype, "min": r.min, "max": r.max,
                          "mean": r.mean, "sigma": r.sigma,
                          "na_count": r.na_count}
            elif c.is_categorical:
                out[n] = {"type": c.ctype, "cardinality": c.cardinality,
                          "na_count": c.rollups.na_count}
            else:
                out[n] = {"type": c.ctype}
        return out

    def to_pandas(self):
        """The frame as a pandas DataFrame of user-facing values. pandas
        is imported here only: the port runs without it, and this call
        raises ImportError where it is not installed."""
        import pandas as pd

        return pd.DataFrame({n: self._cols[n].values() for n in self._names})

    def to_numpy(self) -> np.ndarray:
        return np.column_stack([self._cols[n].to_numpy()
                                for n in self._names])

    @staticmethod
    def from_numpy(arr, names: Optional[Sequence[str]] = None,
                   key: Optional[str] = None, device=None) -> "Frame":
        """A 2-D array's columns as a frame (names C1, C2, ... unless
        given), each typed by its dtype."""
        arr = np.atleast_2d(np.asarray(arr))
        names = (list(names) if names
                 else [f"C{i + 1}" for i in range(arr.shape[1])])
        fr = Frame(key=key)
        for i, n in enumerate(names):
            fr.add(n, Column.from_numpy(arr[:, i], device=device))
        return fr

    @staticmethod
    def from_pandas(df, key: Optional[str] = None,
                    column_types: Optional[Dict[str, str]] = None,
                    device=None) -> "Frame":
        """A pandas DataFrame as a frame: string and category columns
        become enums unless `column_types` says otherwise. Only the
        DataFrame's own methods are used; pandas is never imported."""
        fr = Frame(key=key)
        for n in df.columns:
            s = df[n]
            ctype = (column_types or {}).get(n)
            if ctype is None and (s.dtype.name == "category"
                                  or s.dtype.kind in "OUS"):
                ctype = T_CAT
            fr.add(str(n), Column.from_numpy(s.to_numpy(), ctype=ctype,
                                             device=device))
        return fr

    def __repr__(self) -> str:
        return (f"<Frame {self._key} {self.nrows}x{self.ncols} "
                f"{self._names[:8]}>")
