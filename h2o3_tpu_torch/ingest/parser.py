"""Parse orchestration: files -> typed columns -> an H2OFrame on the device
(counterpart of h2o3_tpu/ingest/parser.py).

CSV files take the chunked path (ingest/chunked.py): record-aligned ~4 MB
byte ranges parse concurrently through the port's C++ parser and land in
one tensor per column. On `ChunkLayoutError`, for ``.gz``/``.zip`` files
and with the chunked path switched off, the monolithic path runs the same
C++ parser over each whole (decompressed) file and concatenates the host
columns before the copy to the device; those whole-column host buffers
count as ``coordinator_ingest_bytes``. Other formats parse on the host
(ingest/formats.py, avro.py) and take the monolithic assembly.

No path parses CSV with pandas or with Python. The frame is installed
in the DKV under `destination_frame`, or under a generated key.
"""

from __future__ import annotations

import glob as _glob
import math
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from h2o3_tpu_torch.core.frame import (T_CAT, T_STR, T_TIME, Column,
                                       code_dtype)
from h2o3_tpu_torch.frame_factory import H2OFrame
from h2o3_tpu_torch.ingest.parse_setup import (ParseSetup, guess_setup,
                                               open_stream)

# pandas' default NA strings, which the reference's read_csv adds to the
# setup's (keep_default_na=True)
DEFAULT_NA = ("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
              "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN",
              "None", "n/a", "nan", "null")


def parse_setup(paths, **kw) -> ParseSetup:
    p = paths[0] if isinstance(paths, (list, tuple)) else paths
    return guess_setup(p, **kw)


def na_values(na_strings: Sequence[str]) -> Tuple[List[str], List[float]]:
    """The NA strings and numeric NA values of a parse: the setup's NA
    strings plus pandas' defaults, each number also in its integral
    spellings ("999" -> "999.0"), and the non-NaN numbers among them,
    as the reference's read_csv(na_values=..., keep_default_na=True)
    derives them."""
    base = {s for s in na_strings if s != ""} | set(DEFAULT_NA)
    strs, floats = set(base), set()
    for x in base:
        try:
            v = float(x)
        except (TypeError, ValueError, OverflowError):
            continue
        if not math.isnan(v):
            floats.add(v)
        try:
            if v == int(v):
                strs.update((f"{int(v)}.0", str(int(v))))
        except (ValueError, OverflowError):
            pass
    return sorted(strs), sorted(floats)


def csv_spec(setup: ParseSetup):
    """The one NA block shared by the chunked path, the monolithic path
    and stream batches (the reference's csv_read_kwargs :37): conversion
    rules change here, never in one caller."""
    from h2o3_tpu_torch import native

    strs, floats = na_values(setup.na_strings)
    return native.NaSpec(strs, floats)


def _note_parse_opts(fr, setup: ParseSetup) -> None:
    """Keep the options a streaming append must parse with."""
    fr._parse_opts = {"na_strings": list(setup.na_strings),
                      "quote_char": setup.quote_char,
                      "separator": setup.separator}


def _read_bytes(path: str) -> np.ndarray:
    """A file's bytes: mapped for plain files, decompressed for .gz/.zip."""
    if path.endswith(".gz"):
        import gzip

        with gzip.open(path, "rb") as f:
            return np.frombuffer(f.read(), np.uint8)
    if path.endswith(".zip"):
        import zipfile

        with zipfile.ZipFile(path) as zf:
            return np.frombuffer(zf.read(zf.namelist()[0]), np.uint8)
    if os.path.getsize(path) == 0:
        return np.zeros(0, np.uint8)
    return np.memmap(path, dtype=np.uint8, mode="r")


def _parse_csv_host(path: str, setup: ParseSetup) -> Dict[str, tuple]:
    """Parse one whole file into host columns with the C++ parser."""
    from h2o3_tpu_torch.ingest.chunked import parse_buffer

    buf = _read_bytes(path)
    addr = int(buf.ctypes.data) if len(buf) else 0
    _n, cols = parse_buffer(addr, len(buf), setup,
                            skip_header=setup.check_header == 1)
    return cols


def _parse_one(path: str, setup: ParseSetup):
    """-> ({name: host value}, names, types) for one file, dispatched on
    parse_type. CSV values are tagged tuples (see chunked.parse_buffer);
    other formats give plain arrays."""
    from h2o3_tpu_torch.ingest import formats

    pt = setup.parse_type
    if pt == "CSV":
        return _parse_csv_host(path, setup), list(setup.column_names), \
            list(setup.column_types)
    if pt in ("PARQUET", "ORC", "FEATHER"):
        cols, names, types = formats.parse_columnar_host(path, pt)
    elif pt == "ARFF":
        cols, names, types = formats.parse_arff_host(path)
    elif pt == "SVMLight":
        cols, names, types = formats.parse_svmlight_host(path)
    elif pt == "AVRO":
        from h2o3_tpu_torch.ingest.avro import parse_avro_host

        cols, names, types = parse_avro_host(path)
    elif pt == "XLSX":
        cols, names, types = formats.parse_xlsx_host(path)
    else:
        raise ValueError(f"unknown parse_type {pt!r}")
    # user col_types overrides carried on the setup (the file's own schema
    # parsed first)
    if setup.column_types and len(setup.column_types) == len(types):
        for i, nm in enumerate(names):
            want = setup.column_types[i]
            if want != types[i]:
                cols[nm] = formats.coerce_col(cols[nm], types[i], want)
        types = list(setup.column_types)
    return cols, names, types


def _concat_csv(parts: List[tuple], t: str):
    """Concatenate one CSV column's per-file host parts."""
    kind = parts[0][0]
    if kind == "cat":
        from h2o3_tpu_torch.ingest.chunked import remap_lut

        gdom = sorted(set().union(*(p[1] for p in parts)))
        out = []
        for _k, dom, codes in parts:
            lut = remap_lut(gdom, dom)
            out.append(lut[np.where(codes < 0, len(dom), codes)])
        return "cat", gdom, np.concatenate(out).astype(np.int32)
    return kind, np.concatenate([p[1] for p in parts])


def _column(val, t: str, device) -> Column:
    """A host column (CSV tagged tuple or plain array) on `device`."""
    from h2o3_tpu_torch.ingest import chunked

    if isinstance(val, tuple):
        kind = val[0]
        if kind == "cat":
            dom, codes = val[1], val[2]
            chunked.note_coordinator_bytes(codes.nbytes)
            return Column.from_numpy(codes.astype(code_dtype(len(dom))),
                                     ctype=T_CAT, domain=dom, device=device)
        if kind == "str":
            return Column(None, T_STR, len(val[1]), host_data=val[1])
        chunked.note_coordinator_bytes(val[1].nbytes)
        return Column.from_numpy(val[1], ctype=T_TIME if kind == "time"
                                 else None, device=device)
    arr = val
    if t != T_STR:
        chunked.note_coordinator_bytes(arr.nbytes)
    if t == T_CAT:
        return Column.from_numpy(arr, ctype=T_CAT, device=device)
    if t == T_STR:
        return Column(None, T_STR, len(arr), host_data=np.asarray(
            arr, dtype=object))
    if t == T_TIME:
        return Column.from_numpy(arr, ctype=T_TIME, device=device)
    return Column.from_numpy(np.asarray(arr, np.float64), device=device)


def parse(paths: Sequence[str], setup: ParseSetup,
          destination_frame: Optional[str] = None, device=None) -> H2OFrame:
    """Parse files into one H2OFrame on `device` (default: the
    runtime's), installed under `destination_frame`.
    Multi-file CSV parses must share the first file's header."""
    from h2o3_tpu_torch import persist
    from h2o3_tpu_torch.ingest import chunked

    paths = persist.resolve_all(list(paths))
    if setup.parse_type == "CSV" and setup.check_header == 1 and \
            len(paths) > 1:
        import csv as _csv

        def _hdr(p):
            with open_stream(p) as f:
                first = f.readline().rstrip("\n")
            return [c.strip() for c in
                    next(_csv.reader([first], delimiter=setup.separator))]

        hdr0 = _hdr(paths[0])
        for p in paths[1:]:
            hdr = _hdr(p)
            if hdr != hdr0:
                raise ValueError(f"column mismatch across files: {p} has "
                                 f"{hdr}, expected {hdr0}")
    if setup.parse_type == "CSV":
        try:
            got = chunked.parse_csv_sharded(paths, setup, device=device)
        except chunked.ChunkLayoutError:
            got = None
        if got is not None:
            fr = H2OFrame(destination_frame=destination_frame)
            for name in setup.column_names:
                fr.add(name, got[name])
            _note_parse_opts(fr, setup)
            return fr
    if len(paths) == 1:
        results = [_parse_one(paths[0], setup)]
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, len(paths))) as pool:
            results = list(pool.map(lambda p: _parse_one(p, setup), paths))
    if setup.parse_type == "SVMLight" and len(results) > 1:
        # sparse files densify to their own widest index; unify the widths
        widest = max(results, key=lambda r: len(r[1]))
        wnames, wtypes = widest[1], widest[2]
        for cols_i, n_i, _t in results:
            nr = len(cols_i[n_i[0]]) if n_i else 0
            for nm in wnames[len(n_i):]:
                cols_i[nm] = np.zeros(nr, np.float64)
            n_i[:] = wnames
            _t[:] = wtypes
    _, names, types = results[0]
    for p, (_, n_i, t_i) in zip(paths[1:], results[1:]):
        if n_i != names:
            raise ValueError(f"column mismatch across files: {p} has "
                             f"{n_i}, expected {names}")
        if t_i != types:
            raise ValueError(f"column type mismatch across files: {p} has "
                             f"{t_i}, expected {types}")
    final_names = (list(setup.column_names)
                   if setup.column_names
                   and len(setup.column_names) == len(names)
                   else list(names))
    fr = H2OFrame(destination_frame=destination_frame)
    for name, final, t in zip(names, final_names, types):
        parts = [r[0][name] for r in results]
        if isinstance(parts[0], tuple):
            val = _concat_csv(parts, t) if len(parts) > 1 else parts[0]
        else:
            val = np.concatenate(parts) if len(parts) > 1 else parts[0]
        fr.add(final, _column(val, t, device))
    _note_parse_opts(fr, setup)
    return fr


def import_file(path: str, destination_frame: Optional[str] = None,
                header: int = 0, sep: Optional[str] = None,
                col_names: Optional[List[str]] = None,
                col_types=None, na_strings=None, device=None,
                **kw) -> H2OFrame:
    """h2o.import_file: resolves URIs through the persist registry,
    expands globs and directories, guesses the setup and parses onto
    `device` (default: the runtime's, CUDA unless booted on the CPU)."""
    from h2o3_tpu_torch import persist

    if persist.is_remote(path):
        paths = [persist.resolve(path)]
    else:
        paths = (sorted(_glob.glob(path)) if any(ch in path for ch in "*?[")
                 else [path])
        if len(paths) == 1 and os.path.isdir(paths[0]):
            paths = sorted(os.path.join(paths[0], f)
                           for f in os.listdir(paths[0])
                           if not f.startswith("."))
    if not paths:
        raise FileNotFoundError(path)
    ct = None
    if isinstance(col_types, dict):
        ct = col_types
    elif isinstance(col_types, (list, tuple)):
        ct = {i: t for i, t in enumerate(col_types)}
    setup = guess_setup(paths[0], column_types=ct, na_strings=na_strings,
                        header=(1 if header == 1 else
                                (-1 if header == -1 else None)),
                        separator=sep)
    if col_names:
        setup.column_names = list(col_names)
    return parse(paths, setup, destination_frame=destination_frame,
                 device=device)


upload_file = import_file  # the same machinery in one process


class _ParquetBatchLoader:
    """Shared first-touch loader of one lazily opened Parquet frame: the
    first touched column reads a window of adjacent pending columns in
    one column-pruned ``read_table`` (H2O_TPU_INGEST_PARQUET_BATCH wide)
    and keeps the others' host arrays, so N first touches cost
    ceil(N / batch) reads."""

    def __init__(self, path: str, pending: List[Tuple[str, str]], device):
        self._path = path
        self._device = device
        self._pending = list(pending)          # (name, ctype), file order
        self._cache: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inflight: set = set()

    def load(self, name: str, ctype: str):
        from h2o3_tpu_torch.core.frame import numeric_host, store_numeric
        from h2o3_tpu_torch.ingest import chunked, formats

        with self._lock:
            while True:
                buf = self._cache.pop(name, None)
                if buf is not None:
                    return store_numeric(buf, ctype, self._device)
                if name not in self._inflight:
                    break
                self._cond.wait()          # another read covers it
            idx = next((i for i, (nm, _t) in enumerate(self._pending)
                        if nm == name), None)
            if idx is None:
                batch = [(name, ctype)]
            else:
                batch = self._pending[idx:idx + chunked.parquet_batch()]
                del self._pending[idx:idx + len(batch)]
            self._inflight.update(nm for nm, _ in batch)
        import pyarrow.parquet as pq

        got: Dict[str, np.ndarray] = {}
        try:
            tbl = pq.read_table(self._path, columns=[nm for nm, _ in batch])
            cols, _types = formats.arrow_to_host_cols(tbl)
            for nm, ct in batch:
                b = numeric_host(cols[nm], ct)
                chunked.note_coordinator_bytes(b.nbytes)
                got[nm] = b
        finally:
            with self._lock:
                self._inflight.difference_update(nm for nm, _ in batch)
                for nm, b in got.items():
                    if nm != name:
                        self._cache[nm] = b
                cap = max(4 * chunked.parquet_batch(), 16)
                while len(self._cache) > cap:
                    self._cache.pop(next(iter(self._cache)))
                self._cond.notify_all()
        return store_numeric(got[name], ctype, self._device)


def lazy_import_parquet(path: str, destination_frame: Optional[str] = None,
                        device=None) -> H2OFrame:
    """A Parquet frame whose numeric and time columns stay on disk until
    first touched (water/fvec/FileVec.java): enum and string columns load
    at once (their domains are frame metadata); first-touch numeric loads
    batch through one shared column-pruned read."""
    from h2o3_tpu_torch import persist
    from h2o3_tpu_torch.ingest import chunked, formats

    local = persist.resolve(path)
    import pyarrow.parquet as pq

    n = pq.read_metadata(local).num_rows
    schema = pq.read_schema(local)
    names = [f.name for f in schema]
    types = [formats._arrow_field_type(f.type) for f in schema]
    fr = H2OFrame(destination_frame=destination_frame)
    eager = [nm for nm, t in zip(names, types) if t in (T_CAT, T_STR)]
    eager_cols = {}
    if eager:
        tbl = pq.read_table(local, columns=eager)
        eager_cols, _types = formats.arrow_to_host_cols(tbl)
        for nm in eager:
            chunked.note_coordinator_bytes(eager_cols[nm].nbytes)
    lazy = _ParquetBatchLoader(
        local, [(nm, t) for nm, t in zip(names, types)
                if t not in (T_CAT, T_STR)], device)
    for name, t in zip(names, types):
        if t in (T_CAT, T_STR):
            fr.add(name, _column(eager_cols[name], t, device))
            continue
        fr.add(name, Column.file_backed(
            lambda col=name, ct=t: lazy.load(col, ct), t, n))
    return fr
