"""Columnar & structured format readers: Parquet / ORC / Feather (pyarrow,
imported when such a file is read), ARFF, SVMLight, XLSX (counterpart of
h2o3_tpu/ingest/formats.py).

Reference: h2o-parsers/h2o-parquet-parser/ (VecParquetReader walks row
groups into NewChunks), h2o-parsers/h2o-orc-parser/, water/parser/ARFFParser
.java, water/parser/SVMLightParser.java.

Columnar files are already typed and column-major, so readers go straight
from the format's column vectors to host numpy, and `Column.from_numpy`
puts them on the device. Types map: floating/int -> f32 columns,
dictionary/string -> enum via the normal interning path, timestamp ->
epoch-millis T_TIME, bool -> 0/1 numeric. Nothing here imports pandas:
strings leave pyarrow as object arrays, and ARFF dates go through the
port's own time parser."""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from h2o3_tpu_torch.core.frame import T_CAT, T_NUM, T_STR, T_TIME

# extensions -> parse type (ParseSetup._parse_type analog)
COLUMNAR_EXT = {".parquet": "PARQUET", ".pq": "PARQUET", ".orc": "ORC",
                ".feather": "FEATHER", ".arrow": "FEATHER"}
STRUCTURED_EXT = {".arff": "ARFF", ".svm": "SVMLight",
                  ".svmlight": "SVMLight"}


# legacy BIFF .xls only: a 1997 binary format whose decoder (POI/xlrd)
# this image lacks; .xlsx and .avro parse natively (round 4)
GATED_EXT = {".xls": "XLS"}
NATIVE_BINARY_EXT = {".xlsx": "XLSX", ".avro": "AVRO"}


def detect_parse_type(path: str) -> Optional[str]:
    """Extension -> parse type; None = fall back to CSV text sniffing.
    Raises for known-binary formats whose decoders are not present
    (surfaced as HTTP 501 by the REST layer)."""
    from h2o3_tpu_torch.errors import CapabilityGate

    ext = os.path.splitext(path)[1].lower()
    if ext in GATED_EXT:
        # fail fast with the reason — sniffing these binaries as CSV would
        # produce garbage columns (reference: legacy XlsParser rides POI)
        raise CapabilityGate(
            f"{GATED_EXT[ext]} (legacy BIFF) parsing needs a decoder "
            "library not present in this environment (xlrd). Save as "
            ".xlsx or CSV and import that instead.")
    return (COLUMNAR_EXT.get(ext) or STRUCTURED_EXT.get(ext)
            or NATIVE_BINARY_EXT.get(ext))


# ---------------------------------------------------------------------------
# pyarrow-backed columnar formats
# ---------------------------------------------------------------------------

def _read_arrow_table(path: str, parse_type: str):
    import pyarrow as pa

    if parse_type == "PARQUET":
        import pyarrow.parquet as pq

        return pq.read_table(path)
    if parse_type == "ORC":
        import pyarrow.orc as orc

        return orc.read_table(path)
    if parse_type == "FEATHER":
        # Feather V2 IS the Arrow IPC file format (feather.read_table is
        # deprecated in favor of this)
        try:
            with pa.ipc.open_file(path) as r:
                return r.read_all()
        except pa.ArrowInvalid:
            import pyarrow.feather as feather    # Feather V1 fallback

            return feather.read_table(path)
    raise ValueError(parse_type)


def arrow_to_host_cols(table) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """pyarrow Table -> (host column arrays, column types)."""
    import pyarrow as pa

    cols: Dict[str, np.ndarray] = {}
    types: List[str] = []
    for name, col in zip(table.column_names, table.columns):
        t = col.type
        if pa.types.is_dictionary(t):
            col = col.cast(t.value_type)
            t = col.type
        if pa.types.is_timestamp(t) or pa.types.is_date(t):
            ms = col.cast(pa.timestamp("ms")).cast(pa.int64())
            arr = ms.to_numpy(zero_copy_only=False).astype(np.float64)
            mask = np.asarray(col.is_null().combine_chunks())
            arr[mask] = np.nan
            cols[name] = arr
            types.append(T_TIME)
        elif pa.types.is_boolean(t):
            arr = col.cast(pa.float64()).to_numpy(zero_copy_only=False)
            cols[name] = np.asarray(arr, np.float64)
            types.append(T_NUM)
        elif pa.types.is_integer(t) or pa.types.is_floating(t) \
                or pa.types.is_decimal(t):
            arr = col.cast(pa.float64()).to_numpy(zero_copy_only=False)
            cols[name] = np.asarray(arr, np.float64)
            types.append(T_NUM)
        elif pa.types.is_string(t) or pa.types.is_large_string(t):
            obj = np.empty(len(col), object)
            obj[:] = col.to_pylist()
            cols[name] = obj
            types.append(T_CAT)
        else:
            # lists/structs/binary: stringified (reference skips with warn)
            obj = np.array([None if v is None else str(v)
                            for v in col.to_pylist()], object)
            cols[name] = obj
            types.append(T_STR)
    return cols, types


def parse_columnar_host(path: str, parse_type: str
                        ) -> Tuple[Dict[str, np.ndarray], List[str], List[str]]:
    """-> (cols, names, types)."""
    table = _read_arrow_table(path, parse_type)
    cols, types = arrow_to_host_cols(table)
    return cols, list(table.column_names), types


def coerce_col(arr: np.ndarray, t_from: str, t_to: str) -> np.ndarray:
    """Apply a user type override (h2o-py col_types) to an already-parsed
    host column: numeric -> enum renders labels (integral floats drop the
    '.0', matching the CSV path's string view of the same data); object ->
    numeric parses with NaN on failure."""
    if t_to in (T_CAT, T_STR) and t_from in (T_NUM, T_TIME):
        out = np.empty(len(arr), object)
        for i, v in enumerate(arr):
            if v is None or (isinstance(v, float) and np.isnan(v)):
                out[i] = None
            else:
                fv = float(v)
                out[i] = str(int(fv)) if fv == int(fv) else str(fv)
        return out
    if t_to in (T_NUM, T_TIME) and t_from in (T_CAT, T_STR):
        out = np.empty(len(arr), np.float64)
        for i, v in enumerate(arr):
            try:
                out[i] = float(v)
            except (TypeError, ValueError):
                out[i] = np.nan
        return out
    return arr


def _arrow_field_type(t) -> str:
    import pyarrow as pa

    if pa.types.is_dictionary(t):
        t = t.value_type
    if pa.types.is_timestamp(t) or pa.types.is_date(t):
        return T_TIME
    if pa.types.is_boolean(t) or pa.types.is_integer(t) \
            or pa.types.is_floating(t) or pa.types.is_decimal(t):
        return T_NUM
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return T_CAT
    return T_STR


def columnar_schema(path: str, parse_type: str) -> Tuple[List[str], List[str]]:
    """Schema-only read for ParseSetup guessing (cheap for Parquet/ORC)."""
    if parse_type == "PARQUET":
        import pyarrow.parquet as pq

        schema = pq.read_schema(path)
    elif parse_type == "ORC":
        import pyarrow.orc as orc

        schema = orc.ORCFile(path).schema
    else:
        import pyarrow as pa

        try:
            with pa.ipc.open_file(path) as r:    # Feather V2 = IPC: no data read
                schema = r.schema
        except pa.ArrowInvalid:
            schema = _read_arrow_table(path, parse_type).schema
    return ([f.name for f in schema],
            [_arrow_field_type(f.type) for f in schema])


# ---------------------------------------------------------------------------
# ARFF (water/parser/ARFFParser.java behavior: @attribute typed header,
# @data CSV body; {a,b,c} nominal specs -> enum)
# ---------------------------------------------------------------------------

_ARFF_ATTR = re.compile(r"@attribute\s+('(?:[^']*)'|\"(?:[^\"]*)\"|\S+)\s+(.+)",
                        re.IGNORECASE)


def _scan_arff(path: str, want_data: bool):
    from h2o3_tpu_torch.ingest.parse_setup import open_stream

    names: List[str] = []
    types: List[str] = []
    data_lines: List[str] = []
    in_data = False
    with open_stream(path) as f:
        for ln in f:
            s = ln.strip()
            if not s or s.startswith("%"):
                continue
            if in_data:
                data_lines.append(s)
                continue
            low = s.lower()
            if low.startswith("@data"):
                if not want_data:
                    break
                in_data = True
            elif low.startswith("@attribute"):
                m = _ARFF_ATTR.match(s)
                if not m:
                    raise ValueError(f"bad ARFF attribute line: {s!r}")
                nm, spec = m.group(1).strip("'\""), m.group(2).strip()
                names.append(nm)
                sl = spec.lower()
                if spec.startswith("{"):
                    types.append(T_CAT)
                elif sl.startswith(("numeric", "real", "integer")):
                    types.append(T_NUM)
                elif sl.startswith("date"):
                    types.append(T_TIME)
                else:
                    types.append(T_STR)
    if not names:
        raise ValueError(f"no @attribute declarations in {path}")
    return names, types, data_lines


def arff_header(path: str) -> Tuple[List[str], List[str]]:
    names, types, _ = _scan_arff(path, want_data=False)
    return names, types


def parse_arff_host(path: str) -> Tuple[Dict[str, np.ndarray], List[str], List[str]]:
    names, types, data_lines = _scan_arff(path, want_data=True)
    import csv as _csv

    rows = list(_csv.reader(data_lines))
    ncols = len(names)
    cols: Dict[str, np.ndarray] = {}
    for i, (nm, t) in enumerate(zip(names, types)):
        vals = [r[i].strip() if i < len(r) else "" for r in rows]
        if t == T_NUM:
            cols[nm] = np.array([float(v) if v not in ("", "?") else np.nan
                                 for v in vals], np.float64)
        elif t == T_TIME:
            from h2o3_tpu_torch.ingest.chunked import times_from_strings

            cols[nm] = times_from_strings(
                [None if v in ("", "?") else v for v in vals])
        else:
            cols[nm] = np.array([None if v in ("", "?") else v.strip("'\"")
                                 for v in vals], object)
    return cols, names, types


# ---------------------------------------------------------------------------
# SVMLight (water/parser/SVMLightParser.java: "label idx:val idx:val ...",
# 1-based indices, zero-default sparse -> dense here, the device layout)
# ---------------------------------------------------------------------------

def parse_svmlight_host(path: str) -> Tuple[Dict[str, np.ndarray], List[str], List[str]]:
    from h2o3_tpu_torch.ingest.parse_setup import open_stream

    labels: List[float] = []
    entries: List[List[Tuple[int, float]]] = []
    max_idx = 0
    with open_stream(path) as f:
        for ln in f:
            s = ln.split("#", 1)[0].strip()
            if not s:
                continue
            toks = s.split()
            labels.append(float(toks[0]))
            row = []
            for tk in toks[1:]:
                if tk.startswith("qid:"):
                    continue
                idx, val = tk.split(":", 1)
                i = int(idx)
                if i < 1:
                    raise ValueError(f"SVMLight indices are 1-based, got {i}")
                row.append((i, float(val)))
                max_idx = max(max_idx, i)
            entries.append(row)
    n = len(labels)
    dense = np.zeros((n, max_idx), np.float64)
    for r, row in enumerate(entries):
        for i, v in row:
            dense[r, i - 1] = v
    names = ["C1"] + [f"C{i+2}" for i in range(max_idx)]
    cols = {"C1": np.asarray(labels, np.float64)}
    for i in range(max_idx):
        cols[names[i + 1]] = dense[:, i]
    return cols, names, [T_NUM] * len(names)


# ---------------------------------------------------------------------------
# XLSX (stdlib zip + XML — reference: h2o XlsxParser via POI-like decode)
# ---------------------------------------------------------------------------

def _xlsx_col_index(ref: str) -> int:
    """Cell ref 'BC12' -> zero-based column index."""
    idx = 0
    for ch in ref:
        if not ch.isalpha():
            break
        idx = idx * 26 + (ord(ch.upper()) - ord("A") + 1)
    return idx - 1


def xlsx_header(path: str, sample_rows: int = 100
                ) -> Tuple[List[str], List[str]]:
    """Names + sampled types without keeping the data (ParseSetup tier)."""
    cols, names, types = parse_xlsx_host(path, max_rows=sample_rows)
    return names, types


def parse_xlsx_host(path: str, max_rows: Optional[int] = None
                    ) -> Tuple[Dict[str, np.ndarray], List[str],
                               List[str]]:
    """First worksheet of an .xlsx workbook -> (cols, names, types); row 1
    is the header (the reference's XlsParser contract)."""
    import xml.etree.ElementTree as ET
    import zipfile

    NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
    with zipfile.ZipFile(path) as z:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root:
                shared.append("".join(t.text or ""
                                      for t in si.iter(NS + "t")))
        sheets = sorted(n for n in z.namelist()
                        if n.startswith("xl/worksheets/sheet"))
        if not sheets:
            raise ValueError(f"{path!r}: no worksheets")
        root = ET.fromstring(z.read(sheets[0]))
        # honor r attributes: Excel omits empty rows/cells from the XML,
        # so both row index and column index come from the refs, with
        # sequential fallbacks when a writer drops them
        rowmap: Dict[int, Dict[int, Optional[str]]] = {}
        ncols = 0
        next_row = 1
        for row in root.iter(NS + "row"):
            if max_rows is not None and len(rowmap) > max_rows:
                break            # ParseSetup tier: sample only
            ri = int(row.get("r", next_row))
            next_row = ri + 1
            cells: Dict[int, Optional[str]] = {}
            next_ci = 0
            for c in row.iter(NS + "c"):
                ref = c.get("r")
                ci = _xlsx_col_index(ref) if ref else next_ci
                next_ci = ci + 1
                t = c.get("t")
                vel = c.find(NS + "v")
                if vel is not None:
                    val = vel.text
                    if t == "s" and val is not None:
                        val = shared[int(val)]
                elif c.find(NS + "is") is not None:
                    val = "".join(tt.text or ""
                                  for tt in c.find(NS + "is").iter(NS + "t"))
                else:
                    val = None
                cells[ci] = val
                ncols = max(ncols, ci + 1)
            rowmap[ri] = cells
        if not rowmap:
            grid: List[Dict[int, Optional[str]]] = []
        else:
            first, last = min(rowmap), max(rowmap)
            grid = [rowmap.get(i, {}) for i in range(first, last + 1)]
    if not grid:
        raise ValueError(f"{path!r}: empty worksheet")
    header = [str(grid[0].get(j) or f"C{j + 1}") for j in range(ncols)]
    body = grid[1:]
    if max_rows is not None:
        body = body[:max_rows]
    cols: Dict[str, np.ndarray] = {}
    types: List[str] = []
    for j, name in enumerate(header):
        raw = [r.get(j) for r in body]
        numeric = True
        vals = np.full(len(raw), np.nan)
        for i, v in enumerate(raw):
            if v is None or v == "":
                continue
            try:
                vals[i] = float(v)
            except ValueError:
                numeric = False
                break
        if numeric:
            cols[name] = vals
            types.append("real")
        else:
            cols[name] = np.asarray(["" if v is None else str(v)
                                     for v in raw], object)
            types.append("enum")
    return cols, header, types
