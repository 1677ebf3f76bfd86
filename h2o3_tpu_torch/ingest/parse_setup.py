"""ParseSetup: separator, header and column-type guessing from a sample
(host-only copy of h2o3_tpu/ingest/parse_setup.py).

Samples the first rows, guesses the separator by column-count stability,
the header by first-row typeability and each column's type by a vote
over the sampled values (NUM < TIME < CAT < STR escalation), as
water/parser/ParseSetup.java does."""

from __future__ import annotations

import csv as _csv
import gzip
import io
import re
import zipfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from h2o3_tpu_torch.core.frame import T_CAT, T_NUM, T_STR, T_TIME

_SEPS = [",", "\t", ";", "|", " "]
_TIME_RE = re.compile(r"^\d{4}-\d{2}-\d{2}([ T]\d{2}:\d{2}(:\d{2})?)?$")
_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")
# max unique strings before a column escalates CAT -> STR
MAX_CAT_DOMAIN = 10_000_000  # H2O Categorical.MAX_CATEGORICAL_COUNT analog


@dataclass
class ParseSetup:
    separator: str = ","
    check_header: int = 1  # 1 = has header, -1 = none (H2O convention)
    column_names: List[str] = field(default_factory=list)
    column_types: List[str] = field(default_factory=list)
    na_strings: List[str] = field(default_factory=lambda: ["", "NA", "N/A", "nan", "NaN", "null"])
    skipped_columns: List[int] = field(default_factory=list)
    quote_char: str = '"'
    # CSV / PARQUET / ORC / FEATHER / ARFF / SVMLight
    # (ParseSetup._parse_type analog; drives the reader dispatch)
    parse_type: str = "CSV"

    def to_dict(self) -> dict:
        return {
            "separator": ord(self.separator),
            "check_header": self.check_header,
            "column_names": self.column_names,
            "column_types": self.column_types,
            "na_strings": self.na_strings,
            "parse_type": self.parse_type,
        }


def open_stream(path: str):
    """Transparent decompression (water/parser/ZipUtil.java parity)."""
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), errors="replace")
    if path.endswith(".zip"):
        zf = zipfile.ZipFile(path)
        inner = zf.namelist()[0]
        return io.TextIOWrapper(zf.open(inner), errors="replace")
    return open(path, "r", errors="replace")


def _sniff_sep(sample_lines: List[str]) -> str:
    best, best_score = ",", -1
    for sep in _SEPS:
        counts = [len(next(_csv.reader([ln], delimiter=sep), [])) for ln in sample_lines if ln.strip()]
        if not counts:
            continue
        ncols = max(set(counts), key=counts.count)
        if ncols < 2:
            score = 0
        else:
            score = sum(1 for c in counts if c == ncols) * ncols
        if score > best_score:
            best, best_score = sep, score
    return best


def _classify(tok: str, na_strings) -> str:
    if tok in na_strings:
        return "na"
    if _NUM_RE.match(tok):
        return T_NUM
    if _TIME_RE.match(tok):
        return T_TIME
    return T_STR


def guess_setup(path: str, sample_rows: int = 1000,
                column_types: Optional[Dict[str, str]] = None,
                na_strings: Optional[List[str]] = None,
                header: Optional[int] = None,
                separator: Optional[str] = None) -> ParseSetup:
    # non-CSV formats carry their own schema: no text sampling
    from h2o3_tpu_torch.ingest import formats

    ptype = formats.detect_parse_type(path)
    if ptype is not None:
        setup = ParseSetup(parse_type=ptype)
        if ptype in formats.COLUMNAR_EXT.values():
            setup.column_names, setup.column_types = \
                formats.columnar_schema(path, ptype)
        elif ptype == "ARFF":
            setup.column_names, setup.column_types = formats.arff_header(path)
        elif ptype == "AVRO":
            from h2o3_tpu_torch.ingest.avro import avro_schema

            setup.column_names, setup.column_types = avro_schema(path)
        elif ptype == "XLSX":
            setup.column_names, setup.column_types = \
                formats.xlsx_header(path)
        # SVMLight: width only known after a full scan; filled at parse time
        if column_types and setup.column_types:
            _apply_type_overrides(setup.column_types, setup.column_names,
                                  column_types)
        return setup
    setup = ParseSetup()
    if na_strings:
        setup.na_strings = list(na_strings) + [""]
    with open_stream(path) as f:
        lines = []
        for _ in range(sample_rows + 1):
            ln = f.readline()
            if not ln:
                break
            lines.append(ln.rstrip("\n"))
    if not lines:
        raise ValueError(f"empty file {path}")
    setup.separator = separator or _sniff_sep(lines[:50])
    rows = list(_csv.reader(lines, delimiter=setup.separator, quotechar=setup.quote_char))
    rows = [r for r in rows if r]
    first, rest = rows[0], rows[1:] or [rows[0]]

    # header guess: first row all-string while data rows have numbers
    first_types = [_classify(t.strip(), setup.na_strings) for t in first]
    data_has_num = any(_classify(t.strip(), setup.na_strings) == T_NUM for r in rest[:20] for t in r)
    if header is not None:
        setup.check_header = header
    else:
        setup.check_header = 1 if (all(t == T_STR for t in first_types) and data_has_num) else -1

    ncols = max(len(r) for r in rows)
    if setup.check_header == 1:
        setup.column_names = [c.strip() or f"C{i+1}" for i, c in enumerate(first)]
        data_rows = rest
    else:
        setup.column_names = [f"C{i+1}" for i in range(ncols)]
        data_rows = rows
    while len(setup.column_names) < ncols:
        setup.column_names.append(f"C{len(setup.column_names)+1}")

    # per-column type vote (ParseSetup type escalation)
    votes = [dict(num=0, time=0, str=0, na=0) for _ in range(ncols)]
    uniq: List[set] = [set() for _ in range(ncols)]
    for r in data_rows:
        for i in range(ncols):
            tok = r[i].strip() if i < len(r) else ""
            t = _classify(tok, setup.na_strings)
            if t == "na":
                votes[i]["na"] += 1
            elif t == T_NUM:
                votes[i]["num"] += 1
            elif t == T_TIME:
                votes[i]["time"] += 1
            else:
                votes[i]["str"] += 1
                if len(uniq[i]) <= 1000:
                    uniq[i].add(tok)
    types = []
    for i in range(ncols):
        v = votes[i]
        total = v["num"] + v["time"] + v["str"]
        if total == 0:
            types.append(T_NUM)
        elif v["str"] > 0:
            # strings present: enum unless huge cardinality relative to sample
            nun = len(uniq[i])
            types.append(T_CAT if nun <= 0.95 * max(v["str"], 1) or nun <= 20 else T_STR)
        elif v["time"] > v["num"]:
            types.append(T_TIME)
        else:
            types.append(T_NUM)
    # user overrides (by name or index)
    if column_types:
        _apply_type_overrides(types, setup.column_names, column_types)
    setup.column_types = types
    return setup


def _apply_type_overrides(types: List[str], names: List[str],
                          column_types: Dict) -> None:
    for k, t in column_types.items():
        t = {"numeric": T_NUM, "real": T_NUM, "int": T_NUM, "enum": T_CAT,
             "factor": T_CAT, "string": T_STR, "time": T_TIME}.get(t, t)
        if isinstance(k, int):
            types[k] = t
        elif k in names:
            types[names.index(k)] = t
