"""Chunked ingest: byte-range parallel parse straight into device columns
(counterpart of h2o3_tpu/ingest/chunked.py).

- **splitter** (`split_file`, the reference's `:214`): one windowed scan
  per file (the newlines in C++, the rest numpy, as the reference)
  finds every record end (a newline with an even count of quote bytes
  before it) and closes a chunk at the first record end past each ~4 MB
  mark, so no quoted newline, CRLF pair or
  multi-byte character is ever split. The scan yields each chunk's row
  count, so every chunk's row offset is known before any parse runs.
- **worker pool**: each chunk parses on a host thread through the port's
  C++ parser (`native.csv_parse`; ctypes drops the GIL for the call).
  Numbers land as float32, enum tokens as int32 codes into a local sorted
  domain, string and time tokens as raw bytes.
- **assembly**: every column is one tensor of the frame's row count,
  allocated before the parse. On the CPU the parser writes numbers and
  codes straight into those tensors at the chunk's row offset. On CUDA it
  writes into a pinned host buffer of the chunk, copied to the column's
  rows with ``non_blocking=True`` on a side stream while later chunks
  parse; each buffer is kept until the event recorded after its copy has
  completed. No whole-column host buffer exists, so
  ``coordinator_ingest_bytes`` stays 0 on this path.
- **two-pass resolution**: enum domains are the sorted union of the
  chunks' local domains, and each chunk's local codes are rewritten into
  it by a gather through a lookup table on the device (the reference's
  `_remap_codes` :401); time columns take the format of the column's
  first non-NA token and convert chunk by chunk (`_resolve_time` :365).
- **streaming append** (`append_csv` :912): a header-less micro-batch
  parses under the frame's schema and parse options; every column grows
  by a ``torch.cat`` (old enum codes renumbered through a permutation
  when new labels grow the sorted domain), and cached rollups merge.

- **row-sharded clouds** (the reference's `_write_rows`,
  `_device_from_shards` and shard geometry, `:442-480`, `:540-680`):
  with a row mesh (parallel/mesh.py) rank r owns rows [lo, hi) of the
  file's rows (`mesh.row_block`). Every rank scans and parses every
  chunk on the host, so enum domains and time formats are the whole
  file's, but only the part of each chunk inside [lo, hi) lands on its
  device: no rank stages another's rows there. In one process [lo, hi)
  is every row.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from h2o3_tpu_torch import native
from h2o3_tpu_torch.core.frame import (NA_CAT, T_CAT, T_INT, T_NUM, T_STR,
                                       T_TIME, Column, code_dtype,
                                       store_numeric, torch_code_dtype,
                                       widen)


class ChunkLayoutError(Exception):
    """A chunk parsed to another row count than the splitter's scan
    promised, or failed to parse (non-RFC quoting, stray quote bytes in
    unquoted fields, ...): the caller falls back to the monolithic path,
    which parses the whole file in one call."""


# -- ingest counters ---------------------------------------------------------

_LOCK = threading.Lock()
_COUNTS = {"chunks": 0, "chunk_rows": 0, "coordinator_ingest_bytes": 0,
           "stream_appends": 0, "stream_rows": 0}
_OVERLAP = 0.0
# seconds by stage of the last chunked import (split, parse, resolve,
# ship, total) and its worker count
last_profile: Dict[str, float] = {}


def _add(key: str, n: int) -> None:
    with _LOCK:
        _COUNTS[key] += int(n)


def note_chunks(n: int) -> None:
    _add("chunks", n)


def note_chunk_rows(n: int) -> None:
    """Rows that entered a frame through the chunked path."""
    _add("chunk_rows", n)


def note_coordinator_bytes(n: int) -> None:
    """Bytes an ingest path staged as a whole-column host buffer (the
    monolithic path, other formats): what the chunked path keeps at 0."""
    _add("coordinator_ingest_bytes", n)


def note_stream_append(rows: int) -> None:
    with _LOCK:
        _COUNTS["stream_appends"] += 1
        _COUNTS["stream_rows"] += int(rows)


def set_overlap_ratio(r: float) -> None:
    global _OVERLAP
    with _LOCK:
        _OVERLAP = float(r)


def counters() -> dict:
    with _LOCK:
        return dict(_COUNTS, overlap_ratio=_OVERLAP)


def reset_counters() -> None:
    global _OVERLAP
    with _LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0
        _OVERLAP = 0.0


# -- knobs (the reference's names and defaults) -------------------------------

def enabled() -> bool:
    """The chunked path's switch (H2O_TPU_INGEST_CHUNKED, default on). Off
    = the monolithic path: the same C++ parser over the whole file."""
    return os.environ.get("H2O_TPU_INGEST_CHUNKED", "1").lower() not in (
        "0", "false", "off")


def chunk_bytes() -> int:
    """Target byte-range size (H2O_TPU_INGEST_CHUNK_BYTES, default 4 MB);
    record alignment may stretch a chunk past it. Clamped to >= 1 KB."""
    try:
        v = int(os.environ.get("H2O_TPU_INGEST_CHUNK_BYTES", str(4 << 20)))
    except ValueError:
        v = 4 << 20
    return max(v, 1024)


def ingest_workers() -> int:
    """Parse threads (H2O_TPU_INGEST_WORKERS, default min(16, cores))."""
    try:
        v = int(os.environ.get("H2O_TPU_INGEST_WORKERS", "0"))
    except ValueError:
        v = 0
    if v <= 0:
        v = min(16, os.cpu_count() or 1)
    return max(v, 1)


def parquet_batch() -> int:
    """Adjacent lazy-parquet columns fetched per first-touch read
    (H2O_TPU_INGEST_PARQUET_BATCH, default 8)."""
    try:
        v = int(os.environ.get("H2O_TPU_INGEST_PARQUET_BATCH", "8"))
    except ValueError:
        v = 8
    return max(v, 1)


# ---------------------------------------------------------------------------
# splitter
# ---------------------------------------------------------------------------

@dataclass
class ByteChunk:
    path: str
    start: int          # byte offset, inclusive
    end: int            # byte offset, exclusive (a record end)
    row_offset: int     # frame row of this chunk's first record
    nrows: int          # non-blank data records inside


# the scan holds one window at a time, never a per-record array
_SCAN_WINDOW = 64 << 20


def split_file(path: str, setup, cbytes: int
               ) -> Tuple[List[Tuple[int, int, int]], int]:
    """-> ([(start, end, nrows)...], total_data_rows) for one CSV file.

    One pass in fixed byte windows: per window, the newlines with an even
    count of quote bytes before them (a running carry tracks the parity
    across windows) end records; blank records (empty, or a lone ``\\r``)
    are not rows; every chunk whose byte target lands in the window
    closes at the next record end, and a span of blank records folds into
    its neighbour."""
    size = os.path.getsize(path)
    if size == 0:
        return [], 0
    quote_char = getattr(setup, "quote_char", '"')
    q = ord(quote_char) if quote_char else 0
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    try:
        header_done = setup.check_header != 1
        chunks: List[Tuple[int, int, int]] = []
        pos: Optional[int] = 0 if header_done else None  # open chunk start
        pending = 0        # data rows in the open chunk from prior windows
        total = 0
        prev_end = 0       # start byte of the next record
        carry = 0          # quote bytes seen before this window
        for base in range(0, size, _SCAN_WINDOW):
            win = mm[base:base + _SCAN_WINDOW]
            # the quote-parity-even newlines, scanned in C++
            nl, nq = native.record_ends(int(mm.ctypes.data) + base, len(win),
                                        q if q else -1, carry & 1)
            carry += nq
            ends_w = nl + base + 1
            has_nl = np.ones(len(ends_w), bool)
            if base + len(win) >= size and \
                    (len(ends_w) == 0 or int(ends_w[-1]) != size):
                # unterminated tail record ends at EOF
                ends_w = np.append(ends_w, np.int64(size))
                has_nl = np.append(has_nl, False)
            if len(ends_w) == 0:
                continue
            starts_w = np.empty(len(ends_w), np.int64)
            starts_w[0] = prev_end
            starts_w[1:] = ends_w[:-1]
            prev_end = int(ends_w[-1])
            content = ends_w - starts_w - has_nl
            first_byte = np.asarray(mm[np.minimum(starts_w, size - 1)])
            blank_w = (content == 0) | ((content == 1)
                                        & (first_byte == 0x0D))
            if not header_done:
                nb = np.flatnonzero(~blank_w)
                if len(nb) == 0:
                    continue           # header record not in this window
                h = int(nb[0])
                header_done = True
                pos = int(ends_w[h])   # data starts after the header
                ends_w = ends_w[h + 1:]
                blank_w = blank_w[h + 1:]
                if len(ends_w) == 0:
                    continue
            data_ends_w = ends_w[~blank_w]
            total += int(len(data_ends_w))
            while True:
                target = pos + cbytes
                if target > int(ends_w[-1]):
                    break
                i = int(np.searchsorted(ends_w, target))
                end = int(ends_w[i])
                nr = pending + int(
                    np.searchsorted(data_ends_w, end, side="right")
                    - np.searchsorted(data_ends_w, pos, side="right"))
                pending = 0
                if nr > 0:
                    chunks.append((pos, end, nr))
                elif chunks:
                    s0, _e0, n0 = chunks[-1]
                    chunks[-1] = (s0, end, n0)
                pos = end
            pending += int(len(data_ends_w)
                           - np.searchsorted(data_ends_w, pos,
                                             side="right"))
        if total == 0:
            return [], 0
        if pos is not None and pos < prev_end:
            if pending > 0:
                chunks.append((pos, prev_end, pending))
            elif chunks:
                s0, _e0, n0 = chunks[-1]
                chunks[-1] = (s0, prev_end, n0)
        return chunks, total
    finally:
        del mm


# ---------------------------------------------------------------------------
# host parse of one buffer (monolithic path, stream batches)
# ---------------------------------------------------------------------------

def column_kinds(types: Sequence[str]) -> List[int]:
    """The parser's kind per column: numbers for real/int, codes for
    enum, raw tokens for string/time (the reference's read_csv dtypes)."""
    out = []
    for t in types:
        if t in (T_NUM, T_INT):
            out.append(native.KIND_NUM)
        elif t == T_CAT:
            out.append(native.KIND_CAT)
        elif t in (T_STR, T_TIME):
            out.append(native.KIND_RAW)
        else:
            raise ValueError(f"CSV columns cannot be of type {t!r}")
    return out


def decode_tokens(raw, offs, na) -> np.ndarray:
    """Raw string tokens -> object array of str, None where NA."""
    b = raw.tobytes()
    out = np.empty(len(offs) - 1, object)
    for i in range(len(out)):
        out[i] = None if na[i] else b[offs[i]:offs[i + 1]].decode("utf-8")
    return out


# tokens pandas skips when it picks the token to infer a format from
_NAT_STRINGS = {b"NaT", b"nat", b"NAT", b"nan", b"NaN", b"NAN"}


def first_time_token(parts) -> Optional[bytes]:
    """The first non-NA token of a time column's (raw, offs, na) parts in
    row order, or None."""
    for raw, offs, na in parts:
        for i in np.flatnonzero(na == 0):
            tok = raw[offs[i]:offs[i + 1]].tobytes()
            if tok and tok not in _NAT_STRINGS:
                return tok
    return None


def resolve_times(parts) -> List[np.ndarray]:
    """float64 epoch-ms of a time column's parts, the format inferred from
    the column's first non-NA token (the reference's one pd.to_datetime
    over the whole column); when that token is no valid time, each token
    is read in its own shape (-2), as pandas then does."""
    tok = first_time_token(parts)
    fmt = -1 if tok is None else native.time_format(tok)
    if tok is not None and fmt < 0:
        fmt = -2
    return [native.parse_times(raw, offs, na, fmt) for raw, offs, na in parts]


def parse_buffer(address: int, length: int, setup, skip_header: bool
                 ) -> Tuple[int, Dict[str, tuple]]:
    """Parse a whole in-memory CSV text into host columns. Returns
    (rows, {name: value}) with value ("num", float32 array),
    ("cat", domain, int32 codes), ("str", object array) or ("time",
    float64 epoch-ms array); raises ValueError when the text does not
    parse under the setup."""
    from h2o3_tpu_torch.ingest.parser import csv_spec

    kinds = column_kinds(setup.column_types)
    common = dict(sep=setup.separator, quote=setup.quote_char or '"',
                  skip_header=skip_header, kinds=kinds, na=csv_spec(setup))
    counted = native.csv_parse(address, length, count_only=True, **common)
    if counted.error:
        raise ValueError(f"CSV parse failed: {counted.error}")
    n = counted.rows
    counted.free()
    bufs = {i: np.empty(max(n, 1), np.float32 if k == native.KIND_NUM
                        else np.int32)
            for i, k in enumerate(kinds) if k != native.KIND_RAW}
    ptr = {i: int(b.ctypes.data) for i, b in bufs.items()}
    res = native.csv_parse(
        address, length, cap=n,
        num_ptrs=[ptr.get(i, 0) if k == native.KIND_NUM else 0
                  for i, k in enumerate(kinds)],
        code_ptrs=[ptr.get(i, 0) if k == native.KIND_CAT else 0
                   for i, k in enumerate(kinds)], **common)
    try:
        if res.error:
            raise ValueError(f"CSV parse failed: {res.error}")
        if res.rows != n:
            raise ValueError(f"CSV parse found {res.rows} records, its "
                             f"count pass {n}")
        out: Dict[str, tuple] = {}
        for i, (name, t) in enumerate(zip(setup.column_names,
                                          setup.column_types)):
            if kinds[i] == native.KIND_NUM:
                out[name] = ("num", bufs[i][:n])
            elif kinds[i] == native.KIND_CAT:
                out[name] = ("cat", res.domain(i), bufs[i][:n])
            elif t == T_STR:
                out[name] = ("str", decode_tokens(*res.tokens(i)))
            else:
                out[name] = ("time", resolve_times([res.tokens(i)])[0])
        return n, out
    finally:
        res.free()


def parse_text(text: str, setup):
    """`parse_buffer` over a header-less str (a stream batch)."""
    buf = np.frombuffer(text.encode("utf-8"), np.uint8)
    return parse_buffer(int(buf.ctypes.data) if len(buf) else 0, len(buf),
                        setup, skip_header=False)


# ---------------------------------------------------------------------------
# domain resolution
# ---------------------------------------------------------------------------

def remap_lut(gdom: List[str], dom: List[str]) -> np.ndarray:
    """Local codes -> global codes of a chunk, with one extra slot (the
    last) that maps NA (-1) to NA."""
    lut = np.full(len(dom) + 1, NA_CAT, np.int32)
    if dom:
        lut[:-1] = np.searchsorted(np.asarray(gdom, object),
                                   np.asarray(dom, object))
    return lut


def remap_codes(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Gather local int32 codes through `lut` (NA -> the last slot)."""
    idx = codes.long()
    idx = torch.where(idx < 0, lut.shape[0] - 1, idx)
    return lut[idx]


def grow_domain(old_dom: List[str], bdom: List[str], bcodes: np.ndarray
                ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Streaming-append domain resolution: -> (new sorted domain, batch
    codes in it, the lookup table of old codes into it, see remap_lut).
    Keeping the domain sorted makes an appended frame equal a cold parse
    of the concatenated data (the reference's `_grow_domain` :413)."""
    new_dom = sorted(set(old_dom) | set(bdom))
    lut = remap_lut(new_dom, bdom)
    new_codes = lut[np.where(bcodes < 0, len(bdom), bcodes)]
    return new_dom, new_codes, remap_lut(new_dom, old_dom)


# ---------------------------------------------------------------------------
# the chunked pipeline
# ---------------------------------------------------------------------------

def eligible(paths: Sequence[str], setup) -> bool:
    """The chunked path needs uncompressed local CSV files and a resolved
    schema; anything else takes the monolithic path."""
    if not enabled() or setup.parse_type != "CSV":
        return False
    if not setup.column_names or \
            len(setup.column_names) != len(setup.column_types):
        return False
    return all(not p.endswith((".gz", ".zip")) and os.path.isfile(p)
               for p in paths)


class _Sink:
    """Where chunk outputs land. On the CPU: straight into the column
    tensors at the chunk's rows. On CUDA: a pinned buffer per chunk,
    copied on a side stream, kept until its copy's event completes."""

    def __init__(self, device, total, num_idx, cat_idx, rows=None):
        self.device = device
        self.cuda = device.type == "cuda"
        # the rows this process keeps (a rank's block); anything else is
        # parsed into a staging buffer and dropped
        self.lo, self.hi = rows if rows is not None else (0, total)
        self.staged = self.cuda or (self.lo, self.hi) != (0, total)
        local = self.hi - self.lo
        self.num = {i: torch.empty(local, dtype=torch.float32, device=device)
                    for i in num_idx}
        # local (per-chunk) enum codes, remapped after the parse
        self.codes = {i: torch.empty(local, dtype=torch.int32, device=device)
                      for i in cat_idx}
        self.num_idx, self.cat_idx = list(num_idx), list(cat_idx)
        self.stream = None
        self.inflight: List[tuple] = []
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            # the columns' memory may have been in use on the current stream
            self.stream.wait_stream(torch.cuda.current_stream(device))

    def buffers(self, c: ByteChunk):
        """-> (staging or None, {col: float ptr}, {col: int32 ptr})."""
        n = c.nrows
        if not self.staged:
            return (None,
                    {i: t.data_ptr() + 4 * c.row_offset
                     for i, t in self.num.items()},
                    {i: t.data_ptr() + 4 * c.row_offset
                     for i, t in self.codes.items()})
        stage_n = torch.empty((len(self.num_idx), n), dtype=torch.float32,
                              pin_memory=self.cuda)
        stage_c = torch.empty((len(self.cat_idx), n), dtype=torch.int32,
                              pin_memory=self.cuda)
        return ((stage_n, stage_c),
                {i: stage_n[j].data_ptr() for j, i in
                 enumerate(self.num_idx)},
                {i: stage_c[j].data_ptr() for j, i in
                 enumerate(self.cat_idx)})

    def overlap(self, off: int, n: int):
        """The kept part of global rows [off, off + n): (source start,
        destination start, length), or None."""
        a, b = max(off, self.lo), min(off + n, self.hi)
        return None if b <= a else (a - off, a - self.lo, b - a)

    def land(self, c: ByteChunk, staging) -> None:
        """Copy the kept rows of a parsed chunk's staging buffers."""
        if staging is None:
            return
        ov = self.overlap(c.row_offset, c.nrows)
        if ov is None:
            return
        s0, d0, m = ov
        stage_n, stage_c = staging
        with (torch.cuda.stream(self.stream) if self.cuda
              else contextlib.nullcontext()):
            for j, i in enumerate(self.num_idx):
                self.num[i][d0:d0 + m].copy_(stage_n[j][s0:s0 + m],
                                             non_blocking=self.cuda)
            for j, i in enumerate(self.cat_idx):
                self.codes[i][d0:d0 + m].copy_(stage_c[j][s0:s0 + m],
                                               non_blocking=self.cuda)
            if self.cuda:
                ev = torch.cuda.Event()
                ev.record(self.stream)
        if self.cuda:
            self.inflight.append((ev, staging))
            # release the buffers whose copies have completed
            self.inflight = [(e, s) for e, s in self.inflight
                             if not e.query()]

    def put(self, col: Dict[int, torch.Tensor], i: int, lo: int,
            host: np.ndarray) -> None:
        """Copy the kept rows of a host array of global rows [lo, lo +
        len) into a column."""
        ov = self.overlap(lo, len(host))
        if ov is None:
            return
        s0, lo, m = ov
        src = torch.from_numpy(np.ascontiguousarray(host[s0:s0 + m]))
        if self.cuda:
            src = src.pin_memory()
            with torch.cuda.stream(self.stream):
                col[i][lo:lo + m].copy_(src, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.stream)
            self.inflight.append((ev, src))
        else:
            col[i][lo:lo + m].copy_(src)

    def finish(self) -> None:
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
            for ev, _ in self.inflight:
                ev.synchronize()
            self.inflight = []


def parse_csv_sharded(paths: Sequence[str], setup, device=None
                      ) -> Optional[Dict[str, Column]]:
    """Split -> pooled chunk parse -> domain and time resolution, the rows
    landing in one tensor per column on `device` (default: the
    runtime's). Returns {name: Column} in setup order, or None when the
    input is ineligible or empty. Raises ChunkLayoutError when a chunk
    contradicts the splitter's scan (the caller falls back)."""
    from concurrent.futures import ThreadPoolExecutor, as_completed

    from h2o3_tpu_torch.core.frame import _device
    from h2o3_tpu_torch.ingest.parser import csv_spec

    if not eligible(paths, setup):
        return None
    names, types = list(setup.column_names), list(setup.column_types)
    kinds = column_kinds(types)
    cbytes = chunk_bytes()

    from h2o3_tpu_torch.obs import metrics as obs_metrics

    t_wall0 = time.perf_counter()
    ms0 = time.time() * 1000.0 - t_wall0 * 1000.0   # perf -> wall ms
    chunks: List[ByteChunk] = []
    total = 0
    for p in paths:
        ch, rows = split_file(p, setup, cbytes)
        off = total
        for (s, e, nr) in ch:
            chunks.append(ByteChunk(p, s, e, off, nr))
            off += nr
        total += rows
    t_split = time.perf_counter() - t_wall0
    if total == 0:
        return None

    dev = _device(device)
    spec = csv_spec(setup)
    num_idx = [i for i, k in enumerate(kinds) if k == native.KIND_NUM]
    cat_idx = [i for i, k in enumerate(kinds) if k == native.KIND_CAT]
    raw_idx = [i for i, k in enumerate(kinds) if k == native.KIND_RAW]
    from h2o3_tpu_torch.parallel import mesh

    m = mesh.current()
    lo, hi = m.rows(total) if m is not None else (0, total)
    local = hi - lo
    sink = _Sink(dev, total, num_idx, cat_idx, rows=(lo, hi))
    maps = {p: np.memmap(p, dtype=np.uint8, mode="r")
            for p in dict.fromkeys(c.path for c in chunks)}
    common = dict(sep=setup.separator, quote=setup.quote_char or '"',
                  skip_header=False, kinds=kinds, na=spec)

    def work(c: ByteChunk):
        t0 = time.perf_counter()
        staging, nptr, cptr = sink.buffers(c)
        res = native.csv_parse(
            int(maps[c.path].ctypes.data) + c.start, c.end - c.start,
            cap=c.nrows,
            num_ptrs=[nptr.get(i, 0) for i in range(len(kinds))],
            code_ptrs=[cptr.get(i, 0) for i in range(len(kinds))], **common)
        try:
            if res.error:
                raise ChunkLayoutError(
                    f"{c.path}[{c.start}:{c.end}] failed to parse as a "
                    f"record-aligned chunk ({res.error}); falling back to "
                    f"the monolithic path")
            if res.rows != c.nrows:
                raise ChunkLayoutError(
                    f"{c.path}[{c.start}:{c.end}] parsed {res.rows} rows, "
                    f"the splitter promised {c.nrows} (non-RFC quoting?); "
                    f"falling back to the monolithic path")
            doms = {i: res.domain(i) for i in cat_idx}
            raws = {i: res.tokens(i) for i in raw_idx}
        finally:
            res.free()
        return staging, doms, raws, time.perf_counter() - t0

    cat_doms: Dict[int, list] = {i: [] for i in cat_idx}
    raw_parts: Dict[int, list] = {i: [] for i in raw_idx}
    t_parse_serial = 0.0
    t1 = time.perf_counter()
    workers = min(ingest_workers(), max(len(chunks), 1))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs = {pool.submit(work, c): c for c in chunks}
        try:
            for fut in as_completed(futs):
                c = futs[fut]
                staging, doms, raws, dt = fut.result()
                t_parse_serial += dt
                obs_metrics.observe("h2o3_ingest_parse_seconds", dt)
                sink.land(c, staging)
                for i in cat_idx:
                    cat_doms[i].append((c.row_offset, c.nrows, doms[i]))
                for i in raw_idx:
                    raw_parts[i].append((c.row_offset, raws[i]))
        except ChunkLayoutError:
            pool.shutdown(wait=False, cancel_futures=True)
            sink.finish()
            raise
    t_parse = time.perf_counter() - t1

    t2 = time.perf_counter()
    out: Dict[str, Column] = {}
    for i in cat_idx:
        parts = sorted(cat_doms[i], key=lambda p: p[0])
        gdom = sorted(set().union(*(d for _o, _n, d in parts)))
        cdt = torch_code_dtype(len(gdom))
        codes = torch.empty(local, dtype=cdt, device=dev)
        with (torch.cuda.stream(sink.stream) if sink.cuda
              else contextlib.nullcontext()):
            for off, n, dom in parts:
                ov = sink.overlap(off, n)
                if ov is None:
                    continue
                _s0, d0, k = ov
                lut = torch.from_numpy(remap_lut(gdom, dom)).to(dev)
                codes[d0:d0 + k] = remap_codes(
                    lut, sink.codes[i][d0:d0 + k]).to(cdt)
        out[names[i]] = Column(codes, T_CAT, total, domain=gdom)
    times = {}
    for i in raw_idx:
        parts = sorted(raw_parts[i], key=lambda p: p[0])
        if types[i] == T_TIME:
            col = {i: torch.empty(local, dtype=torch.float32, device=dev)}
            ms = resolve_times([r for _o, r in parts])
            for (off, _r), m in zip(parts, ms):
                sink.put(col, i, off, m.astype(np.float32))
            times[i] = col[i]
        else:
            obj = np.empty(local, object)
            for off, r in parts:
                dec = decode_tokens(*r)
                ov = sink.overlap(off, len(dec))
                if ov is not None:
                    s0, d0, k = ov
                    obj[d0:d0 + k] = dec[s0:s0 + k]
            out[names[i]] = Column(None, T_STR, total, host_data=obj)
    t_resolve = time.perf_counter() - t2

    t3 = time.perf_counter()
    sink.finish()
    for i in num_idx:
        out[names[i]] = Column(store_numeric(sink.num[i], T_NUM), T_NUM,
                               total)
    for i, data in times.items():
        out[names[i]] = Column(data, T_TIME, total)
    t_ship = time.perf_counter() - t3
    t_total = time.perf_counter() - t_wall0
    del maps

    _ingest_spans(ms0, [
        ("ingest_split", t_wall0, t_split, {"files": len(paths)}),
        ("ingest_parse", t1, t_parse, {"chunks": len(chunks),
                                       "rows": total}),
        ("ingest_resolve", t2, t_resolve, {"cats": len(cat_idx),
                                           "times": len(times)}),
        ("ingest_ship", t3, t_ship, {"columns": len(names),
                                     "rows": total})])
    note_chunks(len(chunks))
    note_chunk_rows(total)
    serial = t_split + t_parse_serial + t_resolve + t_ship
    set_overlap_ratio(min(max(1.0 - t_total / max(serial, 1e-9), 0.0), 1.0))
    last_profile.clear()
    last_profile.update(split_s=t_split, parse_s=t_parse,
                        parse_cpu_s=t_parse_serial, resolve_s=t_resolve,
                        ship_s=t_ship, total_s=t_total, chunks=len(chunks),
                        workers=workers)
    return {nm: out[nm] for nm in names}


# ---------------------------------------------------------------------------
# streaming append
# ---------------------------------------------------------------------------

def _merge_rollups(old, batch: np.ndarray, is_cat: bool):
    """Incremental rollup fold: a column's cached Rollups combined with the
    micro-batch's host stats (the reference's `_merge_rollups` :757), so
    an append never re-reduces the whole column."""
    from h2o3_tpu_torch.ops.rollups import Rollups

    if is_cat:
        valid = batch >= 0
        x = batch[valid].astype(np.float32)
    else:
        valid = ~np.isnan(batch)
        x = batch[valid].astype(np.float32)
    n2 = int(valid.sum())
    na2 = int(len(batch) - n2)
    nz2 = int((x != 0).sum())
    rows = old.rows + n2
    na = old.na_count + na2
    nz = old.nz_count + nz2
    if n2 == 0:
        return Rollups(old.min, old.max, old.mean, old.sigma, na, nz, rows)
    s2 = float(np.sum(x, dtype=np.float32))
    ss2 = float(np.sum(x * x, dtype=np.float32))
    mn2, mx2 = float(x.min()), float(x.max())
    if old.rows == 0:
        mean = s2 / n2
        var = max(ss2 / n2 - mean * mean, 0.0)
        sigma = float(np.sqrt(var * n2 / (n2 - 1))) if n2 > 1 else 0.0
        return Rollups(mn2, mx2, mean, sigma, na, nz, rows)
    s1 = old.mean * old.rows
    var1 = (old.sigma ** 2) * (old.rows - 1) / old.rows \
        if old.rows > 1 else 0.0
    ss1 = (var1 + old.mean ** 2) * old.rows
    mean = (s1 + s2) / rows
    var = max((ss1 + ss2) / rows - mean * mean, 0.0)
    sigma = float(np.sqrt(var * rows / (rows - 1))) if rows > 1 else 0.0
    return Rollups(min(old.min, mn2), max(old.max, mx2), mean, sigma, na,
                   nz, rows)


def stream_separator(frame, separator: Optional[str] = None) -> str:
    """A micro-batch's separator: the argument, else the one the frame was
    imported with, else ','."""
    opts = getattr(frame, "_parse_opts", None) or {}
    return separator or opts.get("separator") or ","


def _stream_setup(frame, separator: Optional[str] = None):
    """ParseSetup of a micro-batch: the frame's schema plus the parse
    options it was imported with (`parser.parse` keeps them as
    ``frame._parse_opts``)."""
    from h2o3_tpu_torch.ingest.parse_setup import ParseSetup

    names = frame.names
    for n in names:
        c = frame.col(n)
        if c.ctype == T_CAT and c.domain is None:
            raise ValueError(
                f"cannot stream-append: column {n!r} is categorical with "
                f"no domain (integer-coded); batch labels cannot be "
                f"resolved against it")
    setup = ParseSetup(separator=stream_separator(frame, separator),
                       check_header=-1, column_names=list(names),
                       column_types=[frame.col(n).ctype for n in names])
    opts = getattr(frame, "_parse_opts", None) or {}
    if opts.get("na_strings"):
        setup.na_strings = list(opts["na_strings"])
    if opts.get("quote_char"):
        setup.quote_char = opts["quote_char"]
    return setup


def _check_arity(text: str, setup) -> None:
    """Every record must carry exactly the frame's column count: a stray
    delimiter must be a clean error, never a shifted or NA-filled row."""
    import csv
    import io

    ncols = len(setup.column_names)
    rdr = csv.reader(io.StringIO(text), delimiter=setup.separator,
                     quotechar=setup.quote_char or '"',
                     skipinitialspace=True)
    if csv.field_size_limit() < (64 << 20):
        csv.field_size_limit(64 << 20)
    try:
        for i, row in enumerate(rdr):
            if not row:
                continue                # blank line
            if len(row) != ncols:
                raise ValueError(
                    f"stream batch row {i + 1} has {len(row)} fields but "
                    f"the frame has {ncols} columns (rows must be "
                    f"header-less, columns in frame order)")
    except csv.Error as e:
        raise ValueError(f"stream batch failed the CSV field scan: {e}") \
            from e


def _parse_batch(frame, text: str, separator: Optional[str]):
    setup = _stream_setup(frame, separator)
    _check_arity(text, setup)
    data = text if text.endswith("\n") else text + "\n"
    try:
        return parse_text(data, setup)
    except ValueError as e:
        raise ValueError(f"batch does not parse under the frame's schema "
                         f"({e})") from e


def validate_batch(frame, text: str,
                   separator: Optional[str] = None) -> None:
    """Check a micro-batch before any mutation: arity per record, then a
    full parse under the frame's schema. Raises ValueError."""
    _parse_batch(frame, text, separator)


def _extend_time_host(old: np.ndarray, batch_ms: np.ndarray) -> np.ndarray:
    """Grow a time column's exact epoch-millis host copy (kept for
    datetime/int-sourced frames); NaN batch entries land NaT."""
    old_dt = (old.astype("datetime64[ms]") if old.dtype.kind == "M"
              else old.astype(np.int64).astype("datetime64[ms]"))
    b = np.full(len(batch_ms), np.datetime64("NaT"), "datetime64[ms]")
    ok = ~np.isnan(batch_ms.astype(np.float64))
    b[ok] = batch_ms[ok].astype(np.int64).astype("datetime64[ms]")
    return np.concatenate([old_dt, b])


_APPEND_LOCK = threading.Lock()


def append_csv(frame, text: str, separator: Optional[str] = None) -> int:
    """Stream-append a CSV micro-batch (rows only, no header, columns in
    frame order): every column grows by one ``torch.cat`` on its device,
    enum domains stay sorted (old codes renumbered when new labels arrive,
    so the frame equals a cold parse of the concatenated data), and cached
    rollups merge. Time tokens take the format of the batch's first
    non-NA token. Returns the number of appended rows.

    On a row-sharded frame every rank parses the whole batch (so enum
    domains grow alike on every rank), keeps the batch rows that fall in
    its block of the longer frame, and the rows the shifted block
    boundaries move go through the row exchange (`place_rows`); the
    cached rollups are the cloud's and merge as one process's do."""
    with _frame_lock(frame):
        return _append_csv_locked(frame, text, separator)


def _frame_lock(frame) -> threading.Lock:
    """The lock that serialises appends to `frame` (appends to other
    frames, a row mesh's ranks among them, go on meanwhile)."""
    with _APPEND_LOCK:
        lk = getattr(frame, "_append_lock", None)
        if lk is None:
            lk = frame._append_lock = threading.Lock()
        return lk


def _ingest_spans(ms0: float, phases) -> None:
    """The chunked parse's phases as child spans of the active trace,
    from the perf-counter stamps the parse already takes (no span is
    held open across the worker pool)."""
    from h2o3_tpu_torch.obs import tracing

    ctx = tracing.context()
    if ctx is None:
        return
    for name, t0, dt, attrs in phases:
        start = ms0 + t0 * 1000.0
        tracing.record_span(name, ctx, start, start + dt * 1000.0, **attrs)


def _append_csv_locked(frame, text: str, separator: Optional[str]) -> int:
    from h2o3_tpu_torch.obs import tracing

    names = frame.names
    if not names:
        raise ValueError("cannot stream-append to an empty frame")
    b, batch = _parse_batch(frame, text, separator)
    if b == 0:
        return 0
    with tracing.span("ingest_stream_append", rows=b,
                      total=frame.nrows + b):
        return _append_rows(frame, names, b, batch)


def _append_rows(frame, names, b: int, batch) -> int:
    from h2o3_tpu_torch.core import sharded_frame as SF

    n = frame.nrows
    new_n = n + b
    mesh = SF.sharded_mesh(frame)
    # the batch rows this process adds: all of them, or on a mesh those
    # of its block of the longer frame
    lo, hi = (0, b) if mesh is None else (
        min(max(r - n, 0), b) for r in mesh.rows(new_n))
    parts = []
    for nm in names:
        c = frame.col(nm)
        k = c.local_rows
        rollups = c._rollups
        stats = None
        val = batch[nm]
        data = host = None
        dom = None
        if c.ctype == T_STR:
            host = np.empty(k + hi - lo, object)
            host[:k] = c.host_data[:k]
            host[k:] = val[1][lo:hi]
        elif c.ctype == T_CAT:
            old_dom = list(c.domain or [])
            dom, bcodes, old_lut = grow_domain(old_dom, val[1], val[2])
            old = c.data
            cdt = torch_code_dtype(len(dom))
            if dom != old_dom:
                old = remap_codes(torch.from_numpy(old_lut).to(old.device),
                                  old)
                rollups = None      # stats over renumbered codes are stale
            data = torch.cat([old.to(cdt), torch.from_numpy(
                bcodes[lo:hi]).to(old.device, cdt)])
            stats = bcodes
        else:
            old = c.data
            # the batch in the column's storage dtype; the merged stats
            # describe those stored values, as a recompute would
            bnew = torch.from_numpy(val[1].astype(np.float32)).to(
                old.device, old.dtype)
            data = torch.cat([old, bnew[lo:hi]])
            stats = widen(bnew).cpu().numpy()
            if c.ctype == T_TIME and c.host_data is not None and \
                    c.host_data.dtype.kind in "Mi":
                host = _extend_time_host(c.host_data[:k], val[1][lo:hi])
        parts.append((nm, c.ctype, data, host, dom or c.domain, rollups,
                      stats))
    if mesh is not None:
        flo = frame.shard[0]
        dev = next((d.device for _n, _t, d, *_ in parts if d is not None),
                   torch.device("cpu"))
        pos = torch.cat([torch.arange(flo, flo + frame.local_rows),
                         torch.arange(n + lo, n + hi)]).to(dev)
        ts, hs = SF.place_rows(mesh, pos, new_n,
                               [d for _n, _t, d, *_ in parts if d is not None],
                               [h for _n, _t, _d, h, *_ in parts
                                if h is not None])
        it, ih = iter(ts), iter(hs)
        parts = [(nm, ct, next(it) if d is not None else None,
                  next(ih) if h is not None else None, dm, ru, st)
                 for nm, ct, d, h, dm, ru, st in parts]
    new_cols: Dict[str, Column] = {}
    for nm, ctype, data, host, dom, rollups, stats in parts:
        newc = Column(data, ctype, new_n, domain=dom, host_data=host)
        if rollups is not None and stats is not None:
            newc._rollups = _merge_rollups(rollups, stats, ctype == T_CAT)
        new_cols[nm] = newc
    frame.swap_columns(new_cols)
    note_stream_append(b)
    return b


def times_from_strings(values) -> np.ndarray:
    """float64 epoch-ms of a sequence of str (None = NA), the format taken
    from the first non-NA value, as the CSV time columns resolve."""
    enc = [b"" if v is None else str(v).encode("utf-8") for v in values]
    na = np.array([v is None for v in values], np.uint8)
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    raw = np.frombuffer(b"".join(enc) or b"\0", np.uint8)
    return resolve_times([(raw, offs, na)])[0]
