"""The port's chunked ingest (h2o3_tpu_torch/ingest/chunked.py): chunk
edges, the chunked path against the monolithic path and against the JAX
package, the zero-coordinator-bytes contract, and streaming append.
Mirrors tests/test_ingest_chunked.py (REST and multi-process cases
excepted: the port has neither yet). Every comparison is bitwise
(tests/torch_port_support.py)."""

import gzip

import numpy as np
import pytest

import h2o3_tpu_torch as th

from torch_port_support import (assert_bitwise, assert_frames_match,
                                frames_bitwise)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    th.init(device="cpu")
    # the reference's numeric-only native parser reads blank lines as NaN
    # rows where pandas skips them; hold the port to pandas
    from h2o3_tpu.native import loader

    monkeypatch.setattr(loader, "native_parse_csv", lambda *a, **k: None)


def _env(monkeypatch, **kw):
    for k, v in kw.items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, str(v))


def _nasty_csv(path, n=240, seed=0):
    """The reference's fixture: quoted embedded newlines and CRLFs, commas,
    doubled quotes, quoted empty strings, multi-byte UTF-8, CRLF endings
    for half the file, blank lines and no final newline."""
    rng = np.random.default_rng(seed)
    motifs = ['plain', '"with,comma"', '"multi\nline"', '"crlf\r\nfield"',
              '"héllo🎉"', '"dbl""quote"', '""', '"日本語テキスト"']
    rows = []
    for i in range(n):
        v = "" if i % 17 == 0 else f"{rng.normal():.6g}"
        rows.append(f"{i},{motifs[i % len(motifs)]},{v}")
    body = ("id,txt,val\n" + "\r\n".join(rows[: n // 2]) + "\n"
            + "\n\n".join(rows[n // 2:]))
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write(body)
    return str(path)


def test_randomized_split_points_bitwise(cl, tmp_path, monkeypatch):
    """A sweep of chunk sizes puts edges into quoted newlines, CRLF pairs
    and multi-byte characters: every chunked import equals the
    monolithic one and the reference's, and stages no whole column."""
    import h2o3_tpu
    from h2o3_tpu_torch.ingest import chunked

    p = _nasty_csv(tmp_path / "nasty.csv")
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=0)
    ref = th.import_file(p)
    jref = h2o3_tpu.import_file(p)
    assert_frames_match(jref, ref)
    rng = np.random.default_rng(1234)
    for cb in [1024, 1031] + [int(s) for s in rng.integers(1024, 6000, 6)]:
        _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=1,
             H2O_TPU_INGEST_CHUNK_BYTES=cb)
        before = chunked.counters()
        fr = th.import_file(p)
        after = chunked.counters()
        frames_bitwise(ref, fr, f"chunk_bytes={cb}")
        assert after["chunks"] - before["chunks"] >= 2
        assert after["chunk_rows"] - before["chunk_rows"] == fr.nrows
        assert after["coordinator_ingest_bytes"] == \
            before["coordinator_ingest_bytes"], cb


def test_many_workers_many_chunks_stress(cl, tmp_path, monkeypatch):
    """More parse threads than cores over ~100 chunks, with a short
    switch interval: every chunk's rows land at their own offsets (the
    pool writes disjoint slices of shared columns), so the frame equals
    the one-call parse bit for bit, with every enum level resolved."""
    import sys
    import time

    rng = np.random.default_rng(9)
    n = 6000
    p = tmp_path / "stress.csv"
    p.write_text("x,g,s\n" + "".join(
        f"{rng.normal():.7g},{'abcdefghij'[i % 10]}{i % 13},\"q{i}\"\n"
        for i in range(n)))
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=0)
    ref = th.import_file(str(p), col_types={"s": "string"})
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=1,
         H2O_TPU_INGEST_CHUNK_BYTES=1024, H2O_TPU_INGEST_WORKERS=32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t0 = time.perf_counter()
        for _ in range(3):
            fr = th.import_file(str(p), col_types={"s": "string"})
            frames_bitwise(ref, fr)
        assert time.perf_counter() - t0 < 120
    finally:
        sys.setswitchinterval(old)
    assert len(fr.col("g").domain) == 130


def test_splitter_matches_the_reference_and_cuts_on_record_ends(cl,
                                                                tmp_path):
    from h2o3_tpu.ingest.chunked import split_file as jsplit
    from h2o3_tpu.ingest.parse_setup import ParseSetup as JSetup
    from h2o3_tpu_torch.ingest.chunked import split_file
    from h2o3_tpu_torch.ingest.parse_setup import ParseSetup

    p = tmp_path / "quoted.csv"
    rows = [f'{i},"line\nbreak {i}"' for i in range(50)]
    text = "a,b\n" + "\n".join(rows) + "\n"
    p.write_text(text)
    kw = dict(column_names=["a", "b"], column_types=["real", "enum"])
    chunks, total = split_file(str(p), ParseSetup(**kw), 256)
    assert (chunks, total) == jsplit(str(p), JSetup(**kw), 256)
    assert total == 50 and len(chunks) >= 2
    raw = text.encode()
    pos = chunks[0][0]
    for (s, e, _nr) in chunks:
        assert s == pos
        pos = e
        assert e == len(raw) or raw[e - 1:e] == b"\n"
        assert raw[:e].count(b'"') % 2 == 0


@pytest.mark.parametrize("seed", range(4))
def test_splitter_equals_the_reference_on_random_text(cl, tmp_path,
                                                      monkeypatch, seed):
    """Random bytes over newlines, CRs, quotes and separators, every
    header mode, chunk size and scan window: the port's splitter (its
    newline scan in C++) gives the reference's chunks."""
    from h2o3_tpu.ingest import chunked as jchunked
    from h2o3_tpu.ingest.parse_setup import ParseSetup as JSetup
    from h2o3_tpu_torch.ingest import chunked
    from h2o3_tpu_torch.ingest.parse_setup import ParseSetup

    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b'ab1,,"\n\n\n\r ', np.uint8)
    p = tmp_path / "r.csv"
    p.write_bytes(rng.choice(alphabet, 6000).tobytes())
    for header in (1, -1):
        kw = dict(check_header=header, column_names=["a"],
                  column_types=["real"])
        for window in (7, 1000, 1 << 20):
            monkeypatch.setattr(chunked, "_SCAN_WINDOW", window)
            monkeypatch.setattr(jchunked, "_SCAN_WINDOW", window)
            for cb in (64, 700):
                assert chunked.split_file(str(p), ParseSetup(**kw), cb) == \
                    jchunked.split_file(str(p), JSetup(**kw), cb), \
                    (header, window, cb)


def test_windowed_scan_carries_quote_parity(cl, tmp_path, monkeypatch):
    from h2o3_tpu_torch.ingest import chunked
    from h2o3_tpu_torch.ingest.parse_setup import ParseSetup

    p = tmp_path / "windowed.csv"
    rows = [f'{i},"quoted\nnewline {i}"' for i in range(40)]
    p.write_text("a,b\n" + "\n".join(rows) + "\n")
    setup = ParseSetup(column_names=["a", "b"], column_types=["real", "enum"])
    big = chunked.split_file(str(p), setup, 128)
    monkeypatch.setattr(chunked, "_SCAN_WINDOW", 7)
    assert chunked.split_file(str(p), setup, 128) == big


def test_headerless_and_blank_lines(cl, tmp_path, monkeypatch):
    import h2o3_tpu

    p = tmp_path / "nohdr.csv"
    p.write_text("1,2.5\n\n3,4.5\n\r\n5,6.5")
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=0)
    ref = th.import_file(str(p))
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=1,
         H2O_TPU_INGEST_CHUNK_BYTES=1024)
    fr = th.import_file(str(p))
    assert fr.nrows == 3 and fr.names == ["C1", "C2"]
    frames_bitwise(ref, fr)
    assert_frames_match(h2o3_tpu.import_file(str(p)), fr)


def test_multi_file_chunked(cl, tmp_path, monkeypatch):
    for i in range(3):
        (tmp_path / f"part{i}.csv").write_text("x,y\n" + "".join(
            f"{j + i * 10},{j * 2.0}\n" for j in range(5)))
    glob = str(tmp_path / "part*.csv")
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=0)
    ref = th.import_file(glob)
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=1)
    fr = th.import_file(glob)
    assert fr.nrows == 15
    frames_bitwise(ref, fr)


def test_enum_interning_matches_the_reference_interner(cl, tmp_path,
                                                       monkeypatch):
    """The C++ per-chunk interning plus the sorted-union remap reproduce
    the reference's _intern_domain over the whole column ("" is NA, the
    domain sorted), with a level first seen in a late chunk."""
    from h2o3_tpu.core.frame import _intern_domain

    vals = ["b", "", "a", "b", "héllo🎉", "z\nq", "a ", "A", "10", "9"]
    col = [vals[i % len(vals)] for i in range(600)] + ["late"]
    p = tmp_path / "g.csv"
    p.write_text("g,x\n" + "".join(
        f'"{v}",{i}\n' for i, v in enumerate(col)))
    _env(monkeypatch, H2O_TPU_INGEST_CHUNK_BYTES=1024)
    fr = th.import_file(str(p), col_types={"g": "enum"})
    dom, codes = _intern_domain(np.array(col, object))
    assert fr.col("g").domain == dom
    assert_bitwise(fr.col("g").data.numpy().astype(np.int32), codes)


def test_time_columns_resolve_column_wide(cl, tmp_path, monkeypatch):
    import h2o3_tpu

    p = tmp_path / "dates.csv"
    p.write_text("t,v\n" + "\n".join(
        f"2023-11-{(i % 27) + 1:02d} 0{i % 9}:15:00,{i * 1.5}"
        for i in range(120)) + "\n")
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=0)
    ref = th.import_file(str(p))
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=1,
         H2O_TPU_INGEST_CHUNK_BYTES=1024)
    fr = th.import_file(str(p))
    assert fr.types["t"] == "time"
    frames_bitwise(ref, fr)
    assert_frames_match(h2o3_tpu.import_file(str(p)), fr)
    assert fr.col("t").data.numpy()[0] == np.float32(1698797700000.0)


def test_time_columns_numeric_tokens_parse_as_dates(cl, tmp_path,
                                                    monkeypatch):
    import h2o3_tpu

    p = tmp_path / "numdates.csv"
    p.write_text("t,v\n" + "\n".join(
        f"2023110{(i % 9) + 1},{i * 0.5}" for i in range(120)) + "\n")
    kw = dict(col_types={"t": "time"})
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=0)
    ref = th.import_file(str(p), **kw)
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=1,
         H2O_TPU_INGEST_CHUNK_BYTES=1024)
    fr = th.import_file(str(p), **kw)
    frames_bitwise(ref, fr)
    assert_frames_match(h2o3_tpu.import_file(str(p), **kw), fr)
    assert fr.col("t").data.numpy()[0] == np.float32(1698796800000.0)


def test_first_chunk_all_na_takes_the_later_format(cl, tmp_path,
                                                   monkeypatch):
    """The time format comes from the column's first non-NA token even
    when whole early chunks are NA."""
    import h2o3_tpu

    p = tmp_path / "late.csv"
    p.write_text("t,v\n" + "".join(f"NA,{i}\n" for i in range(300))
                 + "".join(f"2024-01-{i % 28 + 1:02d} 10:00,{i}\n"
                           for i in range(200)))
    _env(monkeypatch, H2O_TPU_INGEST_CHUNK_BYTES=1024)
    kw = dict(col_types={"t": "time"})
    fr = th.import_file(str(p), **kw)
    assert_frames_match(h2o3_tpu.import_file(str(p), **kw), fr)
    assert np.isfinite(fr.col("t").data.numpy()[300:]).all()


def test_custom_quote_char_consistent(cl, tmp_path, monkeypatch):
    from h2o3_tpu.ingest import parser as jparser
    from h2o3_tpu.ingest.parse_setup import ParseSetup as JSetup
    from h2o3_tpu_torch.ingest import parser
    from h2o3_tpu_torch.ingest.parse_setup import ParseSetup

    p = tmp_path / "squote.csv"
    p.write_text("x,s\n1.0,'a,b'\n2.0,'c\nd'\n3.5,plain\n")
    kw = dict(separator=",", check_header=1, column_names=["x", "s"],
              column_types=["real", "string"], quote_char="'")
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=0)
    ref = parser.parse([str(p)], ParseSetup(**kw))
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=1,
         H2O_TPU_INGEST_CHUNK_BYTES=1024)
    fr = parser.parse([str(p)], ParseSetup(**kw))
    assert list(fr.col("s").host_data) == ["a,b", "c\nd", "plain"]
    frames_bitwise(ref, fr)
    assert_frames_match(jparser.parse([str(p)], JSetup(**kw)), fr)


def test_legacy_paths_count_coordinator_bytes(cl, tmp_path, monkeypatch):
    from h2o3_tpu_torch.ingest import chunked

    src = tmp_path / "z.csv"
    src.write_text("a,b\n" + "".join(f"{i},{i * 2}\n" for i in range(200)))
    gz = tmp_path / "z.csv.gz"
    gz.write_bytes(gzip.compress(src.read_bytes()))
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=1)
    before = chunked.counters()
    fr = th.import_file(str(gz))
    after = chunked.counters()
    assert after["coordinator_ingest_bytes"] > \
        before["coordinator_ingest_bytes"]
    assert after["chunks"] == before["chunks"]
    frames_bitwise(th.import_file(str(src)), fr)


def test_mis_split_file_falls_back_to_monolithic(cl, tmp_path,
                                                 monkeypatch):
    """A stray quote in an unquoted field flips the splitter's parity, so
    a chunk edge lands inside a quoted field: the chunk fails, and the
    monolithic path parses the file as the reference does."""
    import h2o3_tpu
    from h2o3_tpu_torch.ingest import chunked

    p = tmp_path / "missplit.csv"
    with open(p, "w") as f:
        f.write("a,b\n")
        f.write('1,x"y\n')
        for i in range(60):
            f.write(f'{i},"emb\nedded {i}"\n')
    _env(monkeypatch, H2O_TPU_INGEST_CHUNKED=1,
         H2O_TPU_INGEST_CHUNK_BYTES=1024)
    from h2o3_tpu_torch.ingest.parse_setup import guess_setup

    with pytest.raises(chunked.ChunkLayoutError):
        chunked.parse_csv_sharded([str(p)], guess_setup(str(p)))
    fr = th.import_file(str(p))
    assert fr.nrows == 61
    assert_frames_match(h2o3_tpu.import_file(str(p)), fr)


def _rows_text(rng, count, start, levels="ab"):
    out = []
    for i in range(count):
        x1, x2 = rng.normal(), rng.normal()
        g = levels[(start + i) % len(levels)]
        y = "Y" if x1 + 0.5 * x2 > 0 else "N"
        out.append(f"{x1:.6f},{x2:.6f},{g},{y}")
    return "\n".join(out) + "\n"


def test_streaming_append_bitwise_vs_cold_parse(cl, tmp_path):
    """Batches appended to an imported frame, one of them growing the enum
    domain, leave it bitwise what a cold parse of the concatenated file
    gives (the port's and the reference's); cached rollups merge."""
    import h2o3_tpu
    from h2o3_tpu_torch.ingest import chunked
    from h2o3_tpu_torch.ops.rollups import compute_rollups

    rng = np.random.default_rng(5)
    n = 400
    base = "x1,x2,g,y\n" + _rows_text(rng, n, 0)
    p = tmp_path / "stream_base.csv"
    p.write_text(base)
    fr = th.import_file(str(p))
    _ = fr.col("x1").rollups
    batches = [_rows_text(rng, 16, n), _rows_text(rng, 24, n + 16, "abc"),
               _rows_text(rng, 3, n + 40, "abc")]
    before = chunked.counters()["stream_rows"]
    for b in batches:
        assert chunked.append_csv(fr, b) == b.count("\n")
    assert chunked.counters()["stream_rows"] - before == 43
    assert fr.nrows == n + 43 and fr.col("g").domain == ["a", "b", "c"]
    cold_p = tmp_path / "stream_cold.csv"
    cold_p.write_text(base + "".join(batches))
    cold = th.import_file(str(cold_p))
    frames_bitwise(cold, fr, "streamed vs cold")
    assert_frames_match(h2o3_tpu.import_file(str(cold_p)), fr)
    r_inc, r_cold = fr.col("x1")._rollups, compute_rollups(cold.col("x1"))
    assert r_inc is not None
    assert (r_inc.rows, r_inc.na_count, r_inc.min, r_inc.max) == \
        (r_cold.rows, r_cold.na_count, r_cold.min, r_cold.max)
    np.testing.assert_allclose(r_inc.mean, r_cold.mean, rtol=1e-4)
    np.testing.assert_allclose(r_inc.sigma, r_cold.sigma, rtol=1e-3)


def test_stream_append_matches_the_reference_append(cl, tmp_path):
    """The same batches appended in both packages give the same frame."""
    import h2o3_tpu
    from h2o3_tpu.ingest import chunked as jchunked
    from h2o3_tpu_torch.ingest import chunked

    p = tmp_path / "s.csv"
    p.write_text("x,g,t\n" + "".join(
        f"{i * 0.25},{'uv'[i % 2]},2024-01-{i % 28 + 1:02d}\n"
        for i in range(64)))
    jf, tf = h2o3_tpu.import_file(str(p)), th.import_file(str(p))
    for b in ("90.5,u,2024-02-01\n91.5,w,NA\n", "NA,,2024-03-01\n"):
        assert jchunked.append_csv(jf, b) == chunked.append_csv(tf, b)
    assert_frames_match(jf, tf)


def test_stream_append_rejects_malformed_batches(cl, tmp_path):
    from h2o3_tpu_torch.ingest import chunked

    p = tmp_path / "strict.csv"
    p.write_text("x,g,y\n" + "".join(
        f"{i * 0.5},{'ab'[i % 2]},{'YN'[i % 2]}\n" for i in range(20)))
    fr = th.import_file(str(p))
    base = fr.col("x").data.numpy().copy()
    with pytest.raises(ValueError, match="4 fields"):
        chunked.append_csv(fr, "1.5,2.5,a,Y\n")
    with pytest.raises(ValueError, match="1 fields"):
        chunked.append_csv(fr, "1.5\n")
    with pytest.raises(ValueError):
        chunked.validate_batch(fr, "oops,a,Y\n")
    chunked.validate_batch(fr, '1.5, "a",Y\n')
    assert fr.nrows == 20
    assert_bitwise(fr.col("x").data.numpy(), base)


def test_stream_append_uses_frame_separator(cl, tmp_path):
    from h2o3_tpu_torch.ingest import chunked

    p = tmp_path / "semi.csv"
    p.write_text("x;g\n1.0;a\n2.0;b\n")
    fr = th.import_file(str(p))
    assert chunked.append_csv(fr, "3.5;b\n") == 1
    assert fr.col("x").data.numpy()[2] == np.float32(3.5)


def test_stream_append_honors_frame_na_strings(cl, tmp_path):
    from h2o3_tpu_torch.ingest import chunked

    p = tmp_path / "nas.csv"
    p.write_text("x,g\n1.0,a\n?,b\n2.0,a\n")
    fr = th.import_file(str(p), na_strings=["?"])
    assert fr.col("x").ctype != "string"
    assert chunked.append_csv(fr, "?,?\n3.5,b\n") == 2
    x = fr.col("x").data.numpy()
    assert np.isnan(x[3]) and x[4] == np.float32(3.5)
    assert fr.col("g").domain == ["a", "b"]
    assert int(fr.col("g").data.numpy()[3]) == -1


def test_stream_append_preserves_exact_time_host_copy(cl):
    from h2o3_tpu_torch.ingest import chunked

    ms = np.array(["2026-08-01T10:00:00.123", "2026-08-02T11:30:00.456"],
                  dtype="datetime64[ms]")
    fr = th.Frame()
    fr.add("t", th.Column.from_numpy(ms, ctype="time"))
    fr.add("x", th.Column.from_numpy(np.array([1.0, 2.0])))
    assert fr.col("t").host_data is not None
    assert chunked.append_csv(fr, "2026-08-03 12:00:00.789,3.0\n") == 1
    h = fr.col("t").host_data
    assert h is not None and h.dtype.kind == "M"
    exact = h.astype("datetime64[ms]").astype(np.int64)
    assert exact[0] == ms.astype(np.int64)[0]
    assert exact[2] == np.datetime64("2026-08-03T12:00:00.789", "ms") \
        .astype(np.int64)


def test_stream_append_refuses_domainless_cat(cl):
    from h2o3_tpu_torch.ingest import chunked

    fr = th.Frame()
    fr.add("g", th.Column.from_numpy(np.array([0, 1, 2, 1]), ctype="enum"))
    fr.add("x", th.Column.from_numpy(np.array([1.0, 2.0, 3.0, 4.0])))
    before = fr.col("g").data.numpy().copy()
    with pytest.raises(ValueError, match="no domain"):
        chunked.append_csv(fr, "a,5.0\n")
    assert_bitwise(fr.col("g").data.numpy(), before)
    assert fr.nrows == 4


def test_lazy_parquet_batches_first_touch_reads(cl, tmp_path, monkeypatch):
    pq = pytest.importorskip("pyarrow.parquet")
    import pyarrow as pa

    from h2o3_tpu_torch.ingest.parser import lazy_import_parquet

    n = 64
    rng = np.random.default_rng(3)
    cols = {f"n{i}": rng.normal(size=n) for i in range(6)}
    cols["g"] = np.array(["a", "b"] * (n // 2))
    path = tmp_path / "lazy.parquet"
    pq.write_table(pa.table(cols), path)
    calls = []
    real_read = pq.read_table

    def counting_read(src, columns=None, **kw):
        calls.append(list(columns or []))
        return real_read(src, columns=columns, **kw)

    monkeypatch.setattr(pq, "read_table", counting_read)
    fr = lazy_import_parquet(str(path))
    eager_calls = len(calls)
    assert fr.col("n0")._data is None and fr.col("g").domain == ["a", "b"]
    for i in range(6):
        assert_bitwise(fr.col(f"n{i}").to_numpy(),
                       cols[f"n{i}"].astype(np.float32))
    lazy_calls = calls[eager_calls:]
    assert len(lazy_calls) == 1, calls
    assert sorted(lazy_calls[0]) == [f"n{i}" for i in range(6)]


def test_lazy_parquet_concurrent_first_touch(cl, tmp_path, monkeypatch):
    pq = pytest.importorskip("pyarrow.parquet")
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow as pa

    from h2o3_tpu_torch.ingest.parser import lazy_import_parquet

    monkeypatch.setenv("H2O_TPU_INGEST_PARQUET_BATCH", "4")
    n = 48
    rng = np.random.default_rng(11)
    cols = {f"n{i}": rng.normal(size=n) for i in range(8)}
    path = tmp_path / "lazy_mt.parquet"
    pq.write_table(pa.table(cols), path)
    calls = []
    real_read = pq.read_table

    def counting_read(src, columns=None, **kw):
        calls.append(list(columns or []))
        return real_read(src, columns=columns, **kw)

    monkeypatch.setattr(pq, "read_table", counting_read)
    fr = lazy_import_parquet(str(path))
    with ThreadPoolExecutor(max_workers=8) as pool:
        got = list(pool.map(lambda i: fr.col(f"n{i}").to_numpy(), range(8)))
    for i in range(8):
        assert_bitwise(got[i], cols[f"n{i}"].astype(np.float32))
    assert sorted(nm for c in calls for nm in c) == sorted(cols)
    assert len(calls) <= 8 - (4 - 1), calls


@pytest.mark.gpu
def test_card_import_equals_cpu_import(tmp_path, monkeypatch):
    """On the card the chunks land through pinned buffers copied on a
    side stream; a buffer reused before its copy completed would corrupt
    columns silently, so the card's import must equal the CPU's, chunked
    and appended."""
    import torch

    from h2o3_tpu_torch.ingest import chunked

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pinned-buffer path runs only "
                    "there)")
    p = _nasty_csv(tmp_path / "nasty.csv", n=4000)
    _env(monkeypatch, H2O_TPU_INGEST_CHUNK_BYTES=4096)
    card, cpu = th.import_file(p, device="cuda"), th.import_file(p,
                                                                 device="cpu")
    assert card.col("val").data.device.type == "cuda"
    frames_bitwise(card, cpu)
    for fr in (card, cpu):
        chunked.append_csv(fr, "9001,new,2.5\n")
    frames_bitwise(card, cpu)
