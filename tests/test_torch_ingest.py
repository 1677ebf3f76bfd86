"""The port's import_file (h2o3_tpu_torch/ingest) against the JAX
package's on the same CSV files: names, types and domains equal; numeric
float32 values, NA masks, enum codes and time epoch-millis bitwise equal
over the reference's first nrows (tests/torch_port_support.py
assert_frames_match). No tolerance anywhere: the port's C++ parser
follows pandas' converter arithmetic, so every double, and so every
float32, is the reference's. Divergences from pandas' token semantics
are ROADMAP C12, each shown by a test below.

The scenarios mirror tests/test_ingest.py; the slice as a whole (CSV ->
GBM) is test_flagship_csv_trains_the_same_forest."""

import gzip
import sys

import numpy as np
import pytest

import h2o3_tpu_torch as th

from torch_port_support import (assert_bitwise, assert_frames_match,
                                flagship_cols, forest_arrays)


@pytest.fixture(autouse=True)
def _cpu():
    th.init(device="cpu")


def _both(path, **kw):
    import h2o3_tpu

    return (h2o3_tpu.import_file(str(path), **kw),
            th.import_file(str(path), **kw))


def test_parse_setup_guess_matches(cl, airlines_csv):
    from h2o3_tpu.ingest.parse_setup import guess_setup as jguess

    j, t = jguess(airlines_csv), th.parse_setup(airlines_csv)
    assert t.to_dict() == j.to_dict()
    assert t.column_names == ["DayOfWeek", "Carrier", "Distance", "DepTime",
                              "IsDepDelayed"]
    assert t.column_types[0] == "enum" and t.column_types[2] == "real"


def test_import_file_matches(cl, airlines_csv):
    jf, tf = _both(airlines_csv)
    assert_frames_match(jf, tf)
    assert tf.nrows == 2000 and tf.col("Carrier").domain == \
        ["AA", "DL", "UA", "WN"]
    assert tf.col("Distance").rollups.min >= 50


def test_import_gzip_matches_and_counts_host_bytes(cl, airlines_csv,
                                                   tmp_path):
    from h2o3_tpu_torch.ingest import chunked

    gz = tmp_path / "airlines.csv.gz"
    with open(airlines_csv, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    before = chunked.counters()["coordinator_ingest_bytes"]
    jf, tf = _both(gz)
    assert chunked.counters()["coordinator_ingest_bytes"] > before
    assert_frames_match(jf, tf)


def test_na_strings_match(cl, tmp_path):
    p = tmp_path / "nas.csv"
    p.write_text("a,b\n1,x\nNA,y\n3,NA\n#N/A,null\n-nan,<NA>\n")
    jf, tf = _both(p)
    assert_frames_match(jf, tf)
    assert tf.col("a").rollups.na_count == 3
    assert tf.col("b").rollups.na_count == 3


def test_custom_na_strings_and_their_numbers(cl, tmp_path):
    """A numeric NA string also makes its integral spellings and its
    value NA, as pandas' na_values do ("-999" -> "-999.0", -999.00)."""
    p = tmp_path / "nas2.csv"
    p.write_text("a,b\n1,x\n-999,y\n-999.0,?\n-999.00,z\n5,?\n")
    jf, tf = _both(p, na_strings=["-999", "?"])
    assert_frames_match(jf, tf)
    assert np.isnan(tf.col("a").data.numpy()[1:4]).all()


def test_headerless_matches(cl, tmp_path):
    p = tmp_path / "nohdr.csv"
    p.write_text("1,2.5\n3,4.5\n5,6.5\n")
    jf, tf = _both(p)
    assert_frames_match(jf, tf)
    assert tf.names == ["C1", "C2"]


def test_multi_file_glob_matches(cl, tmp_path):
    for i in range(3):
        (tmp_path / f"part{i}.csv").write_text("x,y\n" + "".join(
            f"{j + i * 10},{j * 2.0}\n" for j in range(5)))
    jf, tf = _both(tmp_path / "part*.csv")
    assert_frames_match(jf, tf)
    assert tf.nrows == 15


def test_multi_file_header_mismatch_raises(cl, tmp_path):
    (tmp_path / "a1.csv").write_text("x,y\n1,2\n")
    (tmp_path / "a2.csv").write_text("x,z\n1,2\n")
    with pytest.raises(ValueError, match="column mismatch"):
        th.import_file(str(tmp_path / "a?.csv"))


def test_numeric_columns_match(cl, tmp_path):
    p = tmp_path / "num.csv"
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=1000), rng.integers(0, 100, 1000)
    p.write_text("a,b\n" + "".join(f"{x:.6g},{y:.1f}\n"
                                   for x, y in zip(a, b)))
    jf, tf = _both(p)
    assert_frames_match(jf, tf)


def _random_number_tokens(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        nd = int(rng.integers(1, 25))
        digs = "".join(rng.choice(list("0123456789"), nd))
        dp = int(rng.integers(0, nd + 1))
        t = digs[:dp] + "." + digs[dp:] if rng.random() < 0.8 else digs
        if rng.random() < 0.3:
            t += "e" + str(int(rng.integers(-330, 330)))
        if rng.random() < 0.5:
            t = "-" + t
        if t.lstrip("-").startswith(".e") or t.lstrip("-") == ".":
            continue
        out.append(t)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_number_tokens_bitwise_vs_reference(cl, tmp_path, seed):
    """20k random tokens of 1-24 digits with exponents to +-330: each
    float32 equals the reference's. A correctly rounded parse would not:
    pandas' converter rounds twice past 15 digits, and its float32 differs
    for a few tokens in 100k (PERF.md §6)."""
    toks = _random_number_tokens(20_000, seed)
    p = tmp_path / "tokens.csv"
    p.write_text("x\n" + "\n".join(toks) + "\n")
    jf, tf = _both(p)
    assert_frames_match(jf, tf)


def test_special_number_tokens_match(cl, tmp_path):
    toks = ["inf", "-Infinity", "+inf", "INF", "1e309", "-1e309", "0e400",
            "1e-400", "4.9e-324", "-0", "1.", ".5", " 7", "8 ", "\t9",
            "1E5", "+3", "00012", "12345678901234567890",
            "0.123456789012345678901"]
    p = tmp_path / "special.csv"
    p.write_text("x\n" + "\n".join(toks) + "\n")
    jf, tf = _both(p)
    assert_frames_match(jf, tf)


@pytest.mark.parametrize("tok", ["-", ".", "1e", "1.5e-", "0x10", "abc"])
def test_unconvertible_number_raises_in_both(cl, tmp_path, tok):
    import h2o3_tpu

    p = tmp_path / "bad.csv"           # an enum column keeps the
    # reference off its numeric-only native parser, which reads NaN here
    p.write_text("x,g\n" + "".join(f"{v},a\n" for v in ["1.5"] * 1001
                                   + [tok]))
    with pytest.raises(ValueError):
        h2o3_tpu.import_file(str(p))
    with pytest.raises(ValueError, match="could not convert"):
        th.import_file(str(p))


_TIME_SHAPES = {
    "iso_date": ["2024-01-05", "2024-1-5", "2024-02-29", "2023-02-29",
                 "2024-01-05 10:00", "NA", "0999-01-01"],
    "iso_minutes": ["2024-01-05 10:00", "2024-1-5 10:00", "2024-01-05 1:2",
                    "2024-01-05  10:00", "2024-01-05T10:00",
                    "2024-01-05 24:00", ""],
    "iso_seconds": ["1969-12-31 23:59:59", "2024-01-05 10:00:61",
                    "2024-01-05 10:60:00", "2024-01-05 1:2:3",
                    "2024-01-05T10:00:00", "2024-01-05 10:00"],
    "iso_t": ["2024-01-05T10:00:00", "2024-1-5T10:0:0",
              "2024-01-05 10:00:00", "2024-01-05T10:00"],
    "iso_fraction": ["2026-08-03 12:00:00.789", "1960-06-30 23:59:59.999",
                     "2024-01-05 10:00:00.123456789", "2024-01-05 10:00:00",
                     "2024-01-05 10:00:00.5"],
    "iso_hour": ["2024-01-05T10", "2024-01-05T1", "2024-01-05 10"],
    "compact": ["20231105", "2024015", "20241305", "2023-11-05",
                "202401050"],
    "us_slash": ["01/02/2020", "12/31/1999", "13/01/2020", "1/2/2020"],
    "day_first_slash": ["13/01/2020", "01/02/2020", "31/12/1999"],
    "element_wise": ["2024-02-30", "2023-11-01T10:00", "20231105",
                     "2024-01-05 10:00:00", "garbage", "NaT"],
}


@pytest.mark.parametrize("shape", sorted(_TIME_SHAPES))
def test_time_shapes_match(cl, tmp_path, shape):
    """Each time shape the port parses, held to pd.to_datetime's column
    reading: the first non-NA token fixes the format, others must match
    it (1-2 digit fields, seconds to 61, space runs as \\s+, fractions
    cut to ms), and an invalid first token makes pandas read token by
    token."""
    p = tmp_path / "t.csv"
    p.write_text("t,v\n" + "".join(f"{t},{i}\n" for i, t in
                                   enumerate(_TIME_SHAPES[shape])))
    jf, tf = _both(p, col_types={"t": "time"})
    assert_frames_match(jf, tf)
    assert np.isfinite(tf.col("t").data.numpy()).sum() >= 2


def test_time_columns_guessed_from_iso_tokens(cl, tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("d,v\n2024-01-01,1\n2024-06-15,2\n,3\n")
    jf, tf = _both(p)
    assert tf.col("d").ctype == "time"
    assert_frames_match(jf, tf)
    assert tf.col("d").data.numpy()[0] == np.float32(1704067200000.0)


def test_enum_domains_sort_as_python_str(cl, tmp_path):
    """Domains sort by bytes, which for UTF-8 is Python's str order."""
    toks = ["b", "", "a", "b", '"héllo🎉"', '"z\nq"', '"a "', "A", "10",
            "9", '"日本"', "Z", '""', "é"]
    p = tmp_path / "dom.csv"
    p.write_text("g,x\n" + "".join(f"{t},{i}\n" for i, t in enumerate(toks)))
    jf, tf = _both(p, col_types={"g": "enum"})
    assert_frames_match(jf, tf)
    assert tf.col("g").domain == sorted(tf.col("g").domain)


def test_csv_path_imports_no_pandas(tmp_path, monkeypatch):
    """The CSV path never imports pandas: with the module blocked, a file
    of every column kind imports chunked and monolithic (gz), and a
    stream append parses."""
    from h2o3_tpu_torch.ingest import chunked

    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    p = tmp_path / "all.csv"
    p.write_text("x,g,s,t\n" + "".join(
        f'{i * 0.5},{"ab"[i % 2]},"s {i}",2024-01-{i % 28 + 1:02d}\n'
        for i in range(200)))
    fr = th.import_file(str(p), col_types={"s": "string"})
    gz = tmp_path / "all.csv.gz"
    gz.write_bytes(gzip.compress(p.read_bytes()))
    fr_gz = th.import_file(str(gz), col_types={"s": "string"})
    assert fr.types == {"x": "real", "g": "enum", "s": "string",
                        "t": "time"}
    assert chunked.append_csv(fr, '1.5,c,"s x",2024-02-01\n') == 1
    assert fr.nrows == 201 and fr_gz.nrows == 200
    assert fr.col("g").domain == ["a", "b", "c"]


def test_failed_parser_build_raises(tmp_path, monkeypatch):
    """A parser source that does not compile raises; nothing parses the
    file another way."""
    from h2o3_tpu_torch import native

    bad = tmp_path / "csv_parser.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    p = tmp_path / "x.csv"
    p.write_text("a\n1\n")
    with pytest.raises(RuntimeError,
                       match=r"building csv_parser\.cpp \+ threefry\.cpp "
                             r"\+ sha1\.cpp \+ treeshap\.cpp failed"):
        th.import_file(str(p))


def test_import_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                       monkeypatch):
    import torch

    from h2o3_tpu_torch.core import runtime

    p = tmp_path / "x.csv"
    p.write_text("a\n1\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(runtime, "_CLUSTER", None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        th.import_file(str(p))
    assert th.import_file(str(p), device="cpu").col("a").data.device.type \
        == "cpu"


def _write_flagship_csv(path, cols):
    """Each numeric value as the float64 repr of its float32 value, so the
    text round-trips exactly."""
    names = list(cols)
    text = []
    for name in names:
        arr, ctype = cols[name]
        if ctype == "enum":
            text.append(list(arr))
        else:
            text.append([repr(float(v)) for v in
                         np.asarray(arr, np.float64).astype(np.float32)])
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        f.writelines(",".join(r) + "\n" for r in zip(*text))


def test_flagship_csv_trains_the_same_forest(cl, tmp_path, monkeypatch):
    """The slice as a whole: the flagship's columns written to CSV,
    imported by the port, train a GBM whose forest equals bit for bit the
    one trained on the numpy-built frame; the reference's GBM on its own
    import of the file predicts within 1e-6 of the port (ROADMAP C2)."""
    import h2o3_tpu
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    cols = flagship_cols(640, seed=3)
    p = tmp_path / "flagship.csv"
    _write_flagship_csv(p, cols)
    tf = th.import_file(str(p))
    built = th.Frame()
    for name, (arr, ctype) in cols.items():
        built.add(name, th.Column.from_numpy(arr, ctype=ctype))
    for name in built.names:
        assert_bitwise(tf.col(name).data.numpy(),
                       built.col(name).data.numpy(), name)
    kw = dict(ntrees=4, max_depth=3, seed=3)
    m_csv = th.GBM(**kw).train(y="y", training_frame=tf)
    m_np = th.GBM(**kw).train(y="y", training_frame=built)
    a, b = forest_arrays(m_csv.forest), forest_arrays(m_np.forest)
    for k in a:
        assert_bitwise(a[k], b[k], k)
    assert_bitwise(np.asarray(m_csv.forest.leaf_val),
                   np.asarray(m_np.forest.leaf_val), "leaf_val")
    jf = h2o3_tpu.import_file(str(p))
    assert_frames_match(jf, tf)
    jm = JGBM(**kw).train(y="y", training_frame=jf)
    np.testing.assert_allclose(
        m_csv.predict(tf).col("Y").to_numpy(),
        np.asarray(jm.predict(jf).col("Y").to_numpy())[:tf.nrows],
        atol=1e-6)


# -- divergences from pandas' token semantics (ROADMAP C12) -----------------

def test_c12_record_after_bare_cr_starting_with_a_space(cl, tmp_path):
    """After a record ended by a bare \\r, a record starting with a space
    or tab makes pandas' tokenizer step back past the \\r and read the
    earlier records again (a duplicated row here; elsewhere 'Buffer
    overflow caught' or 2**17 empty rows). The port reads each record
    once."""
    from h2o3_tpu.ingest import parser as jparser
    from h2o3_tpu.ingest.parse_setup import ParseSetup as JSetup
    from h2o3_tpu_torch.ingest import parser as tparser
    from h2o3_tpu_torch.ingest.parse_setup import ParseSetup

    p = tmp_path / "cr.csv"
    p.write_bytes(b"a\rb\r c\n")
    kw = dict(check_header=-1, column_names=["x"], column_types=["string"])
    tf = tparser.parse([str(p)], ParseSetup(**kw))
    assert list(tf.col("x").host_data) == ["a", "b", "c"]
    try:
        jrows = jparser.parse([str(p)], JSetup(**kw)).nrows
    except Exception as e:                      # noqa: BLE001
        assert "Buffer overflow" in str(e)
    else:
        assert jrows > 3


@pytest.mark.parametrize("header", [1, -1])
@pytest.mark.parametrize("text", [
    "h,i,j,k\n1,2,3,4,5\n6,7,8,9,10\n6\n",
    "h,i,j,k,l\n1,2,3,4\n6,7,8,9,10\n",
    "h\n1,2,3,4\n5\n",
    "a,b,c,d\n1,2\n4,5,6\n"])
def test_record_widths_follow_pandas(cl, tmp_path, monkeypatch, header,
                                     text):
    """Records wider than the column names: pandas takes the width of the
    first data record (and of the header record, with one) and reads the
    extra leading fields as its index, which the frame drops; shorter
    records fill with NA. Chunked and monolithic paths alike."""
    from h2o3_tpu.ingest import parser as jparser
    from h2o3_tpu.ingest.parse_setup import ParseSetup as JSetup
    from h2o3_tpu.native import loader as jloader
    from h2o3_tpu_torch.ingest import parser as tparser
    from h2o3_tpu_torch.ingest.parse_setup import ParseSetup

    monkeypatch.setattr(jloader, "native_parse_csv", lambda *a, **k: None)
    p = tmp_path / "wide.csv"
    p.write_text(text)
    kw = dict(check_header=header, column_names=list("abcd"),
              column_types=["string"] * 4)
    for chunked in ("0", "1"):
        monkeypatch.setenv("H2O_TPU_INGEST_CHUNKED", chunked)
        try:
            jf = jparser.parse([str(p)], JSetup(**kw))
        except Exception as e:                  # noqa: BLE001
            assert "Expected" in str(e), e
            with pytest.raises(ValueError, match="expected"):
                tparser.parse([str(p)], ParseSetup(**kw))
            continue
        assert_frames_match(jf, tparser.parse([str(p)], ParseSetup(**kw)),
                            chunked)


def test_c12_time_shapes_pandas_reads_and_the_port_does_not(cl, tmp_path):
    """pandas falls back to dateutil for first tokens it cannot fit to a
    format ('Jan 5 2024'); the port reads only the shapes of
    _TIME_SHAPES, so such a column is NA in the port."""
    p = tmp_path / "words.csv"
    p.write_text("t,v\nJan 5 2024,1\nFeb 6 2024,2\n")
    jf, tf = _both(p, col_types={"t": "time"})
    assert np.isfinite(np.asarray(jf.col("t").data)[:2]).all()
    assert np.isnan(tf.col("t").data.numpy()).all()


def test_c12_datetime64_input_is_epoch_millis(cl):
    """A datetime64 column is epoch milliseconds in the port whatever its
    unit, NaT as NaN; the reference stores the raw count of the array's
    own unit and NaT as -2**63."""
    from h2o3_tpu.core.frame import Column as JColumn

    ms = np.array(["2026-08-01T10:00:00.123", "NaT"], "datetime64[ms]")
    t, j = th.Column.from_numpy(ms), JColumn.from_numpy(ms)
    assert t.ctype == j.ctype == "time"
    got = t.data.numpy()
    assert got[0] == np.asarray(j.data)[0] and np.isnan(got[1])
    assert np.asarray(j.data)[1] < -9e18
    ns = t.from_numpy(ms.astype("datetime64[ns]")).data.numpy()
    assert_bitwise(ns, got)
