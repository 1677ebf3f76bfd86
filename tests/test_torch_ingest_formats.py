"""The port's other formats, persist registry, SQL and decryption
(h2o3_tpu_torch/ingest/{formats,avro,sql,decrypt}.py, persist/) against
the JAX package on the same files. Mirrors tests/test_ingest_formats.py,
tests/test_formats_round4.py (Avro, XLSX) and the SQL cases of
tests/test_coverage_bc.py; pyarrow formats skip where pyarrow is absent.
Columns compare bitwise (tests/torch_port_support.py)."""

import http.server
import sqlite3
import threading
import zipfile

import numpy as np
import pytest

import h2o3_tpu_torch as th

from torch_port_support import assert_frames_match


@pytest.fixture(autouse=True)
def _cpu():
    th.init(device="cpu")


def _both(path, **kw):
    import h2o3_tpu

    return (h2o3_tpu.import_file(str(path), **kw),
            th.import_file(str(path), **kw))


def _pq_file(tmp_path, name="t.parquet", n=500):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.default_rng(0)
    cats = np.array(["lo", "mid", "hi"], object)[rng.integers(0, 3, n)]
    cats[5] = None
    x = rng.standard_normal(n)
    x[3] = np.nan
    table = pa.table({
        "x": pa.array(x),
        "i": pa.array(rng.integers(0, 100, n)),
        "b": pa.array(rng.random(n) < 0.5),
        "cat": pa.array(cats),
        "ts": pa.array(np.array(["2024-01-01", "2024-06-15"],
                                "datetime64[ms]")[rng.integers(0, 2, n)]),
    })
    p = str(tmp_path / name)
    pq.write_table(table, p)
    return p


def test_parquet_matches(cl, tmp_path):
    jf, tf = _both(_pq_file(tmp_path))
    assert_frames_match(jf, tf)
    assert tf.col("ts").ctype == "time" and tf.col("cat").domain == \
        ["hi", "lo", "mid"]


def test_parquet_trains_a_model(cl, tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.default_rng(1)
    n = 640
    x1 = rng.standard_normal(n)
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-2 * x1)), "Y", "N")
    p = str(tmp_path / "train.parquet")
    pq.write_table(pa.table({"x1": x1, "y": y}), p)
    m = th.GBM(ntrees=5, max_depth=3, seed=1).train(
        y="y", training_frame=th.import_file(p))
    assert float(m._output.training_metrics.auc) > 0.7


def test_orc_and_feather_match(cl, tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.feather as feather
    import pyarrow.orc as orc

    p = str(tmp_path / "t.orc")
    orc.write_table(pa.table({"a": [1.0, 2.0, 3.5], "s": ["u", "v", "u"]}),
                    p)
    assert_frames_match(*_both(p))
    f = str(tmp_path / "t.feather")
    feather.write_feather(pa.table({"a": [1, 2, 3]}), f)
    assert_frames_match(*_both(f))


def test_arff_matches(cl, tmp_path):
    p = tmp_path / "t.arff"
    p.write_text("% comment\n@relation demo\n"
                 "@attribute age numeric\n"
                 "@attribute grade {A,B,C}\n"
                 "@attribute note string\n"
                 "@attribute when date\n"
                 "@data\n"
                 "34,A,'hello',2024-01-01\n?,B,'x',?\n12,?,'y',2024-06-15\n")
    jf, tf = _both(p)
    assert_frames_match(jf, tf)
    assert tf.col("when").data.numpy()[0] == np.float32(1704067200000.0)


def test_svmlight_matches(cl, tmp_path):
    p = tmp_path / "t.svm"
    p.write_text("1 1:0.5 3:2.0 # comment\n-1 2:1.5\n1 qid:4 1:1.0\n")
    jf, tf = _both(p)
    assert_frames_match(jf, tf)
    assert tf.ncols == 4


def test_svmlight_multifile_widths(cl, tmp_path):
    (tmp_path / "s1.svm").write_text("1 1:1.0 5:2.0\n")
    (tmp_path / "s2.svm").write_text("0 2:3.0\n")
    jf, tf = _both(tmp_path / "s?.svm")
    assert_frames_match(jf, tf)
    assert tf.ncols == 6 and tf.nrows == 2


def test_avro_matches(cl, tmp_path):
    from h2o3_tpu_torch.ingest.avro import write_avro

    path = str(tmp_path / "data.avro")
    n = 500
    rng = np.random.default_rng(1)
    write_avro(path, {
        "x": [float(v) for v in rng.normal(size=n)],
        "g": [["red", "green", "blue"][i % 3] for i in range(n)],
        "k": list(range(n)),
        "maybe": [None if i % 7 == 0 else float(i) for i in range(n)]}, [
        {"name": "x", "type": "double"},
        {"name": "g", "type": "string"},
        {"name": "k", "type": "long"},
        {"name": "maybe", "type": ["null", "double"]}], codec="deflate")
    jf, tf = _both(path)
    assert_frames_match(jf, tf)


def _make_xlsx(path, header, rows):
    NS = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    shared, sidx = [], {}

    def cell(r, cidx, v):
        ref = f"{chr(65 + cidx)}{r}"
        if isinstance(v, str):
            if v not in sidx:
                sidx[v] = len(shared)
                shared.append(v)
            return f'<c r="{ref}" t="s"><v>{sidx[v]}</v></c>'
        return f'<c r="{ref}"><v>{v}</v></c>'

    body = ['<row r="1">' + "".join(cell(1, j, h) for j, h in
                                    enumerate(header)) + "</row>"]
    for i, row in enumerate(rows):
        body.append(f'<row r="{i + 2}">' + "".join(
            cell(i + 2, j, v) for j, v in enumerate(row) if v is not None)
            + "</row>")
    sheet = (f'<?xml version="1.0"?><worksheet {NS}><sheetData>'
             + "".join(body) + "</sheetData></worksheet>")
    sst = (f'<?xml version="1.0"?><sst {NS}>'
           + "".join(f"<si><t>{s}</t></si>" for s in shared) + "</sst>")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("xl/worksheets/sheet1.xml", sheet)
        z.writestr("xl/sharedStrings.xml", sst)
    return path


def test_xlsx_matches(cl, tmp_path):
    path = _make_xlsx(str(tmp_path / "book.xlsx"), ["name", "value", "n"],
                      [["alpha", 1.5, 10], ["beta", 2.5, 20],
                       ["gamma", None, 30], ["alpha", 4.0, 40]])
    jf, tf = _both(path)
    assert_frames_match(jf, tf)


def test_gated_and_corrupt_binaries_raise(tmp_path):
    p = tmp_path / "d.xls"
    p.write_bytes(b"\x00\x01binary")
    with pytest.raises(NotImplementedError, match="decoder"):
        th.import_file(str(p))
    bad_avro = tmp_path / "d.avro"
    bad_avro.write_bytes(b"\x00\x01binary")
    with pytest.raises(ValueError, match="avro"):
        th.import_file(str(bad_avro))
    bad_xlsx = tmp_path / "d.xlsx"
    bad_xlsx.write_bytes(b"\x00\x01binary")
    with pytest.raises(zipfile.BadZipFile):
        th.import_file(str(bad_xlsx))


def test_parquet_col_names_and_types_override(cl, tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    p = str(tmp_path / "r.parquet")
    pq.write_table(pa.table({"k": [1.0, 2.0, 1.0, np.nan], "j": [2.0] * 4}),
                   p)
    assert th.import_file(p, col_names=["a", "b"]).names == ["a", "b"]
    jf, tf = _both(p, col_types={"k": "enum"})
    assert_frames_match(jf, tf)
    assert tf.col("k").domain == ["1", "2"]


def test_http_import(cl, tmp_path):
    """A localhost server; the fetched file is cached by URI."""
    from h2o3_tpu_torch import persist

    (tmp_path / "web.csv").write_text("a,b\n1,x\n2,y\n3,x\n")

    def handler(*a, **kw):
        return http.server.SimpleHTTPRequestHandler(
            *a, directory=str(tmp_path), **kw)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        uri = f"http://127.0.0.1:{srv.server_port}/web.csv"
        fr = th.import_file(uri)
        assert fr.nrows == 3 and fr.col("b").domain == ["x", "y"]
        assert persist.resolve(uri) == persist.resolve(uri)
    finally:
        srv.shutdown()
        srv.server_close()


def test_gated_schemes_and_custom_scheme(tmp_path):
    from h2o3_tpu_torch import persist

    with pytest.raises(NotImplementedError, match="google-cloud"):
        persist.resolve("gs://bucket/key.csv")
    with pytest.raises(NotImplementedError, match="S3"):
        persist.resolve("s3://bucket/key.csv")
    with pytest.raises(ValueError, match="no persist backend"):
        persist.resolve("weird://x")
    p = tmp_path / "c.csv"
    p.write_text("a\n5\n")
    persist.register_scheme("unittest", lambda uri: str(p))
    try:
        fr = th.import_file("unittest://anything")
        assert fr.nrows == 1 and fr.col("a").to_numpy()[0] == 5.0
        assert th.import_file(f"file://{p}").col("a").to_numpy()[0] == 5.0
    finally:
        persist._SCHEMES.pop("unittest", None)


def test_glob_parse_keeps_file_order(cl, tmp_path):
    for i in range(6):
        (tmp_path / f"part{i}.csv").write_text(
            "v,g\n" + "".join(f"{i * 100 + j},g{j % 2}\n" for j in range(50)))
    jf, tf = _both(tmp_path / "part*.csv")
    assert_frames_match(jf, tf)
    np.testing.assert_array_equal(
        tf.col("v").to_numpy(),
        np.concatenate([i * 100 + np.arange(50) for i in range(6)]))


def test_custom_col_names_multi_file(cl, tmp_path):
    (tmp_path / "b1.csv").write_text("x,y\n1,2\n")
    (tmp_path / "b2.csv").write_text("x,y\n3,4\n")
    fr = th.import_file(str(tmp_path / "b?.csv"), col_names=["a", "b"])
    assert fr.names == ["a", "b"] and fr.nrows == 2


def test_lazy_parquet_frame_materializes_on_touch_and_trains(cl, tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    from h2o3_tpu_torch.ingest.parser import lazy_import_parquet

    rng = np.random.default_rng(1)
    n = 512
    x = rng.standard_normal(n)
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-2 * x)), "Y", "N")
    p = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"x": x, "z": rng.standard_normal(n), "y": y}),
                   p)
    fr = lazy_import_parquet(p)
    assert fr.col("x")._data is None and fr.col("y").domain == ["N", "Y"]
    assert abs(float(fr.col("z").rollups.mean)) < 0.2
    assert fr.col("z")._data is not None and fr.col("x")._data is None
    m = th.GBM(ntrees=4, max_depth=3, seed=1).train(y="y", training_frame=fr)
    assert float(m._output.training_metrics.auc) > 0.7


def test_sqlite_table_and_select_match(cl, tmp_path):
    from h2o3_tpu.ingest.sql import import_sql_table as jtable

    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE obs (x REAL, grp TEXT, n INTEGER)")
    conn.executemany("INSERT INTO obs VALUES (?,?,?)",
                     [(i * 0.5, "ab"[i % 2], i) for i in range(100)])
    conn.commit()
    conn.close()
    url = f"sqlite:///{db}"
    tf = th.import_sql_table(url, "obs")
    assert_frames_match(jtable(url, "obs"), tf)
    assert tf.col("grp").domain == ["a", "b"]
    assert th.import_sql_select(url, "SELECT x FROM obs WHERE n < 10"
                                ).nrows == 10
    with pytest.raises(ImportError, match="psycopg2"):
        th.import_sql_table("postgresql://host/db", "t")
    with pytest.raises(ValueError, match="suspicious"):
        th.import_sql_table(url, "obs; DROP TABLE obs")


def test_decryption_tool_registry():
    from h2o3_tpu_torch.ingest import decrypt

    tid = decrypt.register_tool("nulltool", decrypt.NULL_TOOL, {})
    assert decrypt.get_tool(tid)(b"abc") == b"abc"
    assert decrypt.get_tool(None) is None
    with pytest.raises(KeyError):
        decrypt.get_tool("missing")
