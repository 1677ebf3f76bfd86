"""bfloat16 numeric storage in the port (the `numeric_dtype` opt-in) on the
CPU, against the JAX package with the same opt-in, from seeded numpy
fixtures.

Tolerances:
- storage: T_NUM columns bfloat16, T_TIME and T_INT float32, exactly
  half the bytes; values bitwise equal to the reference's bf16 cast with
  NaN compared as a mask (the two routes write different NaN payloads:
  ml_dtypes keeps a negative NaN's sign, torch's float32 -> bf16 cast
  writes 0xffff);
- rollups: min, max, NA and nonzero counts exact, mean and sigma rtol
  1e-6 (the float32 sums add in another order, ROADMAP C2);
- the promotion cases (bf16 with a scalar, with bf16, with a float32
  column), the comparisons and the exactly rounded unary ops: bitwise,
  NaN equal to NaN (the reference computes all of them in float32: its
  bf16 round trip before the cast to float32 is removed by XLA);
  lgamma and digamma: bitwise, rounded to bf16 as XLA rounds them;
- bin edges: bitwise at 37, 1,000 and 200,001 rows (1,024 bins);
- GBM: forest structure bitwise, leaf values and predictions atol 1e-6;
- binomial GLM: coefficients atol 1e-5 + rtol 1e-5, the tolerance of
  tests/test_torch_glm.py;
- CSV import: bitwise, NaN as a mask; a fused statement: bitwise with
  its eager run, under a signature of its own.
Row counts of the model fixtures are multiples of 64, so the JAX package
pads no rows."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch.core import runtime
from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.rapids import fusion

from torch_port_support import (Both, both_frames, forest_arrays,
                                install_both, train_cols)

GLM_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture()
def bf16(cl):
    """Both packages store T_NUM columns in bfloat16 for the test, and
    get back the dtype each had before it (not float32: under
    ``H2O_TPU_NUMERIC_DTYPE=bfloat16`` that is bfloat16, and the files a
    worker runs after this one must keep it; ROADMAP C45)."""
    th.init(device="cpu")
    found = (cl.args.numeric_dtype, th.cluster().args.numeric_dtype)
    cl.args.numeric_dtype = "bfloat16"
    th.cluster().args.numeric_dtype = "bfloat16"
    yield cl
    cl.args.numeric_dtype, th.cluster().args.numeric_dtype = found


def bits_equal(ref, got, ctx=""):
    """bf16 values (the reference's ml_dtypes array or float64 of one,
    and a port column's widened float32 values): NaN as a mask, the
    rest bitwise."""
    ref = np.asarray(ref).astype(np.float32)
    got = np.asarray(got, np.float32)
    na = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), na, err_msg=ctx)
    np.testing.assert_array_equal(got[~na].view(np.uint32),
                                  ref[~na].view(np.uint32), err_msg=ctx)


def host(jcol, n):
    return np.asarray(jcol.to_numpy())[:n]


def num_fixture(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
    x[rng.random(n) < 0.05] = np.nan
    x[:4] = [0.0, -0.0, np.inf, -np.nan]
    return x


# ---------------------------------------------------------------------------
# the opt-in and the storage rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["init", "env", "args"])
def test_opt_in_stores_t_num_as_bf16_at_half_the_bytes(cl, monkeypatch,
                                                       how):
    x = num_fixture()
    found = (cl.args.numeric_dtype,
             runtime._CLUSTER.args.numeric_dtype if runtime._CLUSTER
             else runtime.OptArgs.from_env().numeric_dtype)
    f32 = Column.from_numpy(x, device="cpu").data
    if how == "init":
        th.init(device="cpu", numeric_dtype="bfloat16")
    elif how == "env":
        monkeypatch.setenv("H2O_TPU_NUMERIC_DTYPE", "bf16")
        th.init(device="cpu", args=runtime.OptArgs.from_env())
    else:
        th.init(device="cpu")
        th.cluster().args.numeric_dtype = "bfloat16"
    try:
        c = Column.from_numpy(x)
        assert c.data.dtype == torch.bfloat16
        assert c.device_nbytes * 2 == f32.numel() * f32.element_size()
        t = Column.from_numpy(np.arange(9, dtype=np.int64))
        assert t.ctype == "int" and t.data.dtype == torch.float32
        ts = Column.from_numpy(np.arange(3).astype("datetime64[s]"))
        assert ts.ctype == "time" and ts.data.dtype == torch.float32
        g = Column.from_numpy(np.array(["a", "b", None], object),
                              ctype="enum")
        assert g.data.dtype == torch.int8
        cl.args.numeric_dtype = "bfloat16"
        from h2o3_tpu.core.frame import Column as JColumn

        bits_equal(host(JColumn.from_numpy(x), len(x)), c.to_numpy())
    finally:
        # the dtypes found, not float32 (ROADMAP C45)
        cl.args.numeric_dtype = found[0]
        th.init(device="cpu", numeric_dtype=found[1])


@pytest.mark.parametrize("how", ["init", "env", "args"])
def test_unknown_numeric_dtype_raises(monkeypatch, how):
    th.init(device="cpu")
    with pytest.raises(ValueError, match="numeric_dtype"):
        if how == "init":
            th.init(device="cpu", numeric_dtype="float16")
        elif how == "env":
            monkeypatch.setenv("H2O_TPU_NUMERIC_DTYPE", "fp8")
            runtime.OptArgs.from_env()
        else:
            th.cluster().args.numeric_dtype = "half"
    assert th.cluster().args.numeric_dtype == "float32"
    assert Column.from_numpy(np.ones(3)).data.dtype == torch.float32


def _narrow_halves(cl):
    x = np.linspace(-3, 3, 1000)
    c = Column.from_numpy(x)
    assert c.data.dtype == torch.bfloat16
    x2 = x.copy()
    x2[7] = np.nan
    assert np.isnan(Column.from_numpy(x2).to_numpy()[7])
    assert abs(float(c.mean())) < 0.01


def _narrow_training(cl):
    rng = np.random.default_rng(3)
    n = 600
    X = rng.standard_normal((n, 4))
    yv = np.where(rng.random(n) < 1 / (1 + np.exp(-(2 * X[:, 0]))),
                  "Y", "N")
    fr = Frame.from_numpy(X, names=["a", "b", "c", "d"])
    fr.add("y", Column.from_numpy(yv, ctype="enum"))
    assert fr.col("a").data.dtype == torch.bfloat16
    m = th.GLM(family="binomial", seed=1).train(y="y", training_frame=fr)
    assert float(m._output.training_metrics.auc) > 0.7


def _narrow_memory(cl):
    x = np.random.default_rng(0).standard_normal(20000)
    th.cluster().args.numeric_dtype = "float32"
    f32 = Column.from_numpy(x).device_nbytes
    th.cluster().args.numeric_dtype = "bfloat16"
    assert Column.from_numpy(x).device_nbytes * 2 == f32


@pytest.mark.parametrize("case", [_narrow_halves, _narrow_training,
                                  _narrow_memory],
                         ids=["opt_in_halves_storage", "bf16_training",
                              "memory_halves_on_bench_frame"])
def test_narrow_dtypes_bf16_cases(bf16, case):
    """The cases of tests/test_narrow_dtypes.py::TestBf16Numeric on the
    port."""
    case(bf16)


def test_rollups_match_jax(bf16):
    from h2o3_tpu.core.frame import Column as JColumn

    rng = np.random.default_rng(5)
    x = rng.standard_normal(4096) * 3 + 1
    x[rng.random(4096) < 0.05] = np.nan
    x[:2] = [0.0, -0.0]
    jc, tc = JColumn.from_numpy(x), Column.from_numpy(x)
    jr, tr = jc.rollups, tc.rollups
    assert (tr.min, tr.max, tr.na_count, tr.nz_count, tr.rows) == \
        (jr.min, jr.max, jr.na_count, jr.nz_count, jr.rows)
    assert tr.mean == pytest.approx(jr.mean, rel=1e-6)
    assert tr.sigma == pytest.approx(jr.sigma, rel=1e-6)


# ---------------------------------------------------------------------------
# JAX's promotion, not torch's
# ---------------------------------------------------------------------------

_PROMO = ["bf16+scalar", "scalar/bf16", "bf16*bf16", "bf16-f32col",
          "bf16<scalar", "bf16>=bf16"]


@pytest.mark.parametrize("case", _PROMO)
def test_promotion_follows_jax(bf16, case):
    from h2o3_tpu.core.frame import Column as JColumn
    from h2o3_tpu.ops import elementwise as JE

    from h2o3_tpu_torch.ops import elementwise as E

    rng = np.random.default_rng(2)
    a, b = rng.standard_normal(512) * 3, rng.standard_normal(512)
    a[::17] = np.nan
    ja, ta = JColumn.from_numpy(a), Column.from_numpy(a)
    jb, tb = JColumn.from_numpy(b), Column.from_numpy(b)
    assert ta.data.dtype == torch.bfloat16
    if case == "bf16-f32col":
        bf16.args.numeric_dtype = "float32"
        th.cluster().args.numeric_dtype = "float32"
        jb, tb = JColumn.from_numpy(b), Column.from_numpy(b)
        assert tb.data.dtype == torch.float32
    s = 1.0009765625 + 2 ** -12         # not a bf16 value
    op, l, r = {"bf16+scalar": ("+", "a", s), "scalar/bf16": ("/", s, "a"),
                "bf16*bf16": ("*", "a", "b"), "bf16-f32col": ("-", "a", "b"),
                "bf16<scalar": ("<", "a", s),
                "bf16>=bf16": (">=", "a", "b")}[case]
    jmap, tmap = {"a": ja, "b": jb}, {"a": ta, "b": tb}
    jo = JE.binop(op, jmap.get(l, l), jmap.get(r, r))
    to = E.binop(op, tmap.get(l, l), tmap.get(r, r))
    assert to.data.dtype == torch.float32
    ref = host(jo, 512).astype(np.float32)
    got = to.to_numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got[~np.isnan(got)].view(np.uint32),
                                  ref[~np.isnan(ref)].view(np.uint32))
    if case == "bf16+scalar":
        # torch alone keeps bf16 for a 0-dim float32 operand
        naive = (ta.data + torch.tensor(np.float32(s))).float().numpy()
        assert not np.array_equal(naive[~np.isnan(naive)],
                                  got[~np.isnan(got)])


def test_unop_and_ifelse_keep_the_references_dtypes(bf16):
    from h2o3_tpu.core.frame import Column as JColumn
    from h2o3_tpu.ops import elementwise as JE

    from h2o3_tpu_torch.ops import elementwise as E

    rng = np.random.default_rng(4)
    a, b = rng.uniform(0.1, 9, 256), rng.standard_normal(256)
    ja, ta = JColumn.from_numpy(a), Column.from_numpy(a)
    jb, tb = JColumn.from_numpy(b), Column.from_numpy(b)
    # exp and log are held to an ulp, not bitwise, as on float32 (C2)
    for op in ("abs", "floor", "sqrt", "lgamma", "digamma"):
        jo, to = JE.unop(op, ja), E.unop(op, ta)
        assert to.data.dtype == torch.float32
        bits_equal(host(jo, 256), to.to_numpy(), op)
    jo, to = JE.ifelse(jb, ja, jb), E.ifelse(tb, ta, tb)
    assert to.data.dtype == torch.bfloat16
    assert str(np.asarray(jo.data).dtype) == "bfloat16"
    bits_equal(host(jo, 256), to.to_numpy(), "ifelse")


# ---------------------------------------------------------------------------
# binning, GBM, GLM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [37, 1000, 200_001])
def test_bin_edges_bitwise_vs_jax(bf16, n):
    from h2o3_tpu.models.tree.binning import BinSpec as JBinSpec

    from h2o3_tpu_torch.models.tree.binning import BinSpec

    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) * 3
    x[rng.random(n) < 0.05] = np.nan
    jf, tf = both_frames({"x": (x, None)})
    assert tf.col("x").data.dtype == torch.bfloat16
    je = JBinSpec.build(jf, ["x"], nbins=1024).edges[0]
    te = BinSpec.build(tf, ["x"], nbins=1024).edges[0]
    np.testing.assert_array_equal(te.view(np.uint32), je.view(np.uint32))
    # the float32 route (edges of the widened values) differs
    widened = Frame()
    widened.add("x", Column(tf.col("x").data.float(), "real", n))
    fe = BinSpec.build(widened, ["x"], nbins=1024).edges[0]
    assert len(fe) != len(te) or not np.array_equal(fe, te)
    binned = BinSpec.build(tf, ["x"], nbins=1024).bin_columns(tf)
    assert binned.shape == (n, 1)


@pytest.mark.parametrize("gaussian", [False, True],
                         ids=["bernoulli", "gaussian"])
def test_gbm_forest_bitwise_vs_jax(bf16, monkeypatch, gaussian):
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    jf, tf = both_frames(train_cols(n=640, gaussian=gaussian))
    assert tf.col("x").data.dtype == torch.bfloat16
    kw = dict(ntrees=3, max_depth=3, seed=3)
    jm = JGBM(**kw).train(y="y", training_frame=jf)
    tm = th.GBM(**kw).train(y="y", training_frame=tf)
    a, b = forest_arrays(jm.forest), forest_arrays(tm.forest)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(tm.forest.leaf_val,
                               np.asarray(jm.forest.leaf_val), atol=1e-6)
    jp, tp = jm.predict(jf), tm.predict(tf)
    for nm in tp.names:
        np.testing.assert_allclose(tp.col(nm).to_numpy(),
                                   host(jp.col(nm), 640), atol=1e-6,
                                   err_msg=nm)


def test_binomial_glm_matches_jax(bf16):
    from h2o3_tpu.models.glm import GLM as JGLM

    rng = np.random.default_rng(3)
    n = 640
    X = rng.standard_normal((n, 4))
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-2 * X[:, 0] + X[:, 1])),
                 "Y", "N")
    cols = {c: (X[:, i], None) for i, c in enumerate("abcd")}
    cols["y"] = (y, "enum")
    jf, tf = both_frames(cols)
    jm = JGLM(family="binomial", seed=1).train(y="y", training_frame=jf)
    tm = th.GLM(family="binomial", seed=1).train(y="y", training_frame=tf)
    jc, tc = jm.coef(), tm.coef()
    assert list(tc) == list(jc)
    np.testing.assert_allclose([tc[k] for k in jc], [jc[k] for k in jc],
                               **GLM_TOL)


def test_deeplearning_trains_from_bf16(bf16):
    rng = np.random.default_rng(8)
    n = 640
    x = rng.standard_normal((n, 3))
    fr = Frame.from_numpy(x, names=["a", "b", "c"])
    fr.add("y", Column.from_numpy(2 * x[:, 0] - x[:, 1]))
    assert fr.col("y").data.dtype == torch.bfloat16
    m = th.DeepLearning(hidden=[8], epochs=2, seed=1).train(
        y="y", training_frame=fr)
    p = m.predict(fr).col("predict").to_numpy()
    assert p.shape == (n,) and np.all(np.isfinite(p))


# ---------------------------------------------------------------------------
# ingest, Rapids fusion, scoring sessions
# ---------------------------------------------------------------------------

def test_csv_import_matches_jax(bf16, tmp_path):
    import h2o3_tpu

    rng = np.random.default_rng(9)
    n = 300
    p = tmp_path / "bf16.csv"
    with open(p, "w") as f:
        f.write("x,k,g\n")
        for i in range(n):
            v = "" if i % 23 == 0 else repr(float(rng.standard_normal()
                                                   * 1e3))
            f.write(f"{v},{i},{'ab'[i % 2]}\n")
    jf = h2o3_tpu.import_file(str(p))
    tf = th.import_file(str(p))
    assert jf.types == tf.types
    assert tf.col("x").data.dtype == torch.bfloat16
    for nm in ("x", "k"):
        assert tf.col(nm).data.dtype == (torch.bfloat16
                                         if tf.types[nm] == "real"
                                         else torch.float32)
        bits_equal(host(jf.col(nm), n), tf.col(nm).to_numpy(), nm)
    assert tf.col("g").domain == jf.col("g").domain


def test_fused_statement_bitwise_with_eager_under_its_own_signature(bf16):
    from h2o3_tpu.rapids import fusion as jfusion

    rng = np.random.default_rng(10)
    a, b = rng.standard_normal(1024), rng.standard_normal(1024)
    a[::31] = np.nan
    install_both("bf16_fuse.hex", {"a": (a, None), "b": (b, None)})
    bf16.args.numeric_dtype = "float32"
    th.cluster().args.numeric_dtype = "float32"
    install_both("f32_fuse.hex", {"a": (a, None), "b": (b, None)})
    stmt = ("(+ (* (cols {k} [0]) 3) (ifelse (> (cols {k} [1]) 0) "
            "(cols {k} [0]) (cols {k} [1])))")
    s = Both("bf16_fuse")
    try:
        sigs = {}
        for key in ("bf16_fuse.hex", "f32_fuse.hex"):
            st = stmt.format(k=key)
            from h2o3_tpu_torch.rapids import Env
            from h2o3_tpu_torch.rapids.parser import parse

            sigs[key] = fusion.plan_expr(parse(st), Env(s.t)).signature
            c0 = fusion.counters()["fused_programs"]
            with fusion.force(True):
                tf = th.exec_rapids(st, s.t)
            assert fusion.counters()["fused_programs"] > c0
            with fusion.force(False):
                te = th.exec_rapids(st, s.t)
            with jfusion.force(True):
                j = s.run(st)[0]
            x, y = tf.col(0).to_numpy(), te.col(0).to_numpy()
            assert tf.col(0).data.dtype == torch.float32
            np.testing.assert_array_equal(x.view(np.uint32),
                                          y.view(np.uint32))
            bits_equal(host(j.col(0), 1024), x, key)
        assert "bfloat16" in sigs["bf16_fuse.hex"]
        assert sigs["bf16_fuse.hex"] != sigs["f32_fuse.hex"]
    finally:
        s.end()


def test_scoring_session_stages_bf16_rows_in_programs_of_their_own(bf16):
    from h2o3_tpu_torch import scoring

    jf, tf = both_frames(train_cols(n=640))
    m = th.GBM(ntrees=3, max_depth=3, seed=3).train(y="y",
                                                    training_frame=tf)
    eager = m.predict(tf).col("Y").to_numpy()
    sess = scoring.session_for(m)
    got = sess.predict(tf).col("Y").to_numpy()
    np.testing.assert_array_equal(got.view(np.uint32), eager.view(np.uint32))
    assert {k[2] for k in sess._programs} == {torch.bfloat16}
    bf16.args.numeric_dtype = "float32"
    th.cluster().args.numeric_dtype = "float32"
    _jf, tf32 = both_frames(train_cols(n=640))
    sess.predict(tf32)
    assert {k[2] for k in sess._programs} == {torch.bfloat16, torch.float32}


@pytest.mark.gpu
def test_card_gbm_on_bf16_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch_port_support import flagship_cols

    cols = flagship_cols(20_000, seed=4)

    def fit(device):
        th.init(device=device, numeric_dtype="bfloat16")
        fr = Frame()
        for nm, (arr, ct) in cols.items():
            fr.add(nm, Column.from_numpy(arr, ctype=ct))
        assert fr.col("n0").data.dtype == torch.bfloat16
        m = th.GBM(ntrees=5, max_depth=5, seed=1).train(y="y",
                                                        training_frame=fr)
        return m, m.predict(fr).col("Y").to_numpy()

    found = (runtime._CLUSTER.args.numeric_dtype if runtime._CLUSTER
             else runtime.OptArgs.from_env().numeric_dtype)
    try:
        mc, pc = fit("cuda")
        mh, ph = fit("cpu")
    finally:
        th.init(device="cpu", numeric_dtype=found)
    a, b = forest_arrays(mh.forest), forest_arrays(mc.forest)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(pc, ph, atol=1e-6)


def test_rest_parse_and_frames_report_bf16_storage(bf16, tmp_path):
    """POST /3/ImportFiles -> /3/Parse respects the opt-in; /3/Frames
    reports the column as `real` and the 2 bytes a value it stores, and
    /3/Cloud the stored bytes."""
    from torch_rest_support import Rest

    p = tmp_path / "rest_bf16.csv"
    rng = np.random.default_rng(12)
    with open(p, "w") as f:
        f.write("x,g\n")
        for i in range(200):
            f.write(f"{rng.standard_normal()!r},{'ab'[i % 2]}\n")
    srv = th.start_server(port=0)
    try:
        rest = Rest(srv.port)
        _setup, key = rest.import_parse(str(p))
        fr = th.get_frame(key)
        assert fr.col("x").data.dtype == torch.bfloat16
        out = rest.json("GET", f"/3/Frames/{key}")["frames"][0]
        types = {c["label"]: c["type"] for c in out["columns"]}
        assert types == {"x": "real", "g": "enum"}
        assert out["byte_size"] == (2 + 4) * 200
        cloud = rest.json("GET", "/3/Cloud")
        assert cloud["nodes"][0]["mem_value_size"] >= 2 * 200
    finally:
        srv.stop()


def test_bf16_column_spills_and_faults_back_bitwise(bf16, monkeypatch,
                                                    tmp_path):
    from h2o3_tpu_torch.persist import spill

    monkeypatch.setattr(spill, "spill_dir", lambda: str(tmp_path))
    c = Column.from_numpy(num_fixture(512, seed=13))
    before = c.data.clone()
    assert spill.spill_column(c) == 512 * 2
    assert c.is_evicted
    assert c.data.dtype == torch.bfloat16
    assert torch.equal(c.data.view(torch.int16), before.view(torch.int16))


# ---------------------------------------------------------------------------
# faults a whole-suite run under the opt-in found (ROADMAP C39)
# ---------------------------------------------------------------------------

def _both_rapids(key, cols, expr):
    """(reference result, port result) of one statement on the same
    columns, eager in both."""
    from h2o3_tpu.core.frame import Column as JColumn
    from h2o3_tpu.core.frame import Frame as JFrame
    from h2o3_tpu.rapids import Session as JSession
    from h2o3_tpu.rapids import exec_rapids as jexec

    from h2o3_tpu_torch.rapids import Session, exec_rapids, planner

    jf, tf = JFrame(key=key), Frame(key=key)
    for name, v in cols.items():
        jf.add(name, JColumn.from_numpy(v))
        tf.add(name, Column.from_numpy(v))
    jf.install()
    tf.install()
    with fusion.force(False), planner.force(False):
        return jexec(expr, JSession("jb")), exec_rapids(expr, Session("tb"))


def test_scalar_arithmetic_under_the_opt_in_stays_float32(bf16):
    """Two scalar operands compute in float32 under the opt-in, in the
    port's eager path as in its fused programs, which fold them in
    float32 as the reference's do (the port's eager path once made its
    left operand a stored column, rounded to bf16, and parted from its
    fused result: tests/test_torch_fusion.py's chain 6). The
    reference's eager evaluation of a scalar statement still rounds it
    (ROADMAP C41)."""
    from h2o3_tpu_torch.rapids import Session, exec_rapids

    stmt = "(- -0.270 -1.511)"
    j_eager, t = _both_rapids("bfs.hex", {"x": np.arange(4.0)}, stmt)
    with fusion.force(True):
        t_fused = exec_rapids(stmt, Session("tf"))
    want = float(np.float32(-0.270) - np.float32(-1.511))
    assert t == float(t_fused) == want
    assert float(j_eager) == float(np.float32(
        float(torch.tensor(-0.270).to(torch.bfloat16)))
        - np.float32(-1.511))


@pytest.mark.parametrize("expr", ["(sinh (cols bfo.hex [0]))",
                                  "(cosh (cols bfo.hex [0]))",
                                  "(% (cols bfo.hex [0]) (cols bfo.hex [1]))",
                                  "(%% (cols bfo.hex [0]) (cols bfo.hex [1]))",
                                  "(% (cols bfo.hex [0]) 1.3)"])
def test_sinh_cosh_remainder_round_as_the_reference(bf16, expr):
    """sinh and cosh of a bf16 column, and the remainder of two bf16
    columns, are float32 results rounded to bf16 in the reference (XLA
    keeps those round trips); with a scalar divisor the remainder stays
    float32. The port's results are bitwise the reference's."""
    rng = np.random.default_rng(8)
    cols = {"a": rng.standard_normal(256) * 3,
            "b": rng.uniform(0.5, 2.0, 256)}
    j, t = _both_rapids("bfo.hex", cols, expr)
    got = t.col(t.names[0])
    assert got.data.dtype == torch.float32
    bits_equal(host(j.col(j.names[0]), 256), got.to_numpy(), expr)


def test_bf16_frame_exports_the_references_csv_bytes(bf16, tmp_path):
    """A bf16 column's CSV text is each value's float64 repr, the bytes
    pandas writes for the reference's ml_dtypes column (the port once
    wrote float32 reprs)."""
    from h2o3_tpu.core.frame import Column as JColumn
    from h2o3_tpu.core.frame import Frame as JFrame

    from h2o3_tpu_torch.api.server import frame_csv_bytes

    x = num_fixture(200, seed=5)
    x[np.isinf(x)] = 7.5
    jf, tf = JFrame(), Frame()
    jf.add("x", JColumn.from_numpy(x))
    tf.add("x", Column.from_numpy(x))
    path = tmp_path / "j.csv"
    jf.to_pandas().to_csv(path, index=False)
    assert frame_csv_bytes(tf) == path.read_bytes()


def test_bf16_frame_survives_a_control_plane_snapshot(bf16):
    """A bf16 frame pickles into a control-plane snapshot and restores
    bit for bit as bf16 (numpy has no bfloat16: the port once skipped
    such a frame, and a rejoined follower lacked it)."""
    from h2o3_tpu_torch.core.dkv import DKV

    fr = Frame(key="bf16_snap.hex")
    fr.add("x", Column.from_numpy(num_fixture(300, seed=9)))
    fr.install()
    want = fr.col("x").data.clone()
    snap = DKV.snapshot_control_plane()
    assert "bf16_snap.hex" not in snap["skipped"]
    # restore this frame only: the worker's other objects stay as they are
    snap["objects"] = {"bf16_snap.hex": snap["objects"]["bf16_snap.hex"]}
    DKV.remove("bf16_snap.hex")
    try:
        assert "bf16_snap.hex" in DKV.restore_control_plane(snap,
                                                            device="cpu")
        got = DKV.get("bf16_snap.hex").col("x").data
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    finally:
        DKV.remove("bf16_snap.hex")


# ---------------------------------------------------------------------------
# divergences under the opt-in, each its own ROADMAP C-item (C40-C44)
# ---------------------------------------------------------------------------

_XLA_STEPS = {
    # op: (input range, float64 truth or None)
    "asin": ((-0.95, 0.95), np.arcsin), "acos": ((-0.95, 0.95), np.arccos),
    "asinh": ((-6.0, 6.0), np.arcsinh), "acosh": ((1.05, 8.0), np.arccosh),
    "atanh": ((-0.9, 0.9), np.arctanh), "log2": ((0.1, 9.0), np.log2),
    "log10": ((0.1, 9.0), np.log10),
    "cospi": ((-0.45, 0.45), lambda v: np.cos(np.pi * v)),
    "sinpi": ((-0.45, 0.45), lambda v: np.sin(np.pi * v)),
    "tanpi": ((-0.45, 0.45), lambda v: np.tan(np.pi * v)),
    "trigamma": ((0.3, 9.0), None),
}


@pytest.mark.parametrize("op", sorted(_XLA_STEPS))
def test_c40_xla_bf16_steps_against_float32(bf16, op):
    """ROADMAP C40. For a bf16 column the reference's XLA lowering of
    these ops keeps bf16 steps (a bf16 pi, bf16 intermediates of its
    expansion), so its results stand a bf16 rounding or more from the
    true value; the port computes them in float32 from the exactly
    widened operand."""
    from h2o3_tpu_torch.ops import elementwise as E

    (lo, hi), truth = _XLA_STEPS[op]
    rng = np.random.default_rng(12)
    j, t = _both_rapids("bfu.hex", {"a": rng.uniform(lo, hi, 256)},
                        f"({op} (cols bfu.hex [0]))")
    x = th.DKV.get("bfu.hex").col("a").data.float()
    port = t.col(t.names[0]).to_numpy()
    np.testing.assert_array_equal(port, E.unop_expr(op, x).numpy())
    ref = host(j.col(j.names[0]), 256).astype(np.float64)
    gap = np.abs(ref - port) / (1.0 + np.abs(port))
    assert gap.max() > 1e-4, op                 # the reference's bf16 steps
    assert gap.max() < 0.05, op
    if truth is not None:
        want = truth(x.double().numpy())
        assert np.abs(port - want).max() < np.abs(ref - want).max(), op


def test_c41_reference_accumulates_a_bf16_cumsum_in_bf16(bf16):
    """ROADMAP C41. The reference's running sum of a bf16 column rounds
    every partial sum to bf16; the port sums the widened values in
    float32, within float32 rounding of the float64 running sum."""
    rng = np.random.default_rng(3)
    j, t = _both_rapids("bfc.hex", {"a": rng.uniform(0.5, 2.0, 512)},
                        "(cumsum (cols bfc.hex [0]) 0)")
    x = th.DKV.get("bfc.hex").col("a").data.double().numpy()
    want = np.cumsum(x)
    port = t.col(t.names[0]).to_numpy().astype(np.float64)
    ref = host(j.col(j.names[0]), 512).astype(np.float64)
    assert np.abs(port - want).max() <= 1e-6 * want[-1]
    assert np.abs(ref - want).max() > 1e-3 * want[-1]


def test_c41_reference_frame_methods_compute_in_bf16(bf16):
    """ROADMAP C41. The reference's H2OFrame methods apply jnp to the
    bf16 array (its log10 multiplies a bf16 log by a bf16 1/ln 10), while
    its Rapids path widens first; the port's method equals its Rapids
    path, float32 on the widened values, bit for bit."""
    import h2o3_tpu as jh

    from h2o3_tpu_torch.ops import elementwise as E

    rng = np.random.default_rng(6)
    b = rng.uniform(1.0, 40.0, 128)
    jb = jh.H2OFrame({"b": b.tolist()})["b"].log10()
    tb = th.H2OFrame({"b": b.tolist()})["b"]
    got = tb.log10()
    x = tb.col(tb.names[0]).data.float()
    want = E.unop_expr("log10", x).numpy()
    np.testing.assert_array_equal(got.col(got.names[0]).to_numpy(), want)
    ref = np.asarray(jb.col(jb.names[0]).to_numpy()).astype(np.float64)
    assert np.abs(ref - want).max() > 1e-3


@pytest.fixture(scope="module")
def bf16_gbm(cl):
    """A reference GBM on bf16 frames and the port's copy of its forest
    (tests/test_torch_explain.py's setup, 3 trees)."""
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    from h2o3_tpu_torch import convert
    from torch_port_support import carry_forest

    th.init(device="cpu")
    found = (cl.args.numeric_dtype, th.cluster().args.numeric_dtype)
    cl.args.numeric_dtype = "bfloat16"
    th.cluster().args.numeric_dtype = "bfloat16"
    try:
        rng = np.random.default_rng(5)
        n = 832
        x1, x2 = rng.standard_normal(n), rng.standard_normal(n)
        g = np.array(["a", "b"], object)[rng.integers(0, 2, n)]
        logit = 2.0 * x1 + 0.5 * x2 * (g == "a")
        y = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "Y", "N")
        w = rng.uniform(0.5, 2.0, n)
        jf, tf = both_frames({"x1": (x1, None), "x2": (x2, None),
                              "g": (g, "enum"), "y": (y, "enum"),
                              "w": (w, None)})
        jm = JGBM(ntrees=3, max_depth=3, seed=1).train(
            x=["x1", "x2", "g"], y="y", training_frame=jf)
        tm = convert.gbm_model_from_numpy(carry_forest(jm))
        yield jf, tf, jm, tm
    finally:
        # the dtypes found, not float32 (ROADMAP C45)
        cl.args.numeric_dtype, th.cluster().args.numeric_dtype = found


def test_c41_reference_sums_bf16_weights_in_bf16(bf16, bf16_gbm):
    """ROADMAP C41. A weighted partial dependence divides by the weight
    column's sum; the reference sums the bf16 weights in bf16 (its mean
    responses of a probability pass 1), the port in float32: each mean
    response is the float64 weighted mean of its own predictions."""
    jf, tf, jm, tm = bf16_gbm
    kw = dict(cols=["x2"], nbins=6, weight_column="w")
    ref = jm.partial_plot(jf, **kw)[0]
    got = tm.partial_plot(tf, **kw)[0]
    assert max(ref["mean_response"]) > 1.0
    w = tf.col("w").data.double().numpy()
    n = tf.nrows
    for v, mean in zip(got["values"], got["mean_response"]):
        fr = Frame()
        fr.add("x1", tf.col("x1"))
        fr.add("x2", Column(torch.full((n,), float(np.float32(v))),
                            "real", n))
        fr.add("g", tf.col("g"))
        p = tm.predict(fr).col("Y").data.double().numpy()
        assert mean == pytest.approx(np.average(p, weights=w), rel=1e-5)


def test_c42_reference_scores_a_grid_value_rounded_to_bf16(bf16,
                                                          bf16_gbm):
    """ROADMAP C42. A partial dependence lists its grid values in
    float64; the reference stores each into the bf16 column before
    scoring (so it scores the value rounded to bf16), the port scores
    the float32 value it lists. Their mean responses part exactly where
    the two roundings fall on two sides of a split."""
    jf, tf, jm, tm = bf16_gbm
    ref = jm.partial_plot(jf, cols=["x1"], nbins=8)[0]
    got = tm.partial_plot(tf, cols=["x1"], nbins=8)[0]
    assert got["values"] == pytest.approx(ref["values"])
    parted = [i for i, (a, b) in enumerate(zip(ref["mean_response"],
                                               got["mean_response"]))
              if abs(a - b) > 1e-6]
    assert parted
    for i in parted:
        v = got["values"][i]
        assert float(torch.tensor(v).to(torch.bfloat16)) != \
            float(np.float32(v))


def test_c43_reference_cannot_group_by_a_bf16_key(bf16):
    """ROADMAP C43. A group-by keyed on a bf16 numeric column raises in
    the reference (its key packing has no bf16 case); the port groups by
    the stored values, as a float64 grouping of them does."""
    from h2o3_tpu.ops.groupby import GroupBy as JGroupBy

    from h2o3_tpu_torch.ops.groupby import GroupBy as TGroupBy

    rng = np.random.default_rng(2)
    k = rng.integers(0, 7, 256) * 0.37
    x = rng.standard_normal(256)
    jf, tf = both_frames({"k": (k, None), "x": (x, None)})
    with pytest.raises(TypeError, match="bfloat16"):
        JGroupBy(jf, ["k"]).count().sum("x").get_frame()
    out = TGroupBy(tf, ["k"]).count().sum("x").get_frame()
    kk = tf.col("k").data.double().numpy()
    xx = tf.col("x").data.double().numpy()
    keys = np.unique(kk)
    np.testing.assert_array_equal(out.col("k").to_numpy(), keys)
    # the sums are stored by the opt-in: within a bf16 rounding
    np.testing.assert_allclose(out.col("sum_x").to_numpy(),
                               [xx[kk == u].sum() for u in keys],
                               rtol=2 ** -8, atol=1e-6)


def test_c41_reference_takes_tweedie_y_terms_in_bf16(bf16):
    """ROADMAP C41. A tweedie model's mean residual deviance: the
    reference raises the bf16 response to 2 - p with weak-typed
    constants, in bf16; the port widens y first (it once raised the bf16
    tensor in torch's bf16, another rounding again), so its deviance is
    the float64 tweedie deviance of its predictions to float32
    rounding."""
    from h2o3_tpu.models.glm import GLM as JGLM

    rng = np.random.default_rng(1)
    n = 640
    x1, x2 = rng.standard_normal(n), rng.uniform(-1, 1, n)
    mu0 = np.exp(0.4 * x1 - 0.3 * x2 + 0.5)
    y = rng.poisson(mu0) * rng.gamma(2.0, 0.5, n)
    jf, tf = both_frames({"x1": (x1, None), "x2": (x2, None),
                          "y": (y, None)})
    kw = dict(family="tweedie", tweedie_variance_power=1.2,
              tweedie_link_power=0.5)
    jm = JGLM(**kw).train(y="y", training_frame=jf)
    tm = th.GLM(**kw).train(y="y", training_frame=tf)
    p = 1.2
    yy = np.maximum(tf.col("y").data.double().numpy(), 0.0)
    mu = tm.predict(tf).col("predict").data.double().numpy()
    dev = np.mean(2 * (yy ** (2 - p) / ((1 - p) * (2 - p))
                       - yy * mu ** (1 - p) / (1 - p)
                       + mu ** (2 - p) / (2 - p)))
    tdev = tm._output.training_metrics.mean_residual_deviance
    jdev = jm._output.training_metrics.mean_residual_deviance
    assert tdev == pytest.approx(dev, rel=1e-5)
    assert abs(jdev - dev) > 1e-3 * dev


def test_c41_reference_dct_of_a_bf16_frame_runs_in_bf16(bf16):
    """ROADMAP C41. The reference's DCT basis is weak-typed, so a bf16
    frame's DCT is a bf16 matmul with a bf16-rounded basis; the port's
    is a float32 matmul of the widened columns."""
    from h2o3_tpu.api import routes_ext as JR
    from h2o3_tpu.api import server as JS
    from h2o3_tpu.core.dkv import DKV as JDKV

    from h2o3_tpu_torch.api import routes_ext as TR
    from h2o3_tpu_torch.api import server as TS

    rng = np.random.default_rng(4)
    cols = {f"c{i}": (rng.standard_normal(96) * 3, None) for i in range(4)}
    jf, tf = both_frames(cols)
    jf.install()
    tf.install()
    body = {"dataset": str(tf.key), "dimensions": [4, 1, 1],
            "destination_frame": "bf16_dct"}
    JR.h_dct_transformer(JS.Ctx({}, {}, dict(body, dataset=str(jf.key)),
                                None))
    TR.h_dct_transformer(TS.Ctx({}, {}, body, None))
    jd, td = JDKV.get("bf16_dct"), th.DKV.get("bf16_dct")
    X = torch.stack([tf.col(n).data.double() for n in tf.names], 1)
    k, m = np.arange(4)[None, :], np.arange(4)[:, None]
    basis = np.cos(np.pi * (2 * m + 1) * k / 8) * np.sqrt(2 / 4)
    basis[:, 0] /= np.sqrt(2)
    want = (X.numpy() @ basis)
    for j, nm in enumerate(td.names):
        assert td.col(nm).data.dtype == torch.float32
        np.testing.assert_allclose(td.col(nm).to_numpy(), want[:, j],
                                   rtol=1e-5, atol=1e-5)
        ref = np.asarray(jd.col(nm).to_numpy())
        assert str(ref.dtype) == "bfloat16"
    assert np.abs(np.asarray(jd.col(jd.names[1]).to_numpy(),
                             np.float64) - want[:, 1]).max() > 1e-3
    for k in ("bf16_dct", str(jf.key)):
        JDKV.remove(k)
    for k in ("bf16_dct", str(tf.key)):
        th.DKV.remove(k)


def test_c44_naive_bayes_probabilities_under_the_opt_in(bf16):
    """ROADMAP C44. NaiveBayes on bf16 frames: the tables agree as on
    float32, the probabilities to 2e-6 (one flagship row at 1.1e-6, past
    the float32 suite's 1e-6): each row's class log-likelihood is a sum
    of float32 transcendentals, XLA's and torch's an ulp apart."""
    from h2o3_tpu.models.naive_bayes import NaiveBayes as JNB

    from torch_port_support import flagship_cols

    jf, tf = both_frames(flagship_cols(640, seed=2))
    jm = JNB(laplace=1.0).train(y="y", training_frame=jf)
    tm = th.NaiveBayes(laplace=1.0).train(y="y", training_frame=tf)
    np.testing.assert_allclose(tm.num_means, jm.num_means, rtol=1e-6,
                               atol=1e-7)
    jp, tp = jm.predict(jf), tm.predict(tf)
    for nm in jp.names[1:]:
        np.testing.assert_allclose(tp.col(nm).data.numpy(),
                                   np.asarray(jp.col(nm).data)[:640],
                                   atol=2e-6)


def test_c11_saturated_logistic_diverges_in_both_under_bf16(bf16):
    """ROADMAP C11 under the opt-in: the saturated binomial IRLS still
    diverges in both packages (NaN deviance); they stop within one
    iteration of each other (9 and 10 on this fixture)."""
    from h2o3_tpu.models.glm import GLM as JGLM

    rng = np.random.default_rng(0)
    n, p = 640, 8
    X = rng.standard_normal((n, p))
    eta = X @ (4.0 * rng.standard_normal(p))
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "Y", "N")
    cols = {f"x{j}": (X[:, j], None) for j in range(p)}
    cols["y"] = (y, "enum")
    jf, tf = both_frames(cols)
    jm = JGLM(lambda_=0.0, max_iterations=10).train(y="y", training_frame=jf)
    tm = th.GLM(lambda_=0.0, max_iterations=10).train(y="y",
                                                       training_frame=tf)
    assert np.isnan(tm.residual_deviance) and np.isnan(jm.residual_deviance)
    assert abs(tm.iterations - jm.iterations) <= 1


def test_c6_sampled_xgboost_tie_under_bf16(bf16, monkeypatch):
    """ROADMAP C6 under the opt-in: XGBoost's sampled case (subsample
    0.7, colsample_bylevel 0.6) parts from the reference at an exact
    gain tie broken by rounding: a few nodes differ (the tie's, and
    those of later trees fitting the residuals it left), the predictions
    stay within 0.1 (0.065 on this fixture)."""
    from h2o3_tpu.models.xgboost import XGBoost as JXGB

    monkeypatch.setenv("H2O_TPU_PALLAS_HIST", "1")
    kw = dict(ntrees=3, nbins=32, gamma=0.0, seed=5, subsample=0.7,
              colsample_bylevel=0.6)
    jf, tf = both_frames(train_cols(n=640, seed=4))
    jm = JXGB(**kw).train(y="y", training_frame=jf)
    tm = th.XGBoost(**kw).train(y="y", training_frame=tf)
    a, b = forest_arrays(jm.forest), forest_arrays(tm.forest)
    assert a["feat"].shape == b["feat"].shape
    parted = (b["feat"] != a["feat"]) | (b["thresh_bin"] != a["thresh_bin"])
    # a few nodes part (the tie, and later trees fitting what it left);
    # the predictions stay close
    assert 1 <= int(parted.sum()) <= 8
    jp = np.asarray(jm.predict(jf).col("Y").to_numpy(), np.float64)
    tp = tm.predict(tf).col("Y").to_numpy().astype(np.float64)
    assert np.abs(jp[:640] - tp).max() < 0.1
