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
    """Both packages store T_NUM columns in bfloat16 for the test."""
    th.init(device="cpu")
    cl.args.numeric_dtype = "bfloat16"
    th.cluster().args.numeric_dtype = "bfloat16"
    yield cl
    cl.args.numeric_dtype = "float32"
    th.cluster().args.numeric_dtype = "float32"


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
        cl.args.numeric_dtype = "float32"
        th.init(device="cpu", numeric_dtype="float32")


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

    try:
        mc, pc = fit("cuda")
        mh, ph = fit("cpu")
    finally:
        th.init(device="cpu", numeric_dtype="float32")
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
