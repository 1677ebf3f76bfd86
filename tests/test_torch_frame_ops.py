"""The port's H2OFrame surface, DKV and frame ops (h2o3_tpu_torch/
frame_factory.py, core/dkv.py, ops/filters.py, ops/impute.py,
ops/quantile.py) against the JAX package's, on the CPU, after the
reference's test_frame_ops.py.

Tolerances: bit for bit for the operators, filters, slices, splits,
rbind/cbind, asfactor, medians and quantiles (the port's exact
quantile), group levels and counts, impute by mode and median, and
create_frame; 1e-5 relative for rollup means, sums and sds and group
sums and means (float32 sums in another order, ROADMAP C2). Row gathers
compare up to the sign of a zero (the reference's 8-device gathers sum
shards, so -0 comes back +0)."""

import numpy as np
import pytest

import h2o3_tpu_torch as th

from torch_port_support import assert_same


def _pair(data, key, column_types=None):
    from h2o3_tpu import H2OFrame as JH2OFrame

    th.init(device="cpu")
    return (JH2OFrame(data, destination_frame=key, column_types=column_types),
            th.H2OFrame(data, destination_frame=key,
                        column_types=column_types))


@pytest.fixture()
def fr(cl):
    return _pair({"a": [1.0, 2.0, 3.0, 4.0, 5.0],
                  "b": [10.0, 20.0, np.nan, 40.0, 50.0],
                  "c": ["x", "y", "x", "z", "y"]}, "ops.hex",
                 column_types={"c": "enum"})


def test_h2oframe_lives_in_the_dkv(fr):
    from h2o3_tpu.core.dkv import DKV as JDKV

    j, t = fr
    assert isinstance(t, th.H2OFrame) and t.frame_id == "ops.hex"
    assert th.DKV.get("ops.hex") is t and JDKV.get("ops.hex") is j
    assert "ops.hex" in th.ls()
    sub = t["a"]
    assert th.DKV.get(sub.key) is sub and sub.key != t.key
    t.delete()
    assert th.DKV.get("ops.hex") is None and "ops.hex" not in th.ls()
    with th.Scope():
        th.H2OFrame({"z": [1.0]}, destination_frame="scoped.hex")
        assert th.DKV.contains("scoped.hex")
    assert not th.DKV.contains("scoped.hex")
    assert th.DKV.atomic("ctr", lambda v: (v or 0) + 1) == 1
    assert th.DKV.atomic("ctr", lambda v: (v or 0) + 1) == 2
    assert th.DKV.write_lock("ctr") is th.DKV.write_lock("ctr")


@pytest.mark.parametrize("op", ["+", "-", "*", "/", "**", "%", "==", "!=",
                                "<", "<=", ">", ">=", "&", "|"])
def test_operators(fr, op):
    import operator

    fn = {"+": operator.add, "-": operator.sub, "*": operator.mul,
          "/": operator.truediv, "**": operator.pow, "%": operator.mod,
          "==": operator.eq, "!=": operator.ne, "<": operator.lt,
          "<=": operator.le, ">": operator.gt, ">=": operator.ge,
          "&": operator.and_, "|": operator.or_}[op]
    (ja, ta), (jb, tb) = ((f["a"] for f in fr), (f["b"] for f in fr))
    rtol = 1e-6 if op == "**" else None
    for x, y in (((ja, jb), (ta, tb)), ((ja, 2.0), (ta, 2.0)),
                 ((jb, 0.0), (tb, 0.0))):
        assert_same(fn(*x), fn(*y), rtol=rtol, ctx=op)
    if op in "+-*/":
        assert_same(fn(3.0, ja), fn(3.0, ta), ctx="r" + op)


def test_unary_methods_and_ifelse(fr):
    j, t = fr
    for m in ("abs", "exp", "log", "log10", "log1p", "sqrt", "floor", "ceil",
              "sign", "tanh", "isna"):
        exact = m in ("abs", "floor", "ceil", "sign", "isna")
        assert_same(getattr(j["b"], m)(), getattr(t["b"], m)(),
                    rtol=None if exact else 1e-6, ctx=m)
    assert_same((j["a"] > 3).ifelse(1.0, 0.0), (t["a"] > 3).ifelse(1.0, 0.0))
    assert_same((j["b"] > 15).ifelse(j["a"], j["b"]),
                (t["b"] > 15).ifelse(t["a"], t["b"]))
    assert_same(~(j["a"] > 2), ~(t["a"] > 2))


def test_selection_and_shapes(fr):
    j, t = fr
    for sel in ("a", 1, ["a", "c"], slice(1, 4), (slice(None, 2), "c"),
                (slice(0, 3), ["a", "b"]), ([4, 0, 2], "a")):
        assert_same(j[sel], t[sel], ctx=repr(sel))
    assert_same(j[j["a"] > 2], t[t["a"] > 2], zero_sign=False)
    assert_same(j[j["b"] > 15, ["a", "c"]], t[t["b"] > 15, ["a", "c"]],
                zero_sign=False)
    assert t[t["a"] > 2].col("c").domain == ["x", "y", "z"]
    assert_same(j.head(2), t.head(2), zero_sign=False)
    assert_same(j.tail(2), t.tail(2), zero_sign=False)
    assert_same(j.drop("b"), t.drop("b"))
    assert_same(j.cbind(j[["a"]]), t.cbind(t[["a"]]))
    assert_same(j.rbind(j), t.rbind(t), zero_sign=False)
    assert len(t) == 5 and t.nrow == 5 and t.ncol == 3


def test_rbind_unions_enum_domains(cl):
    j1, t1 = _pair({"g": ["b", "a", None]}, "rb1.hex", {"g": "enum"})
    j2, t2 = _pair({"g": ["c", "a"]}, "rb2.hex", {"g": "enum"})
    assert_same(j1.rbind(j2), t1.rbind(t2))
    assert t1.rbind(t2).col("g").domain == ["a", "b", "c"]


def test_reductions(fr):
    j, t = fr
    for name in ("min", "max", "nacnt", "median"):
        assert_same(getattr(j["b"], name)(), getattr(t["b"], name)(),
                    ctx=name)
    for name in ("mean", "sum", "sd"):
        assert_same(getattr(j[["a", "b"]], name)(),
                    getattr(t[["a", "b"]], name)(), rtol=1e-5, ctx=name)
    rng = np.random.default_rng(3)
    jq, tq = _pair({"x": rng.normal(size=5000)}, "q.hex")
    assert_same(jq["x"].median(), tq["x"].median())
    assert_same(jq["x"].quantile(prob=[0.25, 0.75]),
                tq["x"].quantile(prob=[0.25, 0.75]), ctx="quantile")
    jd, td = j.describe(), t.describe()
    assert jd.keys() == td.keys()
    for n in jd:
        for k, v in jd[n].items():
            assert_same(v, td[n][k], rtol=None if k in
                        ("type", "min", "max", "na_count", "cardinality")
                        else 1e-5, ctx=(n, k))


def test_split_frame_bitwise(cl):
    jf, tf = _pair({"x": np.arange(1000.0)}, "split.hex")
    for ratios, seed in (([0.8], 7), ([0.2, 0.5], 3)):
        for a, b in zip(jf.split_frame(ratios=ratios, seed=seed),
                        tf.split_frame(ratios=ratios, seed=seed)):
            assert_same(a, b, ctx=(ratios, seed))
    parts = tf.split_frame([0.5], destination_frames=["tr.hex", "te.hex"],
                           seed=1)
    assert th.DKV.get("te.hex") is parts[1]


def test_asfactor_levels_and_types(cl):
    j, t = _pair({"g": [1.0, 2.0, 1.0, 3.0], "h": [1.0, np.nan, 2.0, 2.0]},
                 "af.hex")
    assert_same(j["g"].asfactor(), t["g"].asfactor())
    assert_same(j["h"].asfactor(), t["h"].asfactor())
    assert t["g"].asfactor().nlevels() == [3]
    assert t["g"].asfactor().levels() == j["g"].asfactor().levels()
    assert_same(j["g"].asfactor().asnumeric(), t["g"].asfactor().asnumeric())


def test_groupby(fr):
    j, t = fr
    for build in (lambda f: f.group_by("c").count().sum("a").mean("a"),
                  lambda f: f.group_by(["c"]).min("b").max("b").sd("a")
                  .var("a"),
                  lambda f: f.group_by("a").count().mean("b")):
        assert_same(build(j).get_frame(), build(t).get_frame(), rtol=1e-5,
                    ctx="groupby")
    got = t.group_by("c").count().sum("a").get_frame()
    assert list(got.col("c").values()) == ["x", "y", "z"]
    assert list(got.col("nrow").to_numpy()) == [2, 2, 1]
    assert_same(j.table(), t.table())


@pytest.mark.parametrize("method", ["mean", "median", "mode"])
def test_impute(cl, method):
    data = {"b": [10.0, 20.0, np.nan, 40.0, 20.0],
            "c": ["x", None, "x", "z", "y"]}
    j, t = _pair(data, f"imp_{method}.hex", {"c": "enum"})
    assert_same(j.impute("b", method=method), t.impute("b", method=method),
                rtol=1e-6 if method == "mean" else None)
    assert_same(j.impute("c", method=method), t.impute("c", method=method))
    assert_same(j, t, rtol=1e-6 if method == "mean" else None)


def test_create_frame_bitwise(cl):
    from h2o3_tpu import create_frame as jcreate

    th.init(device="cpu")
    kw = dict(rows=100, cols=6, categorical_fraction=0.3, real_fraction=0.5,
              missing_fraction=0.05, seed=1, has_response=True)
    assert_same(jcreate(**kw), th.create_frame(**kw))


def test_import_file_installs_an_h2oframe(cl, tmp_path):
    from h2o3_tpu import import_file as jimport
    from h2o3_tpu.core.dkv import DKV as JDKV

    th.init(device="cpu")
    p = tmp_path / "x.csv"
    p.write_text("g,x\n" + "".join(f"g{i % 3},{i}\n" for i in range(60)))
    t = th.import_file(str(p), destination_frame="imp_csv.hex")
    j = jimport(str(p), destination_frame="imp_csv.hex")
    assert isinstance(t, th.H2OFrame) and th.DKV.get("imp_csv.hex") is t
    assert JDKV.get("imp_csv.hex") is j
    assert_same(j, t)
    t2 = th.import_file(str(p))
    assert th.DKV.get(t2.key) is t2
    assert_same(j["x"].mean(), t["x"].mean(), rtol=1e-6)
    assert_same(j.group_by("g").count().mean("x").get_frame(),
                t.group_by("g").count().mean("x").get_frame(), rtol=1e-6)
    assert_same(j[j["x"] > 30], t[t["x"] > 30], zero_sign=False)
