"""The port's Rapids evaluator (h2o3_tpu_torch/rapids, ops/elementwise)
against the JAX package's, on the CPU: the same numpy frame under the
same key in both DKVs, the same Rapids strings through both evaluators.

Tolerances:
- bit for bit (NaN equal to NaN): the parser's ASTs; + - * /, the
  comparisons, & and |, ifelse, is.na, not, abs, floor, ceiling, round,
  trunc, sign, % and intDiv, over NA, +-0, 0 divisors and +-inf; cummin
  and cummax; nrow, ncol, min, max, naCnt, median and quantile (the
  port's exact quantile); compound statements (the reference fuses them
  into one program and holds that to its eager result); na.omit up to
  the sign of a zero (the reference's 8-shard gather turns -0 into +0);
- rtol 1e-6 of max(|value|, 0.1): sqrt, the transcendental unary prims
  and ^ (XLA's and torch's libm differ in the last ulp, ROADMAP C2);
- 4e-6 of max(|value|, 1): lgamma, digamma and trigamma, and gamma as
  log|gamma| (the port runs the reference's float32 Lanczos algorithm;
  log1p, log, sin and cos differ in the last ulp, and the reflection
  below 0.5 subtracts terms of order 1, ROADMAP C17);
- 1e-5 of the summed magnitudes: sum, mean, sd, var, the row-wise mean
  and cumsum/cumprod (float32 sums in another order, ROADMAP C2, C16).
One case per known trap: sign(NA), digamma(0), intDiv by 0."""

import numpy as np
import pytest

import h2o3_tpu_torch as th

from torch_port_support import Both, assert_close, assert_same, install_both

N = 200
BIT_BINOPS = ["+", "-", "*", "/", "%", "intDiv", "%%", "%/%", "==", "!=",
              "<", "<=", ">", ">=", "&", "|", "&&", "||"]
BIT_UNOPS = ["abs", "floor", "ceiling", "round", "trunc", "sign", "not",
             "is.na"]
TOL_UNOPS = ["sqrt", "exp", "log", "log2", "log10", "log1p", "expm1", "sin",
             "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
             "asinh", "acosh", "atanh", "cospi", "sinpi", "tanpi"]
GAMMA_UNOPS = ["lgamma", "digamma", "trigamma", "gamma"]


def px_cols(n=N, seed=0):
    """Numeric columns laced with NA, +-0, +-inf, 0 divisors, half-way
    values and the gamma family's poles; an enum with NA."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n) * 3
    b = rng.standard_normal(n) * 2
    a[:16] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 0.5, -0.5,
              2.5, -2.5, 1e-30, 3.0, -3.0, 7.5, -7.5]
    b[:16] = [0.0, 0.0, 2.0, -np.inf, 1.0, 0.0, -0.0, np.nan, 0.0, -2.0,
              2.0, -0.0, np.inf, -1.5, 2.0, -2.0]
    a[rng.random(n) < 0.05] = np.nan
    b[16:60:4] = 0.0
    pos = np.abs(rng.standard_normal(n)) * 4 + 0.01
    pos[:10] = [0.0, -0.0, -1.0, -2.0, -0.5, 1.0, 2.0, np.nan, 20.0, 1e-20]
    u = rng.uniform(-0.99, 0.99, n)
    u[:4] = [1.0, -1.0, 0.0, np.nan]
    g = np.array(["x", "y", "z"], object)[rng.integers(0, 3, n)]
    g[rng.random(n) < 0.1] = None
    c = rng.uniform(0.5, 2.0, n)
    return {"a": (a, None), "b": (b, None), "pos": (pos, None),
            "u": (u, None), "g": (g, "enum"), "c": (c, None)}


@pytest.fixture(scope="module")
def px(cl):
    install_both("px.hex", px_cols())
    return "px.hex"


@pytest.fixture()
def both(px):
    s = Both("t")
    yield s
    s.end()


def _col(i):
    return f"(cols px.hex [{i}])"


def test_parser_asts_equal():
    from h2o3_tpu.rapids.parser import parse as jparse

    from h2o3_tpu_torch.rapids.parser import parse as tparse

    def norm(x):
        if isinstance(x, list):
            return (type(x).__name__, [norm(v) for v in x])
        if hasattr(x, "__dataclass_fields__"):
            return (type(x).__name__, {k: norm(getattr(x, k))
                                       for k in x.__dataclass_fields__})
        if isinstance(x, float) and x != x:
            return "nan"
        return x

    for s in ["(+ (cols px.hex [0]) 5)", "(tmp= r1 (rows fr [0:4 7]))",
              "{ x y . (* x y) }", "['a' \"b\" c]", "[1 2 -3.5 TRUE NA]",
              "(GB fr [2] \"mean\" 0 \"all\")", "(rows fr [0:10])",
              "(sort fr [1 0] [1 -1])", "(toupper 'it\\'s')",
              "({x . (+ x 1)} 41)", "(is.na NaN)", "(, 1 2 3)"]:
        assert norm(tparse(s)) == norm(jparse(s)), s
    for bad in ["(+ 1 2", "[1 2", "{x . (+ x 1)", "'open", "(+ 1) 2"]:
        for parse in (jparse, tparse):
            with pytest.raises(ValueError):
                parse(bad)


@pytest.mark.parametrize("op", BIT_BINOPS)
def test_binops_bitwise(both, op):
    for lhs, rhs in [(_col(0), _col(1)), (_col(1), _col(0)),
                     (_col(0), "0"), (_col(0), "-0.5"), ("2.5", _col(1)),
                     (_col(4), _col(0)), (_col(0), "NA")]:
        expr = f"({op} {lhs} {rhs})"
        j, t = both.run(expr)
        assert_same(j, t, ctx=expr)
    if op[0] not in "&|":        # the reference's logic prims need a column
        j, t = both.run(f"({op} 7 2)")
        assert_same(j, t, ctx=op)


def test_pow_within_tolerance(both):
    for expr in [f"(^ {_col(2)} {_col(5)})", f"(^ {_col(0)} 2)",
                 f"(^ {_col(0)} {_col(1)})", f"(^ 2 {_col(3)})",
                 f"(^ {_col(0)} 0)"]:
        j, t = both.run(expr)
        assert_same(j, t, rtol=1e-6, scale=0.1, ctx=expr)


@pytest.mark.parametrize("op", BIT_UNOPS)
def test_unops_bitwise(both, op):
    for i in range(6):
        expr = f"({op} {_col(i)})"
        j, t = both.run(expr)
        assert_same(j, t, ctx=expr)


@pytest.mark.parametrize("op", TOL_UNOPS)
def test_transcendental_unops_within_tolerance(both, op):
    for i in (0, 1, 2, 3, 5):
        expr = f"({op} {_col(i)})"
        j, t = both.run(expr)
        assert_same(j, t, rtol=1e-6, scale=0.1, ctx=expr)


@pytest.mark.parametrize("op", GAMMA_UNOPS)
def test_gamma_family_within_tolerance(both, op):
    for i in (0, 1, 2, 3, 5):
        expr = f"({op} {_col(i)})"
        j, t = both.run(expr)
        if op == "gamma":
            with np.errstate(divide="ignore"):
                j, t = (np.log(np.abs(r.col(0).to_numpy()[:N]))
                        for r in (j, t))
        assert_same(j, t, rtol=4e-6, scale=1.0, ctx=expr)


def test_known_traps(both):
    """Where a literal translation to torch answers differently: sign
    of NA is NA (torch.sign gives 0), digamma at +-0 and the negative
    integers is NaN (torch gives +-inf), intDiv by 0 is NaN (torch gives
    +-inf) with the reference's signed zeros."""
    cases = {"(sign (cols px.hex [0]))": [4],
             "(digamma (cols px.hex [2]))": [0, 1, 2, 3],
             "(intDiv (cols px.hex [0]) (cols px.hex [1]))": [0, 1, 5, 8]}
    for expr, rows in cases.items():
        j, t = both.run(expr)
        tv = t.col(0).to_numpy()
        assert np.isnan(tv[rows]).all(), (expr, tv[rows])
        assert_same(j, t, rtol=None if "digamma" not in expr else 4e-6,
                    scale=1.0, ctx=expr)
    j, t = both.run("(intDiv (cols px.hex [0]) 3)")
    bits = t.col(0).to_numpy()[:2].view(np.int32)
    assert_same(j, t)
    assert list(bits) == list(np.float32([0.0, 0.0]).view(np.int32))


def test_ifelse_and_logic_bitwise(both):
    A, B, C = _col(0), _col(1), _col(5)
    for expr in [f"(ifelse (> {A} 0) {B} {C})", f"(ifelse {A} 1 0)",
                 f"(ifelse (is.na {A}) -1 {A})",
                 f"(& (> {A} 0) (is.na {B}))", f"(| (> {A} 0) (< {B} 0))",
                 f"(& {A} 0)", f"(| {B} 1)", f"(not {A})",
                 f"(== {_col(4)} 'x')", f"(!= {_col(4)} 'y')"]:
        j, t = both.run(expr)
        assert_same(j, t, ctx=expr)
    j, t = both.run("(na.omit px.hex)")
    assert_same(j, t, zero_sign=False)


def test_compound_statements_bitwise(both):
    """The reference's benchmark statements (h2o3_tpu/bench.py :288-297)
    and other chains, which the reference fuses into single programs."""
    A, B, C = _col(0), _col(1), _col(5)
    clip = f"(ifelse (> {A} 2) 2 (ifelse (< {A} -2) -2 {A}))"
    flags = (f"(& (| (> {B} 0.25) (< {C} 1)) "
             f"(& (== (is.na {A}) 0) (>= {B} -3)))")
    binned = (f"(ifelse (< {A} -1) 0 (ifelse (< {A} 0) 1 "
              f"(ifelse (< {A} 1) 2 (ifelse (< {A} 2) 3 4))))")
    for expr in [f"(ifelse {flags} (+ {clip} {binned}) (- {binned} {clip}))",
                 f"(- (+ (abs (- (* {A} 0.5) {C})) (* {B} 0.25)) "
                 f"(* {A} 0.125))",
                 f"(/ (- {A} (* {B} {C})) (+ {C} 1))",
                 f"(floor (* (+ {A} {B}) 0.5))"]:
        j, t = both.run(expr)
        assert_same(j, t, ctx=expr)
    expr = f"(sum (ifelse (> (+ {A} {B}) 0) (- {C} 0.5) (+ {C} 0.5)))"
    j, t = both.run(expr)
    assert_close(j, t, 1e-5, scale=2.5 * N)


def test_reducers(both):
    for expr in ["(nrow px.hex)", "(ncol px.hex)",
                 f"(min {_col(1)})", f"(max {_col(5)})", "(max px.hex)",
                 f"(naCnt {_col(0)})", "(naCnt px.hex)",
                 f"(median {_col(5)})", f"(median {_col(0)})",
                 "(quantile px.hex [0.1 0.5 0.9] 'interpolated' _)",
                 f"(any (> {_col(5)} 1.9))", f"(all (> {_col(5)} 0))"]:
        j, t = both.run(expr)
        assert_same(j, t, ctx=expr)
    c = px_cols()["c"][0].astype(np.float32)
    for expr, scale in [(f"(sum {_col(5)})", np.abs(c).sum()),
                        (f"(mean {_col(5)})", np.abs(c).mean()),
                        (f"(sd {_col(5)})", 0.0), (f"(var {_col(5)})", 0.0),
                        ("(mean px.hex 1 0)", 5.0),
                        ("(mean (cols px.hex [2 3 5]) 1 1)", 5.0),
                        ("(sumaxis (cols px.hex [2 3 5]) 1 1)", 10.0)]:
        j, t = both.run(expr)
        assert_same(j, t, rtol=1e-5, scale=scale, ctx=expr)


def test_cumulative(both):
    for op in ("cummin", "cummax"):
        for i in (0, 1, 5):
            j, t = both.run(f"({op} {_col(i)} 0)")
            assert_same(j, t, ctx=op)
    c = px_cols()["c"][0].astype(np.float64)
    a = np.nan_to_num(px_cols()["b"][0].astype(np.float64), posinf=0,
                      neginf=0)
    j, t = both.run(f"(cumsum {_col(5)} 0)")
    assert_close(j.col(0).to_numpy()[:N], t.col(0).to_numpy(), 1e-5,
                 scale=np.cumsum(np.abs(c)).max())
    j, t = both.run(f"(cumsum {_col(1)} 0)")
    assert_same(j, t, rtol=1e-5, scale=np.abs(a).sum())
    j, t = both.run(f"(cumprod {_col(5)} 0)")
    assert_same(j, t, rtol=1e-5)


def test_assign_rm_and_refcounts(px):
    """tmp= installs a temp under its key in the DKV, rm drops it at
    once, the refcounts of aliased columns follow in both packages, and
    Session.end drops every temp."""
    from h2o3_tpu.core.dkv import DKV as JDKV

    s = Both("rc")
    j, t = s.run("(tmp= rc1 (cols_py px.hex [0]))")
    s.run("(tmp= rc2 (cols_py px.hex [0 1]))")
    assert th.DKV.get("rc1") is t and JDKV.get("rc1") is j
    tcol = th.DKV.get("px.hex").col("a")
    jcol = JDKV.get("px.hex").col("a")
    assert s.t.column_refs(tcol) == s.j.column_refs(jcol) == 2
    s.run("(rm rc1)")
    assert s.t.column_refs(tcol) == s.j.column_refs(jcol) == 1
    assert th.DKV.get("rc1") is None and JDKV.get("rc1") is None
    s.run("(tmp= rc2 (cols_py px.hex [1]))")          # reassignment
    assert s.t.column_refs(tcol) == s.j.column_refs(jcol) == 0
    assert s.t.column_refs(th.DKV.get("px.hex").col("b")) == 1
    s.end()
    assert th.DKV.get("rc2") is None and JDKV.get("rc2") is None
    assert s.t.refcnt == {} and s.j.refcnt == {}


def test_lambdas_and_errors(both):
    for expr in ["({x . (+ x 1)} 41)", "({x y . (* x y)} 6 7)",
                 "(apply (cols px.hex [2 5]) 2 { x . (sd x) })",
                 "(ddply px.hex [4] { x . (mean (cols_py x \"c\") True 0) })"]:
        j, t = both.run(expr)
        assert_same(j, t, rtol=1e-5, ctx=expr)
    from h2o3_tpu.rapids import exec_rapids as jexec

    for expr, err in [("(nosuchprim 1)", ValueError),
                      ("({x . (+ x 1)} 1 2)", ValueError),
                      ("(+ nosuchkey 1)", KeyError)]:
        with pytest.raises(err):
            jexec(expr, both.j)
        with pytest.raises(err):
            th.exec_rapids(expr, both.t)
