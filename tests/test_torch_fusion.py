"""The port's Rapids statement fusion (h2o3_tpu_torch/rapids/fusion.py)
against its own eager evaluator and against the JAX package's fusion
engine, on the CPU: the same seeded frame under one key in both DKVs.

Bit for bit (NaN equal to NaN), three ways: the port fused, the port
eager and the JAX package fused, over randomized chains of the exactly
rounded ops (+ - * /, comparisons, & |, ifelse, is.na, abs, floor,
ceiling, sign), the all-NA and enum paths and NA through a mask
multiply. Chains with exp, log and sqrt hold the port fused to the port
eager bit for bit; the JAX package's exp/log/sqrt differ in the last ulp
(ROADMAP C2), so those chains are not held to it. Sums agree with the
reference to 1e-5 (C2), gathered rows read -0 as +0 (C18) and the gamma
family agrees to 4e-6 (C17). A program's CUDA graph does not outlive the
process (C31). The `gpu` tests replay graphs on the card."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch.rapids import fusion, planner

from torch_port_support import Both, assert_same, install_both

FR = "fusion_t.hex"
N = 1024


def fusion_cols(n=N, seed=11):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n)
    a[rng.random(n) < 0.05] = np.nan
    c = rng.uniform(-2.0, 2.0, n)
    c[::37] = np.nan
    g = np.array(["x", "y", "z"], object)[rng.integers(0, 3, n)]
    g[::29] = None
    return {"a": (a, None), "b": (rng.standard_normal(n), None),
            "c": (c, None), "g": (g, "enum")}


@pytest.fixture(scope="module")
def fr(cl):
    install_both(FR, fusion_cols())
    return FR


@pytest.fixture()
def both(fr):
    s = Both("fusion_t")
    yield s
    s.end()


def _col(i):
    return f"(cols {FR} [{i}])"


def port_same(a, b, ctx=""):
    """Two port results agree bit for bit: frames in names, types and
    values (NaN equal to NaN), scalars in value."""
    if not isinstance(a, th.Frame):
        assert a == b or (a != a and b != b), (ctx, a, b)
        return
    assert a.names == b.names and a.types == b.types, (ctx, a.names,
                                                        b.names)
    for nm in a.names:
        x, y = a.col(nm).to_numpy(), b.col(nm).to_numpy()
        assert x.dtype == y.dtype, (ctx, nm)
        if x.dtype == np.float32:
            x, y = x.view(np.uint32), y.view(np.uint32)
        assert np.array_equal(x, y), (ctx, nm)


def _three(stmt, both):
    """(JAX fused, port fused, port eager) of one statement; the port's
    fused run must have run a fused program."""
    from h2o3_tpu.rapids import fusion as jfusion

    with jfusion.force(True):
        j = both.run(stmt)[0]
    p0 = fusion.counters()["fused_programs"]
    with fusion.force(True):
        tf = th.exec_rapids(stmt, both.t)
    assert fusion.counters()["fused_programs"] > p0, stmt
    with fusion.force(False):
        te = th.exec_rapids(stmt, both.t)
    return j, tf, te


_BINS = ["+", "-", "*", "/"]
_CMPS = ["<", ">", "<=", ">=", "==", "!="]
_EXACT_UNS = ["abs", "floor", "ceiling", "sign"]
_TRANS_UNS = ["abs", "sqrt", "floor", "ceiling", "sign", "exp", "log"]


def _gen(rng, depth, uns):
    """A random fusible statement over the frame's columns (the NA and
    enum ones included) and literals (the reference's generator)."""
    if depth <= 0:
        if rng.random() < 0.6:
            return _col(int(rng.integers(0, 4)))
        return f"{rng.uniform(-2, 2):.3f}"
    roll = rng.random()
    if roll < 0.35:
        op = _BINS[rng.integers(0, len(_BINS))]
        return f"({op} {_gen(rng, depth - 1, uns)} {_gen(rng, depth - 1, uns)})"
    if roll < 0.5:
        op = _CMPS[rng.integers(0, len(_CMPS))]
        return f"({op} {_gen(rng, depth - 1, uns)} {_gen(rng, depth - 1, uns)})"
    if roll < 0.62:
        op = "&" if rng.random() < 0.5 else "|"
        return f"({op} (> {_col(0)} 0) {_gen(rng, depth - 1, uns)})"
    if roll < 0.78:
        op = uns[rng.integers(0, len(uns))]
        return f"({op} (+ {_gen(rng, depth - 1, uns)} {_col(1)}))"
    if roll < 0.9:
        return (f"(ifelse (> {_col(int(rng.integers(0, 3)))} 0) "
                f"{_gen(rng, depth - 1, uns)} {_gen(rng, depth - 1, uns)})")
    return f"(is.na (+ {_col(0)} {_gen(rng, depth - 1, uns)}))"


def _stmt(seed, uns):
    rng = np.random.default_rng(seed)
    stmt = _gen(rng, int(rng.integers(2, 5)), uns)
    while not stmt.startswith("("):
        stmt = _gen(rng, 3, uns)
    return stmt


def test_prim_classification_is_the_references_and_closed(cl):
    from h2o3_tpu.rapids import fusion as jfusion

    from h2o3_tpu_torch.rapids.eval import PRIMS

    assert fusion.PRIM_FUSION == jfusion.PRIM_FUSION
    assert set(PRIMS) <= set(fusion.PRIM_FUSION)
    assert set(fusion.PRIM_FUSION.values()) <= fusion.FUSION_CLASSES
    assert fusion.ROOT_OPS == jfusion.ROOT_OPS


@pytest.mark.parametrize("seed", range(12))
def test_randomized_chain_bitwise_three_ways(seed, both):
    stmt = _stmt(seed, _EXACT_UNS)
    j, tf, te = _three(stmt, both)
    port_same(te, tf, ctx=stmt)
    assert_same(j, tf, ctx=stmt)


@pytest.mark.parametrize("seed", range(100, 106))
def test_randomized_transcendental_chain_fused_equals_eager(seed, both):
    stmt = _stmt(seed, _TRANS_UNS)
    with fusion.force(True):
        tf = th.exec_rapids(stmt, both.t)
    with fusion.force(False):
        te = th.exec_rapids(stmt, both.t)
    port_same(te, tf, ctx=stmt)


def test_signatures_are_the_references(both):
    """The same statement plans to the reference's program signature (the
    rewrite-edge split included), literals not part of it."""
    from h2o3_tpu.rapids import Env as JEnv
    from h2o3_tpu.rapids import fusion as jfusion
    from h2o3_tpu.rapids.parser import parse as jparse

    from h2o3_tpu_torch.rapids import Env
    from h2o3_tpu_torch.rapids.parser import parse

    for stmt in (f"(+ (* {_col(0)} 3) {_col(1)})",
                 f"(ifelse (> {_col(3)} 1) (/ {_col(2)} 3) (abs {_col(0)}))",
                 f"(- (* {_col(0)} 0.5) (^ {_col(1)} 2))",
                 f"(& (is.na {_col(3)}) (<= {_col(2)} 1))"):
        jp = jfusion.plan_expr(jparse(stmt), JEnv(both.j))
        tp = fusion.plan_expr(parse(stmt), Env(both.t))
        assert tp.signature == jp.signature, stmt
        assert tp.consts == [float(np.float32(v)) for v in jp.consts] or \
            tp.consts == jp.consts


def test_reducer_equivalence(both):
    for red in ("mean", "sum", "min", "max", "sd", "var", "naCnt", "any",
                "all"):
        stmt = f"({red} (* (+ {_col(0)} {_col(1)}) 0.5))"
        j, tf, te = _three(stmt, both)
        assert tf == te or (tf != tf and te != te), (red, tf, te)
        exact = red in ("min", "max", "naCnt", "any", "all")
        assert_same(j, tf, rtol=None if exact else 1e-5, scale=1.0,
                    ctx=red)


def test_rows_filter_equivalence(both):
    stmt = (f"(rows {FR} (& (> (+ {_col(0)} {_col(1)}) 0) "
            f"(< {_col(2)} 1)))")
    j, tf, te = _three(stmt, both)
    port_same(te, tf, ctx=stmt)
    assert_same(j, tf, ctx=stmt, zero_sign=False)        # C18


def test_all_na_and_enum_paths(cl):
    install_both("fusion_na.hex", {
        "a": (np.full(64, np.nan), None),
        "g": (np.asarray(["u", "v"] * 32, object), "enum")})
    s = Both("fusion_na")
    try:
        for stmt in ("(+ (cols fusion_na.hex [0]) 1)",
                     "(is.na (cols fusion_na.hex [0]))",
                     "(is.na (cols fusion_na.hex [1]))",
                     "(ifelse (is.na (cols fusion_na.hex [0])) "
                     "(cols fusion_na.hex [1]) 0)",
                     "(== (cols fusion_na.hex [1]) 1)"):
            j, tf, te = _three(stmt, s)
            port_same(te, tf, ctx=stmt)
            assert_same(j, tf, ctx=stmt)
    finally:
        s.end()


def test_mask_multiply_na_propagation(both):
    """0*NaN and 1*NaN stay NaN through a fused mask multiply."""
    for mask in (f"(is.na {_col(0)})", f"(== {_col(1)} 0)",
                 f"(& (> {_col(1)} 0) (< {_col(1)} 9))"):
        for stmt in (f"(* {mask} {_col(2)})",
                     f"(+ {_col(0)} (* {mask} {_col(2)}))"):
            j, tf, te = _three(stmt, both)
            port_same(te, tf, ctx=stmt)
            assert_same(j, tf, ctx=stmt)


def test_gamma_family_fused_within_c17(both):
    for op in ("lgamma", "digamma", "trigamma", "gamma"):
        stmt = f"({op} (+ (abs {_col(1)}) 0.25))"
        j, tf, te = _three(stmt, both)
        port_same(te, tf, ctx=stmt)
        if op == "gamma":
            j = np.log(np.abs(j.col(0).to_numpy().astype(np.float64)))
            tf = np.log(np.abs(tf.col(0).to_numpy().astype(np.float64)))
        assert_same(j, tf, rtol=4e-6, scale=1.0, ctx=stmt)


def test_assigned_statement_fuses(both):
    """(tmp= ...) fuses its right side: the evaluator offers the inner
    compute node (lazy deferral off: the eager-path contract)."""
    before = fusion.counters()["fused_programs"]
    with planner.force(False), fusion.force(True):
        out = th.exec_rapids(
            f"(tmp= fusion_assigned (* (+ {_col(0)} 1) 2))", both.t)
    assert fusion.counters()["fused_programs"] == before + 1
    with fusion.force(False):
        ref = th.exec_rapids(f"(* (+ {_col(0)} 1) 2)", both.t)
    port_same(ref, th.exec_rapids("fusion_assigned", both.t), "assigned")


def test_signature_cache_shares_programs_across_literals(both):
    with fusion.force(True):
        start = fusion.counters()
        th.exec_rapids(f"(+ (* {_col(0)} 3) {_col(1)})", both.t)
        c0 = fusion.counters()
        th.exec_rapids(f"(+ (* {_col(0)} 99) {_col(1)})", both.t)
        c1 = fusion.counters()
    assert c1["fused_programs_compiled"] == c0["fused_programs_compiled"]
    assert c1["compile_cache_hits"] > c0["compile_cache_hits"]
    assert (c1["fused_programs"] - c0["fused_programs"]
            == c0["fused_programs"] - start["fused_programs"] == 2)


def test_c31_programs_do_not_outlive_the_process(both, tmp_path,
                                                 monkeypatch):
    """ROADMAP C31: the reference reloads fused executables from its
    persistent compile cache, so a warm restart compiles none; a CUDA
    graph cannot be saved, so the port builds every program again after
    a restart (simulated by clearing the cache) and writes nothing to
    the cache directory."""
    monkeypatch.setenv("H2O_TPU_COMPILE_CACHE_DIR", str(tmp_path))
    stmt = f"(- (* {_col(2)} 2) {_col(1)})"
    fusion.clear_programs()
    with fusion.force(True):
        th.exec_rapids(stmt, both.t)
        fusion.clear_programs()
        c0 = fusion.counters()
        vf = th.exec_rapids(stmt, both.t)
        c1 = fusion.counters()
    assert c1["fused_programs_compiled"] - c0["fused_programs_compiled"] \
        == c1["fused_programs"] - c0["fused_programs"] == 2
    assert not any(tmp_path.iterdir())
    with fusion.force(False):
        ve = th.exec_rapids(stmt, both.t)
    port_same(ve, vf, ctx=stmt)


def test_failing_program_raises_instead_of_going_eager(both, monkeypatch):
    """No fallback hides the device: a program that fails raises."""
    def boom(self, *a, **k):
        raise RuntimeError("forced program failure")

    monkeypatch.setattr(fusion.GraphProgram, "run", boom)
    with fusion.force(True), pytest.raises(RuntimeError, match="forced"):
        th.exec_rapids(f"(+ {_col(0)} 1)", both.t)
    with fusion.force(False):
        th.exec_rapids(f"(+ {_col(0)} 1)", both.t)      # eager unaffected


def test_windowed_run_equals_single_run(both, monkeypatch):
    """A memory budget streams a plan in power-of-two windows; on exactly
    rounded ops the windows concatenate to the single run's bits."""
    big = th.Frame(key="fusion_big.hex")
    for name, (arr, ctype) in fusion_cols(20_000, 5).items():
        big.add(name, th.Column.from_numpy(arr, ctype=ctype))
    big.install()
    A, B, C = ("(cols fusion_big.hex [%d])" % i for i in range(3))
    stmt = f"(ifelse (> {A} 0) (* {B} 2) (- {C} 1))"
    with fusion.force(False):
        te = th.exec_rapids(stmt, both.t)
    monkeypatch.setenv("H2O_TPU_MEM_BUDGET_MB", "0.002")
    from h2o3_tpu_torch.memory import stream

    w0 = stream.counters()["windows"]
    with fusion.force(True):
        tf = th.exec_rapids(stmt, both.t)
    assert stream.counters()["windows"] - w0 > 1
    port_same(te, tf, ctx=stmt)
    big.delete()


def test_host_fallback_prims_are_counted(both):
    before = fusion.counters()["barrier_fallbacks"]
    th.exec_rapids(f"(toupper (cols {FR} [3]))", both.t)
    assert fusion.counters()["barrier_fallbacks"] == before + 1


def test_host_matrix_cells_are_counted(both):
    before = fusion.counters()["host_materialized_cells"]
    th.exec_rapids(f"(t (cols {FR} [0 1]))", both.t)
    assert fusion.counters()["host_materialized_cells"] >= before + 2 * N


def test_statement_counters_move(both):
    c0 = fusion.counters()
    with fusion.force(True):
        th.exec_rapids(f"(+ {_col(0)} {_col(1)})", both.t)
    c1 = fusion.counters()
    assert c1["statements"] == c0["statements"] + 1
    assert c1["fused_statements"] == c0["fused_statements"] + 1
    assert c1["fused_rows"] >= c0["fused_rows"] + N
    st = fusion.stats()
    assert st["enabled"] and "lazy" in st and "parse_cache" in st


def test_disabled_fusion_is_pure_eager(both):
    c0 = fusion.counters()["fused_programs"]
    with fusion.force(False):
        th.exec_rapids(f"(+ {_col(0)} 1)", both.t)
    assert fusion.counters()["fused_programs"] == c0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_frame(key, n=4096, seed=3):
    th.init()
    fr = th.Frame(key=key)
    for name, (arr, ctype) in fusion_cols(n, seed).items():
        fr.add(name, th.Column.from_numpy(arr, ctype=ctype))
    fr.install()
    return fr


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_graph_replay_bitwise_with_eager_on_card():
    """Each random chain runs fused twice (capture, then replay) and
    eagerly on the card: all bit for bit."""
    _card_frame(FR)
    s = th.Session("fusion_card")
    try:
        for seed in range(16):
            stmt = _stmt(seed, _TRANS_UNS)
            with fusion.force(True):
                a = th.exec_rapids(stmt, s).col(0).data.cpu().numpy()
                b = th.exec_rapids(stmt, s).col(0).data.cpu().numpy()
            with fusion.force(False):
                e = th.exec_rapids(stmt, s).col(0).data.cpu().numpy()
            for x in (a, b):
                assert np.array_equal(x.view(np.uint32), e.view(np.uint32)) \
                    or np.array_equal(x, e, equal_nan=True), stmt
        assert fusion.counters()["captures"] > 0
    finally:
        s.end()
        th.init(device="cpu")


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_capture_count_fixed_across_literals_on_card():
    _card_frame(FR)
    s = th.Session("fusion_card_lit")
    try:
        with fusion.force(True):
            th.exec_rapids(f"(ifelse (> {_col(0)} 0.5) (* {_col(1)} 2) "
                           f"(+ {_col(2)} 1))", s)
            c0 = fusion.counters()["captures"]
            outs = []
            for k in (0.1, 0.2, 0.7, 1.5):
                outs.append(th.exec_rapids(
                    f"(ifelse (> {_col(0)} {k}) (* {_col(1)} {k * 3}) "
                    f"(+ {_col(2)} {k}))", s).col(0).data.cpu().numpy())
            assert fusion.counters()["captures"] == c0
        with fusion.force(False):
            e = th.exec_rapids(f"(ifelse (> {_col(0)} 1.5) (* {_col(1)} "
                               f"{1.5 * 3}) (+ {_col(2)} 1.5))", s)
        assert np.array_equal(outs[-1], e.col(0).data.cpu().numpy(),
                              equal_nan=True)
    finally:
        s.end()
        th.init(device="cpu")
