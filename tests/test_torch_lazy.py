"""The port's lazy session planner (h2o3_tpu_torch/rapids/planner.py)
against the JAX package's, on the CPU: the same statements through both
packages' sessions over one seeded frame (NAs and an enum), each case of
the reference's TestLazySession (tests/test_rapids_fusion.py).

Results are bit for bit three ways (the port lazy, the port eager, the
JAX package lazy) on the exactly rounded ops, and the planner's counters
move by what the JAX package's move by for the same statements. Two
rules are the port's own: a program that fails while a flush runs raises
(the reference replays the node eagerly), and a flush entered from two
threads runs once. The cleaner never evicts a pending lazy column."""

import threading

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch.rapids import fusion, planner

from torch_port_support import Both, assert_same, install_both

FR = "lazy_t.hex"
N = 1024


@pytest.fixture(scope="module")
def fr(cl):
    rng = np.random.default_rng(11)
    a = rng.standard_normal(N)
    a[rng.random(N) < 0.05] = np.nan
    c = rng.uniform(-2.0, 2.0, N)
    c[::31] = np.nan
    g = np.array(["x", "y", "z"], object)[rng.integers(0, 3, N)]
    install_both(FR, {"a": (a, None), "b": (rng.standard_normal(N), None),
                      "c": (c, None), "g": (g, "enum")})
    return FR


def _col(i):
    return f"(cols {FR} [{i}])"


def _vals(fr):
    return np.asarray(fr.col(0).to_numpy(), np.float32)


def _bits_equal(a, b, ctx=""):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32)) or \
        np.array_equal(a, b, equal_nan=True), ctx


class _Run:
    """The same statements in each package: `lazy` pins the planner and
    fusion on (or off) in both; `delta` is each package's planner counter
    movement over the run."""

    def __init__(self, name):
        self.s = Both(name)

    def run(self, stmts, lazy=True, fuse=None):
        from h2o3_tpu.rapids import fusion as jfusion
        from h2o3_tpu.rapids import planner as jplanner

        from h2o3_tpu.rapids import exec_rapids as jexec

        fuse = lazy if fuse is None else fuse
        out = []
        j0, t0 = jplanner.counters(), planner.counters()
        with jplanner.force(lazy), jfusion.force(fuse), \
                planner.force(lazy), fusion.force(fuse):
            for st in stmts:
                if st.startswith("@"):          # observe a temp
                    key = st[1:]
                    j = jexec(key, self.s.j)
                    t = th.exec_rapids(key, self.s.t)
                    out.append((_vals(j), _vals(t)))
                else:
                    out.append(self.s.run(st))
        j1, t1 = jplanner.counters(), planner.counters()
        self.delta = ({k: j1[k] - j0[k] for k in j1},
                      {k: t1[k] - t0[k] for k in t1})
        return out

    def same_counters(self, *keys):
        jd, td = self.delta
        for k in keys or jd:
            assert jd[k] == td[k], (k, jd, td)

    def end(self):
        self.s.end()


_BINS = ["+", "-", "*", "/"]
_CMPS = ["<", ">", "<=", ">=", "==", "!="]
_UNS = ["abs", "floor", "ceiling", "sign"]


def _gen_chain(rng, n_stmts, prefix):
    """A random chained session (the reference's generator on the exactly
    rounded ops): tmp= statements over frame columns and earlier temps,
    with overwrites. Returns (statements, live keys)."""
    temps, stmts = [], []

    def leaf():
        roll = rng.random()
        if roll < 0.5:
            return _col(int(rng.integers(0, 3)))
        if roll < 0.8 and temps:
            return temps[int(rng.integers(0, len(temps)))]
        return f"{rng.uniform(-2, 2):.3f}"

    def expr(depth):
        if depth <= 0:
            l = leaf()
            return l if l.startswith("(") or l.lstrip("-")[0].isalpha() \
                else f"(+ {l} {_col(0)})"
        roll = rng.random()
        if roll < 0.45:
            return f"({_BINS[rng.integers(0, 4)]} {expr(depth - 1)} {leaf()})"
        if roll < 0.6:
            return f"({_CMPS[rng.integers(0, 6)]} {expr(depth - 1)} {leaf()})"
        if roll < 0.75:
            return f"({_UNS[rng.integers(0, 4)]} {expr(depth - 1)})"
        return (f"(ifelse (> {expr(depth - 1)} 0) {leaf()} "
                f"{expr(depth - 1)})")

    for i in range(n_stmts):
        if temps and rng.random() < 0.25:
            key = temps[int(rng.integers(0, len(temps)))]
        else:
            key = f"{prefix}_t{i}"
        stmts.append(f"(tmp= {key} {expr(int(rng.integers(1, 4)))})")
        if key not in temps:
            temps.append(key)
    return stmts, temps


@pytest.mark.parametrize("seed", range(8))
def test_randomized_chained_sessions_bitwise_and_counted(seed, fr):
    """A whole deferred session (CSE, dead temps from overwrites, inlined
    intermediates) equals eager evaluation for every live temp, bit for
    bit, in the port and against the JAX package, with the same planner
    counters."""
    rng = np.random.default_rng(1000 + seed)
    stmts, keys = _gen_chain(rng, int(rng.integers(3, 8)), f"lz{seed}")
    lazy, eager = _Run(f"lz{seed}"), _Run(f"le{seed}")
    try:
        got = lazy.run(stmts + [f"@{k}" for k in keys], lazy=True)
        lazy.same_counters()
        ref = eager.run(stmts + [f"@{k}" for k in keys], lazy=False)
        for k, (jv, tv), (_je, te) in zip(keys, got[len(stmts):],
                                          ref[len(stmts):]):
            _bits_equal(tv, te, (k, stmts))
            _bits_equal(jv, tv, (k, stmts))
    finally:
        lazy.end()
        eager.end()


def test_deferral_and_flush_counters(fr):
    r = _Run("lz_count")
    try:
        r.run([f"(tmp= lzc_a (+ {_col(0)} 1))", "(tmp= lzc_b (* lzc_a 2))"])
        r.same_counters()
        assert r.delta[1]["deferred_statements"] == 2
        assert r.delta[1]["deferred_pending"] == 2
        p0 = fusion.counters()["fused_programs"]
        (jv, tv), = r.run(["@lzc_b"])
        r.same_counters()
        assert r.delta[1]["flushes"] == 1
        assert r.delta[1]["deferred_pending"] == -2
        assert fusion.counters()["fused_programs"] > p0
        _bits_equal(jv, tv)
    finally:
        r.end()


def test_cse_dedup_identical_statements(fr):
    r = _Run("lz_cse")
    try:
        expr = f"(* (+ {_col(0)} {_col(1)}) 2)"
        out = r.run([f"(tmp= cse_a {expr})", f"(tmp= cse_b {expr})",
                     "@cse_a", "@cse_b"])
        r.same_counters()
        assert r.delta[1]["cse_hits"] == 1
        _bits_equal(out[2][1], out[3][1])
        _bits_equal(out[2][0], out[2][1])
    finally:
        r.end()


def test_dead_temp_is_never_computed(fr):
    r = _Run("lz_dead")
    try:
        p0 = fusion.counters()["fused_programs"]
        r.run([f"(tmp= dead_x (exp {_col(0)}))", "(rm dead_x)",
               f"(tmp= dead_y (+ {_col(1)} 1))", "@dead_y"])
        r.same_counters()
        assert r.delta[1]["dead_temps_eliminated"] == 1
        assert fusion.counters()["fused_programs"] - p0 == 1
    finally:
        r.end()


def test_overwrite_preserves_ssa_inputs(fr):
    r = _Run("lz_ssa")
    try:
        out = r.run([f"(tmp= ssa_w (+ {_col(0)} 1))",
                     "(tmp= ssa_w (* ssa_w 2))", "@ssa_w"])
        r.same_counters()
        with fusion.force(False), planner.force(False):
            base = th.exec_rapids(f"(* (+ {_col(0)} 1) 2)",
                                  th.Session("lz_ssa_ref"))
        _bits_equal(out[2][1], _vals(base))
        _bits_equal(out[2][0], out[2][1])
    finally:
        r.end()


def test_deferred_inputs_are_pinned(fr):
    s = th.Session("lz_pin")
    try:
        with planner.force(False), fusion.force(False):
            th.exec_rapids(f"(tmp= pin_src (+ {_col(0)} {_col(1)}))", s)
        src_col = s.temps["pin_src"].col(0)
        base_refs = s.column_refs(src_col)
        with planner.force(True), fusion.force(True):
            th.exec_rapids("(tmp= pin_out (* pin_src 3))", s)
            assert s.column_refs(src_col) == base_refs + 1
            th.exec_rapids("(rm pin_src)", s)
            out = _vals(th.exec_rapids("pin_out", s))
        assert s.column_refs(src_col) <= base_refs
        with planner.force(False), fusion.force(False):
            ref = th.exec_rapids(f"(* (+ {_col(0)} {_col(1)}) 3)",
                                 th.Session("lz_pin_ref"))
        _bits_equal(out, _vals(ref))
    finally:
        s.end()


def test_sort_selection_fuses_to_window(fr):
    """sort -> head over a dead sort temp runs as one windowed sort
    (counted as the reference counts it), equal to the eager path."""
    r = _Run("lz_topk")
    try:
        r.run([f"(tmp= tk_s (sort {FR} [0] [1]))",
               "(tmp= tk_h (rows tk_s [0:7]))", "(rm tk_s)"])
        c0 = planner.counters()["fused_sort_selections"]
        head = th.exec_rapids("tk_h", r.s.t)
        hv = {n: head.col(n).to_numpy() for n in head.names}
        assert planner.counters()["fused_sort_selections"] == c0 + 1
        from h2o3_tpu.rapids import exec_rapids as jexec
        from h2o3_tpu.rapids import planner as jplanner

        with jplanner.force(True):
            jhead = jexec("tk_h", r.s.j)
            jhead.col(0).to_numpy()
        with planner.force(False):
            ref = th.exec_rapids(f"(rows (sort {FR} [0] [1]) [0:7])",
                                 th.Session("lz_topk_ref"))
        assert head.nrows == ref.nrows == 7
        for n in ref.names:
            assert np.array_equal(hv[n], ref.col(n).to_numpy(),
                                  equal_nan=True), n
        assert_same(jhead, head, zero_sign=False)        # C18 gathers
    finally:
        r.end()


def test_observation_statement_flushes_first(fr):
    r = _Run("lz_obs")
    try:
        out = r.run([f"(tmp= obs_a (+ {_col(0)} 5))", "(mean obs_a)"])
        r.same_counters()
        assert planner.counters()["deferred_pending"] == 0
        with planner.force(False), fusion.force(False):
            ref = th.exec_rapids(f"(mean (+ {_col(0)} 5))",
                                 th.Session("lz_obs_ref"))
        m = out[1][1]
        assert m == ref or (m != m and ref != ref)
        assert_same(out[1][0], m, rtol=1e-5, scale=1.0)      # C2 sums
    finally:
        r.end()


def test_transparent_munges_keep_columns_pending(fr):
    r = _Run("lz_cbind")
    try:
        r.run([f"(tmp= tr_a (+ {_col(0)} 1))",
               f"(tmp= tr_f (cbind tr_a {_col(1)}))"])
        r.same_counters()
        assert r.delta[1]["transparent_statements"] == 1
        assert planner.counters()["deferred_pending"] >= 1
    finally:
        r.end()


def test_eager_replay_with_dead_intermediate_terminates(fr):
    """Fusion off: an rm'd single-reader intermediate replays eagerly
    without re-entering the flush."""
    r = _Run("lz_replay")
    try:
        out = r.run([f"(tmp= rp_a (+ {_col(0)} 1))",
                     "(tmp= rp_b (* rp_a 2))", "(rm rp_a)", "@rp_b"],
                    lazy=True, fuse=False)
        r.same_counters()
        assert r.delta[1]["eager_replays"] >= 1
        with planner.force(False), fusion.force(False):
            ref = th.exec_rapids(f"(* (+ {_col(0)} 1) 2)",
                                 th.Session("lz_replay_ref"))
        _bits_equal(out[3][1], _vals(ref))
    finally:
        r.end()


def test_failed_fused_execute_raises_without_recursion(fr, monkeypatch):
    """A program failing mid-flush (fusion on, inline set populated)
    raises at the observation, at once (no recursion), and is not turned
    into an eager replay; the DAG stays pending, and once the program
    works the same read flushes."""
    s = th.Session("lz_fail")
    try:
        with planner.force(True), fusion.force(True):
            th.exec_rapids(f"(tmp= rp2_a (+ {_col(0)} 1))", s)
            th.exec_rapids("(tmp= rp2_b (* rp2_a 2))", s)
            th.exec_rapids("(rm rp2_a)", s)
            real = fusion.execute_plan
            monkeypatch.setattr(
                fusion, "execute_plan",
                lambda plan: (_ for _ in ()).throw(
                    RuntimeError("forced execute failure")))
            e0 = planner.counters()["eager_replays"]
            with pytest.raises(RuntimeError, match="forced execute"):
                th.exec_rapids("rp2_b", s).col(0).to_numpy()
            assert planner.counters()["eager_replays"] == e0
            monkeypatch.setattr(fusion, "execute_plan", real)
            out = _vals(th.exec_rapids("rp2_b", s))
        with planner.force(False), fusion.force(False):
            ref = th.exec_rapids(f"(* (+ {_col(0)} 1) 2)",
                                 th.Session("lz_fail_ref"))
        _bits_equal(out, _vals(ref))
    finally:
        s.end()


def test_session_end_retires_without_compute(fr):
    r = _Run("lz_end")
    r.run([f"(tmp= end_a (log {_col(2)}))"])
    e0 = planner.counters()["eager_replays"]
    p0 = fusion.counters()["fused_programs"]
    d0 = planner.counters()["dead_temps_eliminated"]
    with planner.force(True):
        r.end()
    assert planner.counters()["dead_temps_eliminated"] == d0 + 1
    assert planner.counters()["eager_replays"] == e0
    assert fusion.counters()["fused_programs"] == p0


def test_flush_from_two_threads_runs_once(fr):
    """Readers on two threads observe the same pending temp: one flush
    runs, the other reader waits for it and reads the same tensor."""
    s = th.Session("lz_threads")
    try:
        with planner.force(True), fusion.force(True):
            th.exec_rapids(f"(tmp= th_a (abs (- {_col(0)} {_col(1)})))", s)
            fr_a = s.temps["th_a"]      # a bare read would flush here
            f0 = planner.counters()["flushes"]
            got, start = [], threading.Barrier(2)

            def read():
                start.wait()
                got.append(fr_a.col(0).data)

            ts = [threading.Thread(target=read) for _ in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        assert planner.counters()["flushes"] == f0 + 1
        assert got[0] is got[1]
    finally:
        s.end()


def test_cleaner_never_evicts_a_pending_column(fr):
    """A pending lazy column has no tensor: a sweep frees nothing from it
    and its first read still flushes once; after the flush an eviction
    copies it to the host and the fault-in runs no flush again."""
    from h2o3_tpu_torch.core import cleaner

    s = th.Session("lz_clean")
    try:
        with planner.force(True), fusion.force(True):
            out = th.exec_rapids(f"(tmp= cl_a (+ {_col(1)} 2))", s)
            col = out.col(0)
            assert col.evict() == 0
            cleaner.sweep(1 << 40)
            f0 = planner.counters()["flushes"]
            v = col.to_numpy().copy()
            assert planner.counters()["flushes"] == f0 + 1
            assert col.evict() > 0
            assert np.array_equal(col.to_numpy(), v, equal_nan=True)
            assert planner.counters()["flushes"] == f0 + 1
    finally:
        s.end()


_SWITCH_STMTS = [
    f"(tmp= sw_a (ifelse (> {_col(0)} 0) (* {_col(1)} 2) (- {_col(2)} 1)))",
    f"(tmp= sw_b (& (> sw_a 0) (is.na {_col(2)})))",
    f"(tmp= sw_c (+ sw_a (floor {_col(1)})))",
    f"(tmp= sw_s (sort {FR} [1] [-1]))",
    "(tmp= sw_h (rows sw_s [0:50]))",
    "@sw_b", "@sw_c", "(sum sw_c)", "(naCnt sw_b)",
]


@pytest.mark.parametrize("switches", ["all_on", "all_off"])
def test_statements_under_both_switch_settings(fr, switches):
    """The same statements with lazy sessions, fusion and pipeline splicing
    all on (the defaults) and all forced off: the port equals the JAX
    package (run the same way) either way."""
    from h2o3_tpu_torch import pipeline

    on = switches == "all_on"
    r = _Run(f"sw_{switches}")
    try:
        with pipeline.force(on):
            out = r.run(_SWITCH_STMTS, lazy=on)
        r.same_counters()
        for st, (j, t) in zip(_SWITCH_STMTS, out):
            if st.startswith("@"):
                _bits_equal(j, t, st)
            elif st.startswith("(sum"):
                assert_same(j, t, rtol=1e-5, scale=1.0, ctx=st)
            elif not st.startswith("(tmp="):
                assert_same(j, t, ctx=st)
        head = th.exec_rapids("sw_h", r.s.t)
        from h2o3_tpu.rapids import exec_rapids as jexec

        assert_same(jexec("sw_h", r.s.j), head, zero_sign=False)
    finally:
        r.end()
