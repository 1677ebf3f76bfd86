"""Munging on row-sharded frames (h2o3_tpu_torch/parallel/mesh.py's
`all_to_all`, core/sharded_frame.py's row exchange, ops/{filters,sort,
merge,groupby,quantile}.py, the Rapids prims they serve): ranks run as
threads of this process (`run_ranks`, one gloo group each), R = 2, 3
and 4.

Tolerances: bit for bit against one process of the port for every
result (values, row order, types, domains; the Rapids mean, sum, sd and
var read the cloud's rollups, within 1e-6 as ROADMAP C46), each rank
holding its
`mesh.row_block` of the output, with ``gathered_rows`` 0 through the
op; against the JAX package (its 8-device CPU mesh) at the one-process
parity tests' tolerances: bit for bit for row selections, joins, group
levels, counts, min and max (up to the sign of a zero, which its
shard-summing gathers lose), sums and means to 1e-5 relative (ROADMAP
C2), and the sorted key column bit for bit where its sample sort runs
(`sample_sort_order`, whose ties need not keep their row order)."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch.core import sharded_frame as SF
from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.ops import filters as FL
from h2o3_tpu_torch.parallel import mesh as M

from test_torch_sharded import run_ranks
from torch_port_support import assert_same, both_frames


@pytest.fixture(autouse=True)
def _port_cpu():
    """The port on the CPU; what a test leaves in the DKV (Rapids
    results, models, their ranks' frames) is removed after it."""
    th.init(device="cpu")
    before = set(th.DKV.keys())
    yield
    for k in set(th.DKV.keys()) - before:
        th.DKV.remove(k)


def _cols(n=203, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x[::7] = np.nan
    x[3], x[5], x[11] = -0.0, 0.0, np.inf
    k = rng.integers(0, 5, n).astype(np.float32)
    g = np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)]
    g[::17] = None
    s = np.array([f"s{i}" for i in range(n)], object)
    return {"x": (x, None), "k": (k, None), "g": (g, "enum"),
            "s": (s, None)}


def _frame(cols, key=None):
    fr = Frame(key=key)
    for nm, (a, ct) in cols.items():
        fr.add(nm, Column.from_numpy(a, ctype=ct))
    return fr


def _local(fr):
    """(nrows, shard, {name: (ctype, domain, this rank's values)})."""
    out = {}
    for nm in fr.names:
        c = fr.col(nm)
        v = (c.data.numpy().copy() if c.data is not None
             else np.asarray(c.host_data, object))
        out[nm] = (c.ctype, c.domain, v)
    return fr.nrows, fr.shard, out


def _same_block(one, got, R, r, ctx):
    """A rank's block equals one process's rows of that block, bitwise."""
    n1, _sh, c1 = one
    n2, sh2, c2 = got
    assert n1 == n2, (ctx, n1, n2)
    lo, hi = M.row_block(n1, r, R)
    assert tuple(sh2) == (lo, hi), (ctx, sh2, lo, hi)
    assert list(c1) == list(c2), ctx
    for nm in c1:
        t1, d1, v1 = c1[nm]
        t2, d2, v2 = c2[nm]
        assert (t1, d1) == (t2, d2), (ctx, nm, t1, t2)
        a = v1[lo:hi]
        if a.dtype == object:
            assert list(a) == list(v2), (ctx, nm)
        else:
            assert np.array_equal(a.view(np.uint8), v2.view(np.uint8)), \
                (ctx, nm, a, v2)


def _check_ranks(fn, one_fn, R, ctx=""):
    """fn(frame) on R thread ranks, one_fn's one-process result; every
    rank's block bitwise, and no rank gathered a row."""
    one = one_fn()

    def rank(r, m):
        before = SF.counters()["gathered_rows"]
        got = fn()
        return got, SF.counters()["gathered_rows"] - before

    outs = run_ranks(R, rank)
    for r, (got, gathered) in enumerate(outs):
        assert gathered == 0, ctx
        if isinstance(one, dict):
            for k in one:
                _same_block(one[k], got[k], R, r, (ctx, k))
        else:
            _same_block(one, got, R, r, ctx)


# -- the exchange ---------------------------------------------------------------

@pytest.mark.parametrize("R", [2, 3])
def test_all_to_all_moves_rows_by_split_sizes(R):
    def rank(r, m):
        counts = [(r + d) % 3 for d in range(R)]
        rows = torch.arange(sum(counts) * 2, dtype=torch.float32
                            ).reshape(-1, 2) + 100 * r
        got, recv = m.all_to_all(rows, counts)
        st = m.stats()
        return counts, rows, got, recv, st

    outs = run_ranks(R, rank)
    for d in range(R):
        _c, _rows, got, recv, st = outs[d]
        want, wc = [], []
        for s in range(R):
            counts, rows = outs[s][0], outs[s][1]
            at = sum(counts[:d])
            want.append(rows[at:at + counts[d]])
            wc.append(counts[d])
        assert recv == wc
        assert torch.equal(got, torch.cat(want))
        assert st["exchanges"] == 1
        sent_off = sum(c for i, c in enumerate(outs[d][0]) if i != d)
        assert st["exchange_bytes"] == sent_off * 8


def test_a_lost_peer_ends_the_exchange_not_a_hang():
    from h2o3_tpu_torch.core.failure import CloudUnhealthyError

    def rank(r, m):
        m.barrier()                 # the group is built, then rank 1 leaves
        if r == 0:
            with pytest.raises(CloudUnhealthyError, match="all_to_all"):
                m.all_to_all(torch.ones(2), [1, 1])
            return m.store.get("h2o3/mesh/generation")
        return None

    assert run_ranks(2, rank, timeout_s=1.0)[0] == b"1"


@pytest.mark.parametrize("R", [2, 3, 4])
def test_take_global_rows_moves_every_column_kind(R):
    cols = _cols(61)
    t = np.arange(61, dtype=np.int64) * 86_400_000
    ids = np.array([60, 0, 5, 5, 33, 17, 59, 1, 2, 40, 41])

    def make():
        fr = _frame(cols)
        fr.add("t", Column.from_numpy(t.astype("datetime64[ms]")))
        return fr

    def one():
        return _local(FL.take_rows(make(), ids))

    SF.reset_counters()
    _check_ranks(lambda: _local(FL.take_rows(make(), ids)), one, R, "take")
    assert SF.counters()["exchanged_rows"] > 0
    assert SF.counters()["exchanged_bytes"] > 0


# -- filters, slices, rbind, splits ------------------------------------------------

def _munge(cols):
    fr = _frame(cols)
    k = cols["k"][0]
    f = FL.filter_rows(fr, Column.from_numpy((k > 2).astype(np.float32)))
    return {"filter": _local(f),
            "slice": _local(FL.slice_rows(fr, 10, 150)),
            "take": _local(FL.take_rows(fr, np.array([5, 200, 3, 3, 0]))),
            "order": _local(FL.take_order_rows(
                fr, torch.arange(fr.nrows - 1, -1, -1), 20, offset=7)),
            "split": [_local(p) for p in FL.split_frame(fr, [0.3, 0.5],
                                                        seed=4)],
            "rbind": _local(FL.rbind([fr, f])),
            "empty": _local(FL.filter_rows(fr, Column.from_numpy(
                np.zeros(len(k), np.float32))))}


@pytest.mark.parametrize("R", [2, 3, 4])
def test_filters_slices_rbind_and_splits_are_one_process(R):
    cols = _cols()
    one = _munge(cols)

    def rank(r, m):
        before = SF.counters()["gathered_rows"]
        got = _munge(cols)
        return got, SF.counters()["gathered_rows"] - before

    for r, (got, gathered) in enumerate(run_ranks(R, rank)):
        assert gathered == 0
        for k in one:
            if k == "split":
                for a, b in zip(one[k], got[k]):
                    _same_block(a, b, R, r, k)
            else:
                _same_block(one[k], got[k], R, r, k)


def test_split_and_filter_against_the_jax_package(cl):
    from h2o3_tpu.ops import filters as JFL

    cols = {k: v for k, v in _cols(256).items() if k != "s"}
    jf, _tf = both_frames(cols)
    jparts = JFL.split_frame(jf, [0.25, 0.5], seed=9)
    jmask = (cols["k"][0] > 1).astype(np.float32)
    from h2o3_tpu.core.frame import Column as JColumn

    jfilt = JFL.filter_rows(jf, JColumn.from_numpy(jmask))

    def rank(r, m):
        fr = _frame(cols)
        parts = FL.split_frame(fr, [0.25, 0.5], seed=9)
        filt = FL.filter_rows(fr, Column.from_numpy(jmask))
        # gathered for the comparison only
        return [_gathered(p) for p in parts], _gathered(filt)

    for parts, filt in run_ranks(2, rank):
        for jp, tp in zip(jparts, parts):
            assert_same(jp, tp, zero_sign=False, ctx="split")
        assert_same(jfilt, filt, zero_sign=False, ctx="filter")


def _gathered(fr):
    """A one-process copy of a sharded frame (gathers every column)."""
    out = Frame()
    for nm in fr.names:
        c = fr.col(nm)
        vals = c.to_numpy()
        with M.use(None):
            if c.data is None:
                col = Column(None, c.ctype, c.nrows,
                             host_data=np.asarray(vals, object))
            else:
                col = Column(torch.from_numpy(np.ascontiguousarray(vals))
                             .to(c.data.dtype), c.ctype, c.nrows,
                             domain=c.domain)
        out.add(nm, col)
    return out


def test_row_selections_rbind_and_table_against_the_jax_package(cl):
    from h2o3_tpu.core.frame import Column as JColumn
    from h2o3_tpu.ops import filters as JFL
    from h2o3_tpu.ops.groupby import table as jtable

    from h2o3_tpu_torch.ops.groupby import table

    cols = {k: v for k, v in _cols(256, seed=5).items() if k != "s"}
    jf, _tf = both_frames(cols)
    ids = np.array([5, 200, 3, 3, 0, 255, 128])
    mask = (cols["k"][0] > 2).astype(np.float32)
    jfilt = JFL.filter_rows(jf, JColumn.from_numpy(mask))
    want = {"slice": JFL.slice_rows(jf, 10, 150),
            "take": JFL.take_rows(jf, ids),
            "rbind": JFL.rbind([jf, jfilt]),
            "table": jtable(jf.subframe(["g"]))}

    def rank(r, m):
        fr = _frame(cols)
        filt = FL.filter_rows(fr, Column.from_numpy(mask))
        got = {"slice": FL.slice_rows(fr, 10, 150),
               "take": FL.take_rows(fr, ids), "rbind": FL.rbind([fr, filt]),
               "table": table(fr.subframe(["g"]))}
        return {k: _gathered(v) for k, v in got.items()}

    for got in run_ranks(2, rank):
        for k in want:
            assert_same(want[k], got[k], zero_sign=False, ctx=k)


# -- the sample sort ------------------------------------------------------------

SORTS = {"num": (["x"], True), "desc": (["x"], False),
         "ties": (["k"], True), "multi": (["k", "x"], [True, False]),
         "enum": (["g", "k"], True), "window": (["x"], True)}


@pytest.mark.parametrize("R", [2, 3, 4])
@pytest.mark.parametrize("case", sorted(SORTS))
def test_sample_sort_is_the_one_process_sort(R, case):
    from h2o3_tpu_torch.ops.sort import sort_frame

    cols = _cols(301, seed=len(case))
    by, asc = SORTS[case]
    rows = (40, 260) if case == "window" else None

    def go():
        return _local(sort_frame(_frame(cols), by, asc, rows=rows))

    _check_ranks(go, go, R, case)


def test_sample_sort_raises_when_its_buckets_overlap(monkeypatch):
    from h2o3_tpu_torch.ops import sort as S

    # rank 0 sends every row to bucket 0 and rank 1 to the last bucket:
    # the buckets then interleave, and the sort must say so
    monkeypatch.setattr(S, "_lex_less", lambda cols, sp: torch.full(
        (len(cols[0]),), M.current().rank == 0))
    cols = _cols(120)

    def rank(r, m):
        with pytest.raises(RuntimeError, match="sample sort: bucket"):
            S.sort_frame(_frame(cols), "x")
        return True

    assert run_ranks(2, rank) == [True, True]


def test_sample_sort_against_the_jax_sample_sort(cl, monkeypatch):
    import h2o3_tpu.ops.sort as JS

    monkeypatch.setattr(JS, "SAMPLE_SORT_MIN_ROWS", 100)
    from h2o3_tpu_torch.ops.sort import sort_frame

    rng = np.random.default_rng(3)
    n = 1024
    x = rng.standard_normal(n)
    x[::31] = np.nan
    cols = {"x": (x, None), "v": (np.arange(n, dtype=float), None)}
    jf, _tf = both_frames(cols)
    js = JS.sort_frame(jf, "x")
    jx = np.asarray(js.col("x").to_numpy())[:n]
    jv = np.sort(np.asarray(js.col("v").to_numpy())[:n])

    def rank(r, m):
        out = sort_frame(_frame(cols), "x")
        return out.col("x").to_numpy(), out.col("v").to_numpy()

    for tx, tv in run_ranks(2, rank):
        np.testing.assert_array_equal(tx + np.float32(0), jx + np.float32(0))
        np.testing.assert_array_equal(np.sort(tv), jv)


# -- merge -----------------------------------------------------------------------

def _join_cols(seed=1):
    rng = np.random.default_rng(seed)
    n, nr = 150, 40
    k = rng.integers(0, 12, n).astype(np.float32)
    k[::13] = np.nan
    rk = rng.integers(0, 15, nr).astype(np.float32)
    rk[5] = np.nan
    left = {"k": (k, None),
            "g": (np.array(["a", "b", "c", "d"], object)[
                rng.integers(0, 4, n)], "enum"),
            "x": (rng.standard_normal(n).astype(np.float32), None)}
    right = {"k": (rk, None),
             "g": (np.array(["b", "c", "e", "a"], object)[
                 rng.integers(0, 4, nr)], "enum"),
             "v": (rng.standard_normal(nr).astype(np.float32), None)}
    return left, right


JOINS = {"inner": (False, False), "left": (True, False),
         "right": (False, True), "full": (True, True)}


@pytest.mark.parametrize("R", [2, 3, 4])
@pytest.mark.parametrize("how", sorted(JOINS))
@pytest.mark.parametrize("right_side", ["sharded", "replicated"])
def test_merge_is_the_one_process_join(R, how, right_side):
    from h2o3_tpu_torch.ops.merge import merge

    lc, rc = _join_cols()
    ax, ay = JOINS[how]

    def go():
        left = _frame(lc)
        if right_side == "replicated":
            with M.use(None):
                right = _frame(rc)
        else:
            right = _frame(rc)
        return {"both": _local(merge(left, right, all_x=ax, all_y=ay)),
                "k": _local(merge(left, right, all_x=ax, all_y=ay,
                                  by_x=["k"], by_y=["k"]))}

    _check_ranks(go, go, R, (how, right_side))


@pytest.mark.parametrize("how", sorted(JOINS))
def test_merge_against_the_jax_package(cl, how):
    from h2o3_tpu.ops.merge import merge as jmerge

    from h2o3_tpu_torch.ops.merge import merge

    lc, rc = _join_cols(4)
    ax, ay = JOINS[how]
    jl, _ = both_frames(lc)
    jr, _ = both_frames(rc)
    want = jmerge(jl, jr, all_x=ax, all_y=ay)

    def rank(r, m):
        return _gathered(merge(_frame(lc), _frame(rc), all_x=ax, all_y=ay))

    for got in run_ranks(2, rank):
        assert_same(want, got, zero_sign=False, ctx=how)


def test_merge_on_string_keys_stays_refused():
    """A merge on string keys runs on the mesh (ROADMAP A14.6c part 1b:
    each rank's block is one process's), and so, since part 3, does
    partial dependence on the merged frame, which refused before: its
    table is one process's within ROADMAP C55's bar (1e-6 of the
    response's scale)."""
    from h2o3_tpu_torch.ops.merge import merge

    cols = {"s": (np.array(["a", "b", "c", "d"], object), None),
            "x": (np.arange(4, dtype=np.float32), None)}
    with M.use(None):
        merged = merge(_frame(cols), _frame(cols))
        one = _local(merged)
        model = th.GBM(ntrees=1, max_depth=2, seed=1).train(
            y="z", training_frame=_frame({
                "x": cols["x"],
                "z": (np.array([0.5, 1.5, 1.0, 2.0], np.float32), None)}))
        want = model.partial_plot(merged, cols=["x"])

    def rank(r, m):
        got = merge(_frame(cols), _frame(cols))
        _same_block(one, _local(got), 2, r, "string merge")
        return model.partial_plot(got, cols=["x"])

    for got in run_ranks(2, rank):
        assert len(got) == len(want) == 1
        a, b = want[0], got[0]
        assert list(b["values"]) == list(a["values"])
        scale = max(1.0, float(np.max(np.abs(a["mean_response"]))))
        for k in ("mean_response", "stddev_response"):
            np.testing.assert_allclose(b[k], a[k], rtol=0,
                                       atol=1e-6 * scale, err_msg=k)


# -- group-by, table, quantiles ---------------------------------------------------

def _grouped(cols):
    from h2o3_tpu_torch.ops.groupby import GroupBy, table
    from h2o3_tpu_torch.ops.quantile import quantile_column

    fr = _frame(cols)
    gb = GroupBy(fr, ["g", "k"]).count().sum("x").mean("x").min("x") \
        .max("x").sd("x").var("x").get_frame()
    q = quantile_column(fr.col("x"), [0.0, 0.1, 0.25, 0.5, 0.77, 1.0])
    return {"gb": _local(gb), "table": _local(table(fr.subframe(["g"]))),
            "numeric_by": _local(GroupBy(fr, ["x"]).count().get_frame())
            }, q


@pytest.mark.parametrize("R", [2, 3, 4])
def test_group_by_table_and_quantiles_are_one_process(R):
    cols = {k: v for k, v in _cols(257, seed=6).items() if k != "s"}
    cols["x"][0][11] = 2.5          # no inf: a group's sum stays finite
    one, q1 = _grouped(cols)

    def rank(r, m):
        before = SF.counters()["gathered_rows"]
        got = _grouped(cols)
        return got, SF.counters()["gathered_rows"] - before

    for r, ((got, q), gathered) in enumerate(run_ranks(R, rank)):
        assert gathered == 0
        for k in one:
            _same_block(one[k], got[k], R, r, k)
        assert np.array_equal(np.asarray(q1).view(np.uint64),
                              np.asarray(q).view(np.uint64))


def test_group_by_and_quantiles_against_the_jax_package(cl):
    from h2o3_tpu.ops.groupby import GroupBy as JGroupBy
    from h2o3_tpu.ops.quantile import quantile_column as jq

    from h2o3_tpu_torch.ops.groupby import GroupBy
    from h2o3_tpu_torch.ops.quantile import quantile_column

    cols = {k: v for k, v in _cols(256, seed=2).items() if k != "s"}
    cols["x"][0][11] = 1.5
    jf, _ = both_frames(cols)
    want = JGroupBy(jf, ["g"]).count().sum("x").mean("x").min("x") \
        .max("x").get_frame()
    wq = jq(jf.col("x"), [0.1, 0.5, 0.9])

    def rank(r, m):
        fr = _frame(cols)
        gb = GroupBy(fr, ["g"]).count().sum("x").mean("x").min("x") \
            .max("x").get_frame()
        return _gathered(gb), quantile_column(fr.col("x"), [0.1, 0.5, 0.9])

    for got, q in run_ranks(2, rank):
        for nm in ("g", "nrow", "min_x", "max_x"):
            assert_same(want.subframe([nm]), got.subframe([nm]),
                        zero_sign=False, ctx=nm)
        for nm in ("sum_x", "mean_x"):
            assert_same(want.subframe([nm]), got.subframe([nm]), rtol=1e-5,
                        ctx=nm)                                   # C2
        np.testing.assert_array_equal(np.float32(q), np.float32(wq))


# -- Rapids ------------------------------------------------------------------------

STATEMENTS = [
    "(rows {f} [3:40])", "(rows {f} (> (cols {f} [0]) 2))",
    "(rbind {f} {f})", "(sort {f} [0 2] [1 -1])",
    "(merge {f} {f} 0 0 [] [] 'auto')",
    "(GB {f} [1] 'mean' 2 'all' 'nrow' 0 'all' 'sum' 2 'all')",
    "(table (cols {f} [1]))", "(unique (cols {f} [0]))", "(na.omit {f})",
    "(h2o.runif {f} 5)", "(kfold_column {f} 3 7)",
    "(modulo_kfold_column {f} 4)",
    "(stratified_kfold_column (cols {f} [1]) 3 9)",
    "(mean (cols {f} [2]))", "(sum (cols {f} [0]))",
    "(min (cols {f} [2]))", "(max (cols {f} [2]))",
    "(sd (cols {f} [2]))", "(var (cols {f} [2]))",
    "(naCnt (cols {f} [2]))", "(median (cols {f} [2]))",
    "(quantile (cols {f} [2]) [0.1 0.5 0.9] 'interpolate' _)",
    "(h2o.splitframe {f} [0.6] 3)"]


ROLLUP_PRIMS = {"(mean", "(sum", "(sd", "(var"}


def _rapids(tag, cols):
    from h2o3_tpu_torch.rapids import Session, exec_rapids

    fr = _frame(cols, key=f"shops_{tag}")
    fr.install()
    sess = Session(f"shops_s_{tag}")
    out = []
    try:
        for st in STATEMENTS:
            v = exec_rapids(st.format(f=fr.key), sess)
            out.append(_local(v) if isinstance(v, Frame) else v)
    finally:
        th.DKV.remove(str(fr.key))
    return out


@pytest.mark.parametrize("R", [2, 3])
def test_rapids_cross_row_prims_on_a_sharded_frame(R):
    rng = np.random.default_rng(1)
    n = 130
    x = rng.standard_normal(n).astype(np.float32)
    x[::11] = np.nan
    cols = {"k": (rng.integers(0, 6, n).astype(np.float32), None),
            "g": (np.array(["a", "b", "c", "d"], object)[
                rng.integers(0, 4, n)], "enum"),
            "x": (x, None)}
    one = _rapids("one", cols)
    for r, got in enumerate(run_ranks(R, lambda r, m: _rapids(
            f"{R}_{r}", cols))):
        for st, a, b in zip(STATEMENTS, one, got):
            if isinstance(a, tuple):
                _same_block(a, b, R, r, st)
            elif st.split()[0] in ROLLUP_PRIMS:
                # the cloud's rollups add each rank's float32 partials
                # (ROADMAP C46)
                assert b == pytest.approx(a, rel=1e-6, abs=1e-7), st
            else:
                assert np.array_equal(np.float64(a), np.float64(b),
                                      equal_nan=True), (st, a, b)


JAX_STATEMENTS = [
    "(rows {f} (> (cols {f} [0]) 2))", "(sort {f} [0 2] [1 -1])",
    "(table (cols {f} [1]))", "(unique (cols {f} [0]))",
    "(GB {f} [1] 'nrow' 0 'all' 'min' 2 'all' 'max' 2 'all')",
    "(rbind {f} {f})", "(na.omit {f})", "(min (cols {f} [2]))",
    "(max (cols {f} [2]))", "(naCnt (cols {f} [2]))",
    "(median (cols {f} [2]))",
    "(quantile (cols {f} [2]) [0.1 0.5 0.9] 'interpolate' _)",
    "(mean (cols {f} [2]))", "(sd (cols {f} [2]))"]


def test_rapids_cross_row_prims_against_the_jax_package(cl):
    """The reference's statements on its 8-device mesh against the port's
    on 2 ranks: frames and exact reductions bit for bit (up to the sign of
    a zero), the mean and sd to 1e-5 relative (ROADMAP C2)."""
    from h2o3_tpu.core.frame import Column as JColumn, Frame as JFrame
    from h2o3_tpu.rapids import Session as JSession
    from h2o3_tpu.rapids import exec_rapids as jexec

    rng = np.random.default_rng(8)
    n = 128
    x = rng.standard_normal(n).astype(np.float32)
    x[::11] = np.nan
    cols = {"k": (rng.integers(0, 6, n).astype(np.float32), None),
            "g": (np.array(["a", "b", "c", "d"], object)[
                rng.integers(0, 4, n)], "enum"),
            "x": (x, None)}
    jf = JFrame(key="shops_ref")
    for nm, (a, ct) in cols.items():
        jf.add(nm, JColumn.from_numpy(a, ctype=ct))
    jf.install()
    js = JSession("shops_ref_s")
    want = [jexec(st.format(f="shops_ref"), js) for st in JAX_STATEMENTS]

    def rank(r, m):
        from h2o3_tpu_torch.rapids import Session, exec_rapids

        fr = _frame(cols, key=f"shops_jx_{r}")
        fr.install()
        sess = Session(f"shops_jx_s_{r}")
        try:
            out = []
            for st in JAX_STATEMENTS:
                v = exec_rapids(st.format(f=fr.key), sess)
                out.append(_gathered(v) if isinstance(v, Frame) else v)
            return out
        finally:
            th.DKV.remove(str(fr.key))

    for got in run_ranks(2, rank):
        for st, a, b in zip(JAX_STATEMENTS, want, got):
            loose = st.startswith(("(mean", "(sd"))
            assert_same(a, b, rtol=1e-5 if loose else None,
                        zero_sign=False, ctx=st)


def test_the_remaining_cross_row_prims_stay_refused():
    """`t`, `x` and `melt`, once refused here, run on the mesh (ROADMAP
    A14.6c part 1b; tests/test_torch_sharded_reshape.py holds them to
    one process); what a Rapids session still cannot reach on a sharded
    frame is a builder without a sharded path (a GLRM and an SVD train,
    parts 2-4)."""
    from h2o3_tpu_torch.rapids import Session, exec_rapids

    cols = {"x": (np.arange(8, dtype=np.float32), None)}

    def rank(r, m):
        fr = _frame(cols, key=f"refused_{r}")
        fr.install()
        try:
            for st in ("(t {f})", "(x {f} (t {f}))",
                       "(melt {f} [0] [] 'variable' 'value' 0)"):
                exec_rapids(st.format(f=fr.key), Session(f"ref{r}"))
            with pytest.raises(NotImplementedError, match="A14.6c"):
                th.GLRM(k=1).train(training_frame=fr)
            with pytest.raises(NotImplementedError, match="A14.6c"):
                th.SVD(nv=1).train(training_frame=fr)
        finally:
            th.DKV.remove(str(fr.key))
        return True

    assert run_ranks(2, rank) == [True, True]


def test_exchange_counters_reach_the_metrics_registry():
    from h2o3_tpu_torch.obs import metrics as pm

    SF.reset_counters()
    SF.note_exchanged(3, 24)
    SF.note_dl_batch_rows(5)
    text = pm.prometheus_text(pm.REGISTRY.snapshot())
    assert "h2o3_data_plane_exchanged_rows_total 3" in text
    assert "h2o3_data_plane_exchanged_bytes_total 24" in text
    assert "h2o3_data_plane_dl_batch_rows_total 5" in text
    assert pm.data_plane_counters()["exchanged_rows"] == 3
    SF.reset_counters()


def _stratified_loop(y, k, seed):
    """The one-process stratified draw as the reference writes it: per
    class a shuffle of its rows, then a round-robin from a random start."""
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, k, len(y))
    valid = ~np.isnan(y) if y.dtype.kind == "f" else y >= 0
    for cls in np.unique(y[valid]):
        idx = np.nonzero(y == cls)[0]
        rng.shuffle(idx)
        assign[idx] = (np.arange(len(idx)) + rng.integers(k)) % k
    return assign


@pytest.mark.parametrize("kind", ["float", "codes"])
def test_stratified_fold_ids_are_the_shuffle_loop(kind):
    rng = np.random.default_rng(4)
    if kind == "float":
        y = rng.integers(0, 4, 301).astype(np.float64)
        y[::13] = np.nan
    else:
        y = rng.integers(-1, 5, 301).astype(np.int32)
    want = _stratified_loop(y, 3, 21)
    got = FL.stratified_fold_ids(y, 3, np.random.default_rng(21), len(y))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("R", [2, 3])
@pytest.mark.parametrize("col", ["g", "k"])
def test_stratified_kfold_column_reads_only_its_block(R, col):
    """`stratified_kfold_column` on a sharded frame: each rank's block of
    one process's ids, from the classes' counts alone (no row gathered)."""
    from h2o3_tpu_torch.rapids import Session, exec_rapids

    rng = np.random.default_rng(6)
    n = 157
    k = rng.integers(0, 5, n).astype(np.float32)
    k[::9] = np.nan
    cols = {"k": (k, None),
            "g": (np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)],
                  "enum")}
    idx = list(cols).index(col)
    st = "(stratified_kfold_column (cols {f} [%d]) 4 13)" % idx

    def run(tag):
        fr = _frame(cols, key=f"strat_{tag}")
        fr.install()
        try:
            before = SF.counters()["gathered_rows"]
            out = exec_rapids(st.format(f=fr.key), Session(f"strat_{tag}"))
            return _local(out), SF.counters()["gathered_rows"] - before
        finally:
            th.DKV.remove(str(fr.key))

    one, _ = run("one")
    for r, (got, gathered) in enumerate(run_ranks(
            R, lambda r, m: run(f"{R}_{r}"))):
        assert gathered == 0
        _same_block(one, got, R, r, st)
