"""The last of the data plane's work on row-sharded frames (ROADMAP
A14.6c part 1b): the Rapids prims that reshape a frame or run user code
(`t`, `x`, `melt`, `pivot`, `ddply`, `apply`, `grouped_permute`,
`isax`, `tf-idf`, `h2o.random_stratified_split`), spearman `cor`,
`distance` to a row-sharded frame, string keys (dropdup,
rank_within_groupby, merges), segment models keyed by strings or by
numbers with NAs, and streaming appends. Ranks run as threads of this
process (`run_ranks`), R = 2 and 3; one fixture runs every statement
once per R and each case reads it.

Bars, against one process of the port on the same rows (each rank's
`mesh.row_block` of a per-row result; a one-row-a-column result whole on
every rank):
- bit for bit (``BIT``) for the row-local, placed and keyed work;
- 1e-6 relative over an absolute 1e-7 (ROADMAP C46's bar, ``REL``) for
  the matrix products and distances, whose products run at other
  shapes, spearman's coefficient and a column lambda's float reduction.
``gathered_rows`` is 0 through every statement but `distance` to a
row-sharded frame and the gathering form of `x`, where it is exactly
that operand's row count. Against the JAX package (its 8-device CPU
mesh) one case a group, at the one-process parity tests' bars
(`test_torch_rapids_ext.py`)."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch.core import sharded_frame as SF
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.parallel import mesh as M

from test_torch_sharded import run_ranks
from test_torch_sharded_ops import _gathered, _local, _same_block
from test_torch_sharded_prims import BIT, REL, _close, _cols, _frame
from torch_port_support import assert_same


@pytest.fixture(autouse=True)
def _port_cpu():
    """The port on the CPU; what a test leaves in the DKV is removed
    after it."""
    th.init(device="cpu")
    before = set(th.DKV.keys())
    yield
    for k in set(th.DKV.keys()) - before:
        th.DKV.remove(k)


N = 203


def _rcols(n=N, seed=3):
    """`test_torch_sharded_prims._cols` (x 0, k 1, g 2, s 3, p 4, z 5,
    h 6, w 7) and: t 8, strings without None; d 9, an enum of "D" and
    "N"; txt 10, a text of a few words with None; id 11, the row id;
    m 12, small integers without NaN; q 13, small integers with NaN in
    three rows."""
    cols = _cols(n, seed)
    rng = np.random.default_rng(seed + 10)
    i = np.arange(n)
    cols["t"] = (np.array(["pp", "q", "rr", "Q"], object)[
        rng.integers(0, 4, n)], None)
    cols["d"] = (np.array(["D", "N"], object)[rng.integers(0, 2, n)],
                 "enum")
    words = np.array(["the", "The", "cat", "sat", "mat", "on"], object)
    txt = np.array([" ".join(words[rng.integers(0, 6, rng.integers(1, 5))])
                    for _ in i], object)
    txt[::19] = None
    cols["txt"] = (txt, None)
    cols["id"] = (i.astype(np.float32), None)
    cols["m"] = (rng.integers(0, 5, n).astype(np.float32), None)
    q = rng.integers(0, 3, n).astype(np.float32)
    q[[5, 101, 170]] = np.nan
    cols["q"] = (q, None)
    return cols


# x 0, k 1, g 2, s 3, p 4, z 5, h 6, w 7, t 8, d 9, txt 10, id 11, m 12,
# q 13; {b}: 2x2 sharded; {o}: 16x2 sharded; {r}, {r2}, {r3}: merge
# partners
# (case, group, statements, bar)
CASES = [
    # reshapes
    ("t", "reshape", ["(t (cols {f} [0 1 5]))", "(t (cols {f} [2 6]))"],
     BIT),
    ("x_row_local", "reshape", ["(x (cols {f} [5 7]) {bh})"], REL),
    ("x_gather", "reshape", ["(x (cols {f} [5 7]) {b})"], REL),
    ("x_slices", "reshape", ["(x (t (cols {f} [5 7 4])) (cols {f} [5 7 4]))",
                             "(x (t (cols {f} [0 5])) (cols {f} [7 12]))"],
     REL),
    ("melt", "reshape", ['(melt (cols {f} [2 0 5]) [0] [1 2] "variable" '
                         '"value" 1)',
                         '(melt (cols {f} [3 0 7]) [0] [] "var" "val" 0)',
                         '(melt (cols {f} [11 1 0]) [0] [1 2] "v" "x" 1)'],
     BIT),
    ("pivot", "reshape", ["(pivot {f} 's' 'h' 'z')",
                          "(pivot {f} 'g' 'd' 'x')",
                          "(pivot {f} 't' 'm' 'w')"], BIT),
    # groups and user lambdas
    ("ddply", "groups", ['(ddply {f} [12] {{ x . (mean (cols_py x "z") True '
                         '0) }})',
                         "(ddply {f} [2 6] {{ x . (nrow x) }})",
                         '(ddply {f} [9] {{ x . (sd (cols_py x "w") True) }})'],
     BIT),
    ("grouped_permute", "groups", ["(grouped_permute {f} 5 [2] 9 7)",
                                   "(grouped_permute {f} 11 [6 12] 9 0)"],
     BIT),
    ("tf-idf", "groups", ["(tf-idf {f} 11 10 1 0)",
                          "(tf-idf {f} 11 10 1 1)",
                          "(tf-idf {f} 12 3 0 1)"], BIT),
    ("random_stratified_split", "groups", [
        "(h2o.random_stratified_split (cols {f} [6]) 0.3 42)",
        "(h2o.random_stratified_split (cols {f} [1]) 0.25 7)"], BIT),
    ("apply_rows", "groups", ["(apply (cols {f} [5 7 1]) 1 {{ x . (max x) }})"],
     BIT),
    ("apply_cols", "groups", ["(apply (cols {f} [0 5 7]) 2 {{ x . (sd x) }})",
                              "(apply (cols {f} [5 7]) 2 {{ x . (max x) }})"],
     REL),
    ("isax", "groups", ["(isax (cols {f} [0 4 5 7]) 2 4 0)",
                        "(isax (cols {f} [5 7 4 12 0 1]) 3 3 0)"], BIT),
    # string keys
    ("dropdup", "keys", ["(dropdup {f} [3] 'first')",
                         "(dropdup {f} [3 1] 'last')",
                         "(dropdup {f} [8 2] 'first')",
                         "(dropdup (cols {f} [5 0]) [0] 'last')"], BIT),
    ("rank_within_groupby", "keys", [
        '(rank_within_groupby {f} [8] [0] [1] "r" 0)',
        '(rank_within_groupby {f} [8 1] [5 0] [0 1] "r" 0)'], BIT),
    ("merge", "keys", ["(merge {f} {r} 1 0 [] [] 'auto')",
                       "(merge {f} {r} 0 1 [] [] 'auto')",
                       "(merge {f} {r} 0 0 [] [] 'auto')",
                       "(merge {f} {r2} 1 1 [] [] 'auto')",
                       "(merge (cols {f} [12 5]) {r3} 1 1 [] [] 'auto')"],
     BIT),
    # statistics
    ("spearman", "stats", ["(cor (cols {f} [0 4 5]) (cols {f} [0 4 5]) "
                           "'complete.obs' 'spearman')",
                           "(cor (cols {f} [5 12]) (cols {f} [7]) "
                           "'everything' 'spearman')"], REL),
    ("distance", "stats", ["(distance (cols {f} [4 5]) {o} 'l2')",
                           "(distance (cols {f} [4 5]) {o} 'cosine')"], REL),
]
CASE_IDS = [c[0] for c in CASES]
# the rows each case gathers: the second frame of `distance` (16 rows,
# two statements) and of `x`'s gathering form (2 rows)
GATHERED = {"distance": 32, "x_gather": 2}


def _small(key, n, k, seed):
    """An n x k frame of the current mesh's rows (or held whole)."""
    rng = np.random.default_rng(seed)
    return _frame({f"c{j}": (rng.standard_normal(n).astype(np.float32),
                             None) for j in range(k)}, key=key)


def _partners(tag):
    """merge's right frames: the string key `s` (one label of the left's
    missing, one the left lacks) with a value, `g` as strings beside the
    left's enum `g`, and `m` as strings beside the left's numeric `m` (a
    mixed-type key: strings never equal numbers)."""
    r = _frame({"s": (np.array(["alpha", "Beta", "dd", "zz", "alpha", None],
                               object), None),
                "val": (np.arange(6, dtype=np.float32), None)},
               key=f"shr_r_{tag}")
    r2 = _frame({"g": (np.array(["a", "c", "e", None], object), None),
                 "v2": (np.array([1.5, 2.5, 3.5, 4.5], np.float32), None)},
                key=f"shr_r2_{tag}")
    r3 = _frame({"m": (np.array(["0", "1", "2.0", None], object), None),
                 "v3": (np.array([1.0, 2.0, 3.0, 4.0], np.float32), None)},
                key=f"shr_r3_{tag}")
    return r, r2, r3


def _ranks_of(cols):
    """spearman's midranks of three columns (complete.obs), on this
    thread's mesh or one process."""
    from h2o3_tpu_torch.rapids.prims_ext import _midranks, _ranks_sharded

    fr = _frame({k: cols[k] for k in ("x", "z", "w")})
    X = torch.stack([fr.col(n).data.float() for n in fr.names], 1)
    w = ~torch.isnan(X).any(1)
    mesh = SF.sharded_mesh(fr)
    R = _ranks_sharded(X, w, mesh) if mesh is not None else _midranks(X, w)
    return R.numpy().copy()


def _segments(tag, cols):
    """Segment GBMs keyed by `q` (numeric, three NaN rows, each its own
    segment) and the refusal of a string segment column."""
    from test_torch_sharded_prims import N as _n

    rng = np.random.default_rng(5)
    y = np.where(rng.random(_n) < 0.5, "Y", "N").astype(object)
    fr = _frame({"q": cols["q"], "z": cols["z"], "w": cols["w"],
                 "y": (y, "enum"), "s": cols["s"]}, key=f"shs_{tag}")
    sm = th.train_segments(th.GBM, dict(ntrees=2, max_depth=2, seed=1,
                                        min_rows=1), fr, ["q"], y="y")
    out = []
    for row in sm.rows:
        m = th.DKV.get(row["model_id"]) if row["model_id"] else None
        out.append((row["segment"]["q"], row["status"],
                    None if m is None else
                    float(m._output.training_metrics.logloss),
                    None if m is None else
                    float(m._output.training_metrics.nobs)))
    try:
        th.train_segments(th.GBM, dict(ntrees=1), fr, ["s"], y="y")
        err = None
    except TypeError as e:
        err = str(e)
    return out, err


def _append(tag, path, batch):
    """A CSV imported and a batch streamed onto it (`append_csv`)."""
    from h2o3_tpu_torch.ingest.chunked import append_csv

    fr = th.import_file(str(path), destination_frame=f"sha_{tag}")
    fr.col("x").rollups            # the cloud's, cached before the batch
    append_csv(fr, batch)
    out = _local(fr)
    r = fr.col("x")._rollups
    return out, None if r is None else (r.rows, r.na_count, r.min, r.max,
                                        r.mean)


def _statements(tag, cols, csv):
    """Every case's values (`_local` for a frame) and the rows gathered
    through it, on this thread's mesh (none: one process)."""
    from h2o3_tpu_torch.rapids import Session, exec_rapids

    fr = _frame(cols, key=f"shr_{tag}")
    b = _small(f"shr_b_{tag}", 2, 2, 7)
    o = _small(f"shr_o_{tag}", 16, 2, 8)
    with M.use(None):
        bh = _small(f"shr_bh_{tag}", 2, 2, 9)
    r, r2, r3 = _partners(tag)
    for f in (fr, b, o, bh, r, r2, r3):
        f.install()
    sess = Session(f"shr_s_{tag}")
    out = {}
    try:
        for name, _grp, sts, _bar in CASES:
            before = SF.counters()["gathered_rows"]
            vals = []
            for st in sts:
                v = exec_rapids(st.format(f=fr.key, b=b.key, o=o.key,
                                          bh=bh.key, r=r.key, r2=r2.key,
                                          r3=r3.key), sess)
                vals.append(_local(v) if isinstance(v, Frame) else v)
            if M.current() is not None:
                # every rank's gathers done before any rank reads the
                # process's counter (the thread ranks share it)
                M.current().barrier()
            out[name] = (vals, SF.counters()["gathered_rows"] - before)
        before = SF.counters()["gathered_rows"]
        out["_ranks"] = _ranks_of(cols)
        out["_segments"] = _segments(tag, cols)
        out["_append"] = _append(tag, *csv)
        out["_gathered_rest"] = SF.counters()["gathered_rows"] - before
        try:
            exec_rapids(f'(rank_within_groupby {fr.key} [3] [0] [1] "r" 0)',
                        sess)
            out["_rank_none"] = None
        except TypeError as e:
            out["_rank_none"] = str(e)
    finally:
        sess.end()
        for f in (fr, b, o, bh, r, r2, r3):
            th.DKV.remove(str(f.key))
    return out


_RUNS = {}


@pytest.fixture(scope="module")
def csv_case(tmp_path_factory):
    """A CSV (a number with NAs, an enum, a string of unique ids) and a
    batch whose enum labels grow the domain."""
    rng = np.random.default_rng(11)
    p = tmp_path_factory.mktemp("append") / "base.csv"
    rows = [f"{'NA' if i % 13 == 0 else round(float(rng.normal()), 3)},"
            f"{'bcd'[i % 3]},id{i:03d}\n" for i in range(61)]
    p.write_text("x,g,u\n" + "".join(rows))
    batch = "".join(f"{i * 0.5},{'ab'[i % 2]},new{i}\n" for i in range(23))
    return p, batch


def _runs(R, csv):
    """(one process's values, every rank's), made once per R."""
    if "one" not in _RUNS:
        _RUNS["one"] = _statements("one", _rcols(), csv)
    if R not in _RUNS:
        _RUNS[R] = run_ranks(R, lambda r, m: _statements(f"{R}_{r}",
                                                         _rcols(), csv),
                             timeout_s=60.0)
    return _RUNS["one"], _RUNS[R]


def _held(one, got, R, r, bar, ctx):
    """One value of a case held to one process's at its bar."""
    if not isinstance(one, tuple):
        if bar == BIT:
            assert np.array_equal(np.float64(one), np.float64(got),
                                  equal_nan=True), (ctx, one, got)
        else:
            _close(one, got, bar, ctx)
        return
    if bar == BIT and got[1] is not None:
        _same_block(one, got, R, r, ctx)
        return
    n1, _sh, c1 = one
    n2, sh2, c2 = got
    lo, hi = (0, n1) if sh2 is None else M.row_block(n1, r, R)
    assert n1 == n2 and (sh2 is None or tuple(sh2) == (lo, hi)), ctx
    assert list(c1) == list(c2), ctx
    for nm in c1:
        (t1, d1, v1), (t2, d2, v2) = c1[nm], c2[nm]
        assert (t1, d1) == (t2, d2), (ctx, nm)
        if bar == BIT:
            assert np.array_equal(v1[lo:hi].view(np.uint8),
                                  v2.view(np.uint8)), (ctx, nm)
        else:
            _close(v1[lo:hi], v2, bar, (ctx, nm))


@pytest.mark.parametrize("R", [2, 3])
@pytest.mark.parametrize("case", CASE_IDS)
def test_part_1b_on_a_sharded_frame(case, R, csv_case):
    """Each ported item on R thread ranks: every rank's result held to
    one process's at the case's bar; the rows gathered are 0, or exactly
    the second frame's of `distance` and `x`'s gathering form."""
    one, ranks = _runs(R, csv_case)
    bar = dict((c[0], c[3]) for c in CASES)[case]
    for r, got in enumerate(ranks):
        vals, gathered = got[case]
        # each rank counts the operand's rows; the R thread ranks share
        # this process's counter
        assert gathered == R * GATHERED.get(case, 0), (case, r, gathered)
        for i, (a, b) in enumerate(zip(one[case][0], vals)):
            _held(a, b, R, r, bar, (case, i, r))


@pytest.mark.parametrize("R", [2, 3])
def test_spearman_ranks_are_one_process_midranks(R, csv_case):
    """Spearman's midranks on the mesh (equal values on one rank, each
    run's ends from its bucket's offset) are one process's, bitwise."""
    one, ranks = _runs(R, csv_case)
    for r, got in enumerate(ranks):
        lo, hi = M.row_block(N, r, R)
        assert np.array_equal(one["_ranks"][lo:hi], got["_ranks"]), r


@pytest.mark.parametrize("R", [2, 3])
def test_segments_keyed_by_numbers_with_nas(R, csv_case):
    """Segment GBMs keyed by a numeric column with NAs: each NaN row is a
    segment of its own, as in one process, and every segment's train is
    one process's (its logloss and row count); a string segment column
    raises one process's TypeError. The NaN segments come in row order
    on the mesh (ROADMAP C53), so they are compared as a set."""
    one, ranks = _runs(R, csv_case)
    segs, err = one["_segments"]
    assert err is not None and "dtype object" in err
    keyed = [s for s in segs if s[0] == s[0]]
    nan = [s for s in segs if s[0] != s[0]]
    assert len(nan) == 3 and len(keyed) == 3
    for got in ranks:
        gsegs, gerr = got["_segments"]
        assert gerr == err
        assert [s for s in gsegs if s[0] == s[0]] == keyed
        gnan = [s for s in gsegs if s[0] != s[0]]
        assert sorted(map(repr, gnan)) == sorted(map(repr, nan))
        assert gsegs[: len(keyed)] == keyed
        assert got["_gathered_rest"] == 0


@pytest.mark.parametrize("R", [2, 3])
def test_streaming_append_on_a_sharded_frame(R, csv_case):
    """`append_csv` on a row-sharded frame: each rank's block of the
    longer frame is one process's append (new enum labels renumbering
    the old codes), and the merged rollups are the cloud's."""
    one, ranks = _runs(R, csv_case)
    for r, got in enumerate(ranks):
        _same_block(one["_append"][0], got["_append"][0], R, r, "append")
        assert got["_append"][1][:4] == one["_append"][1][:4]
        assert abs(got["_append"][1][4] - one["_append"][1][4]) <= \
            1e-6 * abs(one["_append"][1][4])


def test_a_none_in_a_string_group_key_raises_as_one_process(csv_case):
    """rank_within_groupby on a string group key holding None: one
    process's host walk sorts None against strings and raises; every
    rank raises the same TypeError."""
    one, ranks = _runs(2, csv_case)
    assert one["_rank_none"] is not None
    for got in ranks:
        assert got["_rank_none"] == one["_rank_none"]


@pytest.mark.parametrize("R", [2, 3])
def test_sort_order_on_a_sharded_frame_is_its_blocks_row_ids(R):
    """`sort_order` of a row-sharded frame: each rank's block of one
    process's sorted permutation (the global ids of the rows at its
    sorted positions), from the sample sort."""
    from h2o3_tpu_torch.ops.sort import sort_order

    cols = {k: v for k, v in _rcols().items() if k in ("k", "x", "z")}

    def perm():
        return sort_order(_frame(cols), ["k", "z", "x"],
                          [False, True, True]).numpy()

    one = perm()
    got = run_ranks(R, lambda r, m: perm())
    for r, g in enumerate(got):
        lo, hi = M.row_block(N, r, R)
        assert np.array_equal(one[lo:hi], g), r


def test_no_cross_row_prim_is_left_unported():
    """Every Rapids prim that needs other ranks' rows runs on a
    row-sharded frame (no `CROSS_ROW_PRIMS - SHARDED_PRIMS`)."""
    from h2o3_tpu_torch.rapids.eval import CROSS_ROW_PRIMS, PRIMS, \
        SHARDED_PRIMS

    assert not CROSS_ROW_PRIMS - SHARDED_PRIMS
    assert all(n in PRIMS for n in SHARDED_PRIMS)


# -- against the JAX package, one case a group ---------------------------------------

JAX_GROUPS = {
    "reshape": [("(t (cols {f} [0 1 5]))", None, 0),
                ("(x (t (cols {f} [5 7])) (cols {f} [5 7]))", 1e-5, 1.0),
                ('(melt (cols {f} [2 0 5]) [0] [1 2] "variable" "value" 1)',
                 None, 0),
                ("(pivot {f} 'g' 'd' 'x')", None, 0)],
    "groups": [('(ddply {f} [2 6] {{ x . (nrow x) }})', None, 0),
               ("(grouped_permute {f} 5 [2] 9 7)", None, 0),
               ("(tf-idf {f} 11 10 1 0)", None, 0),
               ("(h2o.random_stratified_split (cols {f} [6]) 0.3 42)",
                None, 0)],
    "keys": [("(dropdup {f} [3 1] 'last')", None, 0),
             ('(rank_within_groupby {f} [8 1] [5 0] [0 1] "r" 0)', None, 0),
             ("(merge {f} {r} 1 0 [] [] 'auto')", None, 0)],
    "stats": [("(cor (cols {f} [0 4 5]) (cols {f} [0 4 5]) "
               "'complete.obs' 'spearman')", 1e-5, 1.0),
              ("(distance (cols {f} [4 5]) {o} 'l2')", 1e-5, 1.0),
              ("(isax (cols {f} [0 4 5 7]) 2 4 0)", None, 0),
              ("(apply (cols {f} [5 7 1]) 1 {{ x . (max x) }})", None, 0)],
}


def _jax_frame(cols, key):
    from h2o3_tpu.core.frame import Column as JColumn, Frame as JFrame

    jf = JFrame(key=key)
    for nm, (a, ct) in cols.items():
        jf.add(nm, JColumn.from_numpy(a, ctype=ct))
    jf.install()
    return jf


@pytest.mark.parametrize("group", list(JAX_GROUPS))
def test_part_1b_group_against_the_jax_package(cl, group):
    """A group's statements in the reference on its 8-device mesh and in
    the port on 2 ranks (the port's frames gathered after each statement
    to compare)."""
    from h2o3_tpu.rapids import Session as JSession
    from h2o3_tpu.rapids import exec_rapids as jexec

    cols = _rcols(256, seed=4)
    _jax_frame(cols, "shrj_ref")
    rcols = {"s": (np.array(["alpha", "Beta", "dd", "zz", "alpha", None],
                            object), None),
             "val": (np.arange(6, dtype=np.float32), None)}
    _jax_frame(rcols, "shrj_r")
    rng = np.random.default_rng(8)
    ocols = {f"c{j}": (rng.standard_normal(16).astype(np.float32), None)
             for j in range(2)}
    _jax_frame(ocols, "shrj_o")
    js = JSession("shrj_ref_s")
    sts = JAX_GROUPS[group]
    want = [jexec(st.format(f="shrj_ref", r="shrj_r", o="shrj_o"), js)
            for st, _r, _s in sts]
    js.end()

    def rank(r, m):
        from h2o3_tpu_torch.rapids import Session, exec_rapids

        frs = [_frame(cols, key=f"shrj_{group}_{r}"),
               _frame(rcols, key=f"shrj_r_{group}_{r}"),
               _frame(ocols, key=f"shrj_o_{group}_{r}")]
        for f in frs:
            f.install()
        sess = Session(f"shrj_s_{group}_{r}")
        try:
            out = []
            for st, _r, _s in sts:
                v = exec_rapids(st.format(f=frs[0].key, r=frs[1].key,
                                          o=frs[2].key), sess)
                out.append(_gathered(v) if isinstance(v, Frame) else v)
            return out
        finally:
            sess.end()
            for f in frs:
                th.DKV.remove(str(f.key))

    for got in run_ranks(2, rank, timeout_s=60.0):
        for (st, rtol, scale), a, b in zip(sts, want, got):
            assert_same(a, b, rtol=rtol, scale=scale, zero_sign=False,
                        ctx=st)
