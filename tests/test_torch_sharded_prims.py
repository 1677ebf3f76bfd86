"""The rest of the data plane's Rapids prims on row-sharded frames (ROADMAP
A14.6c part 1: the cleaning and type prims, the statistics, the
cumulative and window prims, the whole-column reductions), the C50 frame
methods (`H2OFrame.impute`, `asfactor`, `unique`) and segment models.
Ranks run as threads of this process (`run_ranks`, one gloo group each),
R = 2 and 3; one fixture runs every statement once per R.

Bars, against one process of the port on the same rows (each rank's
`mesh.row_block` of a per-row result; a small result, the histogram
table or the correlation matrix, whole on every rank), with
``gathered_rows`` 0 through every statement:
- bit for bit for what is order-free (``BIT``);
- 1e-6 relative, over an absolute 1e-7 (ROADMAP C46's bar) for float
  sums and moments (``REL``: the impute mean, scale, cor, skewness,
  kurtosis, column sums, products, the rule-made histogram breaks and
  the cumulative product);
- 1e-5 of the column's sum of |x| for the cumulative sum (``C16``).
Against the JAX package (its 8-device CPU mesh) one case a group, at the
one-process parity tests' bars (`test_torch_rapids_ext.py`): bit for bit
up to the sign of a zero, 1e-5 of max(|value|, 1) for the float moments,
sums and products."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th
from h2o3_tpu_torch.core import sharded_frame as SF
from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.parallel import mesh as M

from test_torch_sharded import run_ranks
from test_torch_sharded_ops import _gathered, _local, _same_block
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


def _cols(n=N, seed=3):
    """x: normal, NaN every 7th and in runs across the ranks' block
    boundaries, -0 and +0, a tied value; k: small integers with NaN; g:
    an enum whose first rows favour "a" and the rest "b" (the cloud's
    mode, not every rank's), NA every 17th; s: strings with None; p: near
    1 (products); z: one decimal, ties, a -0, no NaN; h: a 2-level enum
    with NA; w: positive with a +0 then a -0 (signed zeros of the running
    min and max)."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    x = rng.standard_normal(n).astype(np.float32)
    x[::7] = np.nan
    for a, b in ((66, 70), (100, 104), (134, 139)):
        x[a:b] = np.nan
    x[3], x[5] = -0.0, 0.0
    x[[40, 41, 150]] = 1.5
    k = rng.integers(0, 6, n).astype(np.float32)
    k[::9] = np.nan
    g = np.where(i < 0.45 * n, np.where(i % 5 == 0, "c", "a"),
                 np.where(i % 4 == 0, "c", "b")).astype(object)
    g[::17] = None
    s = np.array(["alpha", "Beta", None, "gamma gamma", "dd"], object)[
        rng.integers(0, 5, n)]
    p = rng.uniform(0.9, 1.1, n).astype(np.float32)
    p[::13] = np.nan
    z = np.round(rng.standard_normal(n), 1).astype(np.float32)
    z[z == 0] = 0.3
    z[60] = -0.0
    h = np.array(["u", "v"], object)[rng.integers(0, 2, n)]
    h[::11] = None
    w = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
    w[10], w[30] = 0.0, -0.0
    return {"x": (x, None), "k": (k, None), "g": (g, "enum"),
            "s": (s, None), "p": (p, None), "z": (z, None),
            "h": (h, "enum"), "w": (w, None)}


def _frame(cols, key=None):
    fr = Frame(key=key)
    for nm, (a, ct) in cols.items():
        fr.add(nm, Column.from_numpy(a, ctype=ct))
    return fr


BIT, REL, C16 = "bit", "rel", "c16"
# x 0, k 1, g 2, s 3, p 4, z 5, h 6, w 7
# (case, group, statements: the last one's value, or every one's for a
# list, is held to one process's, bar)
CASES = [
    # cleaning and type
    ("as.factor", "clean", ["(as.factor (cols {f} [1]))"], BIT),
    ("asfactor", "clean", ["(asfactor (cols {f} [0 1]))"], BIT),
    ("impute_mean", "clean", ["(tmp= {t}_im (cols {f} [0 1]))",
                              "(h2o.impute {t}_im 0 'mean' 'interpolate' "
                              "[] _ _)", "{t}_im"], REL),
    ("impute_median", "clean", ["(tmp= {t}_id (cols {f} [0 1]))",
                                "(h2o.impute {t}_id 0 'median' "
                                "'interpolate' [] _ _)", "{t}_id"], BIT),
    ("impute_mode", "clean", ["(tmp= {t}_io (cols {f} [1 2]))",
                              "(h2o.impute {t}_io 0 'mode' 'interpolate' "
                              "[] _ _)",
                              "(h2o.impute {t}_io 1 'mode' 'interpolate' "
                              "[] _ _)", "{t}_io"], BIT),
    ("fillna_forward", "clean", ["(h2o.fillna (cols {f} [0 1 4]) "
                                 "'forward' 0 3)"], BIT),
    ("fillna_backward", "clean", ["(h2o.fillna (cols {f} [0 1]) "
                                  "'backward' 0 2)"], BIT),
    ("fillna_rows", "clean", ["(h2o.fillna (cols {f} [0 1 4]) "
                              "'forward' 1 1)"], BIT),
    ("scale", "clean", ["(scale (cols {f} [0 1 4]) 1 1)"], REL),
    ("cut", "clean", ["(cut (cols {f} [0]) [-9 -8 -0.5 0 0.5 2] [] 1 1 3)"],
     BIT),
    ("cut_labels", "clean", ["(cut (cols {f} [1]) [0 2 4 6] "
                             "['lo' 'mid' 'hi'] 0 0 3)"], BIT),
    ("which", "clean", ["(which (> (cols {f} [0]) 0.5))"], BIT),
    ("getrow", "clean", ["(getrow (rows (cols {f} [0 1 2 3]) [150]))"],
     BIT),
    ("any.na", "clean", ["(any.na (cols {f} [3]))",
                         "(any.na (cols {f} [5 7]))"], BIT),
    ("filterNACols", "clean", ["(filterNACols {f} 0.1)"], BIT),
    ("dropdup_first", "clean", ["(dropdup {f} [1 2] 'first')"], BIT),
    ("dropdup_last", "clean", ["(dropdup (cols {f} [5 0]) [0] 'last')"],
     BIT),
    # statistics
    ("cor", "stats", ["(cor (cols {f} [0 4 5]) (cols {f} [0 4 5]) "
                      "'complete.obs' 'pearson')"], REL),
    ("cor_pair", "stats", ["(cor (cols {f} [5]) (cols {f} [7]) "
                           "'everything' 'pearson')"], REL),
    ("skewness", "stats", ["(skewness (cols {f} [0 5]) True)"], REL),
    ("kurtosis", "stats", ["(kurtosis (cols {f} [7]) True)"], REL),
    ("distance", "stats", ["(distance (cols {f} [4 5]) {o} 'l2')"], BIT),
    ("hist", "stats", ["(hist (cols {f} [0]) 10)",
                       "(hist (cols {f} [5]) [-3 -1 0 1 3])",
                       "(hist (cols {f} [5]) 'sturges')"], BIT),
    ("hist_rules", "stats", ["(hist (cols {f} [5]) 'scott')",
                             "(hist (cols {f} [7]) 'fd')",
                             "(hist (cols {f} [7]) 'doane')"], REL),
    ("mode", "stats", ["(mode (cols {f} [2]))", "(mode (cols {f} [1]))",
                       "(mode (cols {f} [5]))"], BIT),
    ("mad", "stats", ["(mad (cols {f} [0]) 1.4826)"], BIT),
    ("h2o.mad", "stats", ["(h2o.mad (cols {f} [5]) 'interpolate' 1.4826)",
                          "(h2o.mad (rows (cols {f} [5]) [0:202]) 'low' "
                          "1.4826)",
                          "(h2o.mad (rows (cols {f} [5]) [1:202]) 'high' "
                          "1.4826)",
                          "(h2o.mad (cols {f} [0]) 'high' 1.4826)"], BIT),
    ("entropy", "stats", ["(entropy (cols {f} [3]))",
                          "(entropy (cols {f} [2]))"], BIT),
    ("topn", "stats", ["(topn {f} 5 10 1)", "(topn {f} 0 7 -1)"], BIT),
    # cumulative and window
    ("cumsum", "scan", ["(cumsum (cols {f} [0]) 0)"], C16),
    ("cumprod", "scan", ["(cumprod (cols {f} [4]) 0)"], REL),
    ("cummin", "scan", ["(cummin (cols {f} [7]) 0)",
                        "(cummin (cols {f} [0]) 0)"], BIT),
    ("cummax", "scan", ["(cummax (* (cols {f} [7]) -1) 0)",
                        "(cummax (cols {f} [5]) 0)"], BIT),
    ("difflag1", "scan", ["(difflag1 (cols {f} [0]))",
                          "(difflag1 (cols {f} [2]))"], BIT),
    ("rank_within_groupby", "scan", [
        '(rank_within_groupby {f} [6] [0] [1] "r" 0)',
        '(rank_within_groupby {f} [2 6] [1 0] [0 1] "r" 0)',
        '(rank_within_groupby {f} [1] [5] [1] "r" 0)'], BIT),
    # whole-column reductions
    ("sumaxis", "reduce", ["(sumaxis (cols {f} [0 1 4]) 1 0)"], REL),
    ("sumaxis_rows", "reduce", ["(sumaxis (cols {f} [0 1 4]) 1 1)"], BIT),
    ("sumNA", "reduce", ["(sumNA (cols {f} [5]) 1)",
                         "(sumNA (cols {f} [0 5]) 1)"], REL),
    ("prod", "reduce", ["(prod (cols {f} [4]))"], REL),
    ("prod.na", "reduce", ["(prod.na (cols {f} [4]))"], REL),
    ("which.max", "reduce", ["(which.max (cols {f} [0 1 5]) True 0)",
                             "(which.max (cols {f} [0 5]) True 1)"], BIT),
    ("which.min", "reduce", ["(which.min (cols {f} [0 1 5]) True 0)"], BIT),
    ("all", "reduce", ["(all (> (cols {f} [7]) -1))",
                       "(all (> (cols {f} [5]) 0))"], BIT),
    ("any", "reduce", ["(any (> (cols {f} [0]) 2.5))",
                       "(any (> (cols {f} [5]) 9))"], BIT),
]
CASE_IDS = [c[0] for c in CASES]


def _other(key):
    """distance's second frame: 3 rows held whole by every rank."""
    with M.use(None):
        return _frame({"a": (np.array([0.5, -1.0, 2.0], np.float32), None),
                       "b": (np.array([1.0, 0.0, -0.5], np.float32), None)},
                      key=key)


def _statements(tag, cols):
    """Every case's values (`_local` for a frame) and the rows gathered
    through it, in this thread's mesh (none: one process)."""
    from h2o3_tpu_torch.rapids import Session, exec_rapids

    fr = _frame(cols, key=f"spr_{tag}")
    fr.install()
    other = _other(f"spr_o_{tag}")
    other.install()
    sess = Session(f"spr_s_{tag}")
    out = {}
    try:
        for name, _grp, sts, _bar in CASES:
            before = SF.counters()["gathered_rows"]
            vals = []
            for st in sts:
                v = exec_rapids(st.format(f=fr.key, t=f"spr_{tag}",
                                          o=other.key), sess)
                vals.append(_local(v) if isinstance(v, Frame) else v)
            out[name] = (vals, SF.counters()["gathered_rows"] - before)
    finally:
        sess.end()
        th.DKV.remove(str(fr.key))
        th.DKV.remove(str(other.key))
    return out


_RUNS = {}


def _runs(R):
    """(one process's values, every rank's), made once per R."""
    if "one" not in _RUNS:
        _RUNS["one"] = _statements("one", _cols())
    if R not in _RUNS:
        _RUNS[R] = run_ranks(R, lambda r, m: _statements(f"{R}_{r}",
                                                         _cols()))
    return _RUNS["one"], _RUNS[R]


def _close(a, b, bar, ctx, scale=0.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, ctx
    assert np.array_equal(np.isnan(a), np.isnan(b)), ctx
    ok = ~np.isnan(a)
    tol = (1e-5 * scale) if bar == C16 else (1e-6 * np.abs(a[ok]) + 1e-7)
    assert np.all(np.abs(a[ok] - b[ok]) <= tol), (ctx, a, b)


def _held(one, got, R, r, bar, ctx, scale=0.0):
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
            _close(v1[lo:hi], v2, bar, (ctx, nm), scale)


@pytest.mark.parametrize("R", [2, 3])
@pytest.mark.parametrize("case", CASE_IDS)
def test_prim_on_a_sharded_frame(case, R):
    """Each ported prim on R thread ranks: every rank's result held to
    one process's at the case's bar, and no rank gathered a row."""
    one, ranks = _runs(R)
    bar = dict((c[0], c[3]) for c in CASES)[case]
    x = _cols()["x"][0]
    scale = float(np.nansum(np.abs(x)))
    for r, got in enumerate(ranks):
        vals, gathered = got[case]
        assert gathered == 0, (case, r, gathered)
        for i, (a, b) in enumerate(zip(one[case][0], vals)):
            _held(a, b, R, r, bar, (case, i, r), scale)


def test_the_replicated_results_are_whole_on_every_rank():
    """hist's table and cor's matrix are held whole by every rank (no
    rank reads them as a block of rows)."""
    _one, ranks = _runs(2)
    for got in ranks:
        for case in ("hist", "cor"):
            for v in got[case][0]:
                assert v[1] is None and all(len(c[2]) == v[0]
                                            for c in v[2].values()), case


# -- C50: the frame methods ---------------------------------------------------

def _c50(tag):
    """The C50 frame methods on one frame: enum and numeric mode imputes,
    asfactor, unique; -> ({name: value}, rows gathered)."""
    from h2o3_tpu_torch.frame_factory import H2OFrame

    cols = _cols()
    before = SF.counters()["gathered_rows"]
    out = {}
    fr = H2OFrame._wrap(_frame({k: cols[k] for k in ("g", "k", "x")},
                               key=f"c50_{tag}"))
    try:
        out["fill_g"] = fr.impute("g", "mode")
        out["fill_k"] = fr.impute("k", "mode")
        out["imputed"] = _local(fr)
        fac = fr.subframe(["k", "x"])
        fac = H2OFrame._wrap(fac)
        out["asfactor"] = _local(fac.asfactor())
        out["unique_k"] = _local(H2OFrame._wrap(fr.subframe(["k"])).unique())
        out["unique_g"] = _local(H2OFrame._wrap(fr.subframe(["g"])).unique())
    finally:
        th.DKV.remove(f"c50_{tag}")
    return out, SF.counters()["gathered_rows"] - before


@pytest.mark.parametrize("R", [2, 3])
def test_c50_frame_methods_take_the_clouds_answer_without_gathering(R):
    """ROADMAP C50: `H2OFrame.impute(col, "mode")` on an enum column fills
    every rank with the cloud's mode ("b", which rank 0's rows alone do
    not favour), bitwise one process's; the numeric mode, `asfactor` and
    `unique` gather no row."""
    one, _ = _c50("one")
    assert one["fill_g"] == [1.0]              # "b"
    for r, (got, gathered) in enumerate(run_ranks(
            R, lambda r, m: _c50(f"{R}_{r}"))):
        assert gathered == 0, r
        assert got["fill_g"] == one["fill_g"] and \
            got["fill_k"] == one["fill_k"], r
        for k in ("imputed", "asfactor", "unique_k", "unique_g"):
            _same_block(one[k], got[k], R, r, k)


def _factor_levels(tag, n=100_000):
    """`as.factor` (Rapids) and `H2OFrame.asfactor` of a column of n
    distinct integers (shuffled, NA every 997th row) -> ((values), rows
    gathered)."""
    from h2o3_tpu_torch.frame_factory import H2OFrame
    from h2o3_tpu_torch.rapids import Session, exec_rapids

    v = (np.random.default_rng(5).permutation(n) - n // 2).astype(np.float32)
    v[::997] = np.nan
    fr = _frame({"id": (v, None)}, key=f"lev_{tag}")
    fr.install()
    sess = Session(f"lev_s_{tag}")
    before = SF.counters()["gathered_rows"]
    try:
        out = (_local(exec_rapids(f"(as.factor (cols {fr.key} [0]))", sess)),
               _local(H2OFrame._wrap(fr).asfactor()))
    finally:
        sess.end()
        th.DKV.remove(str(fr.key))
    return v, out, SF.counters()["gathered_rows"] - before


def test_as_factor_of_a_column_of_1e5_levels():
    """A numeric column of 1e5 distinct integers made a factor, by Rapids'
    `as.factor` and by `H2OFrame.asfactor`: one process's domain and
    codes are those of interning every row's label (`Column.from_numpy`),
    and each of two ranks' blocks is one process's, no row gathered. The
    labels are looked up by hash, so 1e5 levels cost what a few do."""
    v, one, _ = _factor_levels("one")
    for (n, _sh, cols), label in zip(one, (lambda x: "%g" % x,
                                           lambda x: str(int(x)))):
        ref = Column.from_numpy(np.array(
            [None if np.isnan(x) else label(x) for x in v], object),
            ctype="enum")
        ctype, dom, codes = cols["id"]
        assert n == len(v) and ctype == ref.ctype and dom == ref.domain
        assert len(dom) == 100_000 - len(v[::997])
        assert np.array_equal(codes.astype(np.int64),
                              ref.data.numpy().astype(np.int64))
    for r, (_v, got, gathered) in enumerate(run_ranks(
            2, lambda r, m: _factor_levels(f"2_{r}"))):
        assert gathered == 0, r
        for a, b, ctx in zip(one, got, ("as.factor", "asfactor")):
            _same_block(a, b, 2, r, ctx)


def test_c50_enum_mode_against_the_jax_package(cl):
    """The cloud's enum mode fill is the JAX package's (its impute takes
    the mode over every row)."""
    from h2o3_tpu.core.frame import Column as JColumn, Frame as JFrame
    from h2o3_tpu.ops.impute import impute as jimpute

    cols = _cols(192)
    jf = JFrame()
    for nm in ("g", "k"):
        jf.add(nm, JColumn.from_numpy(cols[nm][0], ctype=cols[nm][1]))
    want = [jimpute(jf, "g", "mode"), jimpute(jf, "k", "mode")]
    from h2o3_tpu_torch.ops.impute import impute

    def rank(r, m):
        fr = _frame({nm: cols[nm] for nm in ("g", "k")})
        got = [impute(fr, "g", "mode"), impute(fr, "k", "mode")]
        return got, _gathered(fr)

    for got, fr in run_ranks(2, rank):
        assert got == want
        assert_same(jf, fr, ctx="imputed")


def _segments(tag):
    cols = _cols()
    rng = np.random.default_rng(5)
    y = np.where(rng.random(N) < 0.5, "Y", "N").astype(object)
    fr = _frame({"h": (np.where(cols["h"][0] == None, "u",  # noqa: E711
                                cols["h"][0]).astype(object), "enum"),
                 "z": cols["z"], "w": cols["w"], "y": (y, "enum")},
                key=f"seg_{tag}")
    before = SF.counters()["gathered_rows"]
    sm = th.train_segments(th.GBM, dict(ntrees=3, max_depth=3, seed=1),
                           fr, ["h"], y="y")
    ko = th.train_segments(th.KMeans, dict(k=2), fr, ["h"])
    gathered = SF.counters()["gathered_rows"] - before
    out = []
    for row in sm.rows:
        m = th.DKV.get(row["model_id"])
        out.append((row["segment"], row["status"],
                    float(m._output.training_metrics.logloss)))
    refused = [(r["status"], "A14.6c" in (r["errors"] or ""))
               for r in ko.rows]
    return out, refused, gathered


@pytest.mark.parametrize("R", [2, 3])
def test_c50_segment_keys_are_gathered_as_keys_not_rows(R):
    """`train_segments` on a sharded frame: the distinct keys all-gathered,
    each segment's rows placed through the exchange; GBM trains per
    segment bitwise one process's (its training logloss), a builder
    without a sharded path records its A14.6c refusal; 0 rows
    gathered."""
    one, one_ko, _ = _segments("one")
    assert [s for s, _st, _l in one] == [{"h": "u"}, {"h": "v"}]
    assert one_ko == [("SUCCEEDED", False)] * 2
    for got, refused, gathered in run_ranks(
            R, lambda r, m: _segments(f"{R}_{r}")):
        assert gathered == 0
        assert got == one
        assert refused == [("FAILED", True)] * 2


# -- what stays refused (A14.6c part 4) -----------------------------------

_MODEL = {}


def _one_gbm():
    """A one-process GBM (trained once) whose explanation methods the
    sharded frames below reach."""
    if "gbm" not in _MODEL:
        with M.use(None):
            fr = _frame({"x": (np.arange(64, dtype=np.float32), None),
                         "y": (np.array(["u", "v"], object)[
                             np.arange(64) % 2], "enum")})
            _MODEL["gbm"] = th.GBM(ntrees=2, max_depth=2, seed=1).train(
                y="y", training_frame=fr)
    return _MODEL["gbm"]


def _refused_frame():
    return _frame({"x": (np.arange(8, dtype=np.float32), None),
                   "y": (np.array(["u", "v", "w", "u", "v", "w", "u", "v"],
                                  object), "enum")})


# work that A14.6c part 4 still has to port: the builders without a
# sharded path and the DeepLearning autoencoder
STILL_REFUSED = {
    "kmeans": lambda fr, m: th.KMeans(k=2).train(training_frame=fr),
    "isolation_forest": lambda fr, m: th.IsolationForest(ntrees=2).train(
        training_frame=fr),
    "pca": lambda fr, m: th.PCA(k=1).train(training_frame=fr),
    "dl_autoencoder": lambda fr, m: th.DeepLearning(
        epochs=1, autoencoder=True).train(training_frame=fr),
}


@pytest.mark.parametrize("name", list(STILL_REFUSED))
def test_part_1b_prims_still_refuse_a_sharded_frame(name):
    """What stays refused on a row-sharded frame once part 1b's prims
    run there (tests/test_torch_sharded_reshape.py): each item of
    ROADMAP A14.6c part 4 raises naming it, on both ranks, without
    gathering a row."""
    model = _one_gbm()

    def rank(r, m):
        fr = _refused_frame()
        before = SF.counters()["gathered_rows"]
        with pytest.raises(NotImplementedError, match="A14.6c"):
            STILL_REFUSED[name](fr, model)
        return SF.counters()["gathered_rows"] - before

    assert run_ranks(2, rank) == [0, 0]


def test_distance_to_a_sharded_frame_and_an_append_refuse():
    """`distance` to a row-sharded frame and a streaming append now run
    on the mesh (tests/test_torch_sharded_reshape.py); what still
    refuses beside them: AutoML's target-encoding stage and an Extended
    Isolation Forest train (ROADMAP A14.6c part 4)."""
    from h2o3_tpu_torch.rapids.eval import PRIMS

    def rank(r, m):
        fr = _refused_frame()
        got = PRIMS["distance"](None, fr.subframe(["x"]), fr.subframe(["x"]),
                                "l2")
        assert got.ncols == 8 and got.shard == m.rows(8)
        with pytest.raises(NotImplementedError, match="A14.6c"):
            th.H2OAutoML(max_models=1, seed=1, preprocessing=[
                "target_encoding"], project_name=f"te_{r}").train(
                    y="y", training_frame=fr)
        with pytest.raises(NotImplementedError, match="A14.6c"):
            th.ExtendedIsolationForest(ntrees=2).train(training_frame=fr)
        return True

    assert run_ranks(2, rank) == [True, True]


# -- against the JAX package, one case a group ---------------------------------------

JAX_GROUPS = {
    "clean": [("(as.factor (cols {f} [1]))", None, 0),
              ("(h2o.fillna (cols {f} [0 1]) 'forward' 0 3)", None, 0),
              ("(cut (cols {f} [0]) [-9 -8 -0.5 0 0.5 2] [] 1 1 3)", None, 0),
              ("(which (> (cols {f} [0]) 0.5))", None, 0),
              ("(dropdup {f} [1 2] 'first')", None, 0),
              ("(scale (cols {f} [0 1]) 1 1)", 1e-5, 1.0),
              ("(filterNACols {f} 0.1)", None, 0),
              ("(any.na (cols {f} [3]))", None, 0)],
    "stats": [("(cor (cols {f} [0 4 5]) (cols {f} [0 4 5]) "
               "'complete.obs' 'pearson')", 1e-5, 1.0),
              ("(skewness (cols {f} [5]) True)", 1e-5, 1.0),
              ("(hist (cols {f} [0]) 10)", None, 0),
              ("(mode (cols {f} [2]))", None, 0),
              ("(mad (cols {f} [0]) 1.4826)", None, 0),
              ("(h2o.mad (cols {f} [5]) 'interpolate' 1.4826)", None, 0),
              ("(topn {f} 0 7 1)", None, 0)],
    "scan": [("(cumsum (cols {f} [0]) 0)", 1e-5, "sum"),
             ("(cummin (cols {f} [7]) 0)", None, 0),
             ("(cummax (cols {f} [5]) 0)", None, 0),
             ("(difflag1 (cols {f} [0]))", None, 0),
             ('(rank_within_groupby {f} [6] [0] [1] "r" 0)', None, 0)],
    "reduce": [("(sumaxis (cols {f} [0 1 4]) 1 0)", 1e-5, 100.0),
               ("(prod (cols {f} [4]))", 1e-5, 0),
               ("(which.max (cols {f} [0 1 5]) True 0)", None, 0),
               ("(which.min (cols {f} [0 1 5]) True 0)", None, 0),
               ("(all (> (cols {f} [7]) -1))", None, 0)],
}


@pytest.mark.parametrize("group", list(JAX_GROUPS))
def test_prim_group_against_the_jax_package(cl, group):
    """A group's statements in the reference on its 8-device mesh and in
    the port on 2 ranks (the port's frames gathered after each statement
    to compare)."""
    from h2o3_tpu.core.frame import Column as JColumn, Frame as JFrame
    from h2o3_tpu.rapids import Session as JSession
    from h2o3_tpu.rapids import exec_rapids as jexec

    cols = _cols(256, seed=4)
    jf = JFrame(key="sprj_ref")
    for nm, (a, ct) in cols.items():
        jf.add(nm, JColumn.from_numpy(a, ctype=ct))
    jf.install()
    js = JSession("sprj_ref_s")
    sts = JAX_GROUPS[group]
    want = [jexec(st.format(f="sprj_ref"), js) for st, _r, _s in sts]
    js.end()

    def rank(r, m):
        from h2o3_tpu_torch.rapids import Session, exec_rapids

        fr = _frame(cols, key=f"sprj_{group}_{r}")
        fr.install()
        sess = Session(f"sprj_s_{group}_{r}")
        try:
            out = []
            for st, _r, _s in sts:
                v = exec_rapids(st.format(f=fr.key), sess)
                out.append(_gathered(v) if isinstance(v, Frame) else v)
            return out
        finally:
            sess.end()
            th.DKV.remove(str(fr.key))

    x = cols["x"][0]
    for got in run_ranks(2, rank):
        for (st, rtol, scale), a, b in zip(sts, want, got):
            if scale == "sum":
                scale = float(np.nansum(np.abs(x)))
            assert_same(a, b, rtol=rtol, scale=scale, zero_sign=False,
                        ctx=st)


def test_c51_rollup_sigma_moves_where_moments_hold():
    """ROADMAP C51: on a column whose mean is large against its sd (p,
    near 1), the rollups' float32 one-pass sigma moves past C46's 1e-6
    between one process and two ranks; the float64 two-pass moments
    that `scale` and the moment prims take agree to 1e-12."""
    from h2o3_tpu_torch.ops.rollups import moments

    p = {"p": _cols()["p"]}

    def stats():
        c = _frame(p).col("p")
        nn, _t, s2, _ = moments(c.data.double(), 2, SF.sharded_mesh(c))
        return c.rollups.sigma, float(np.sqrt(s2 / (nn - 1)))

    one = stats()
    for sigma, sd in run_ranks(2, lambda r, m: stats()):
        assert abs(sigma - one[0]) > 1e-6 * one[0]
        assert abs(sd - one[1]) <= 1e-12 * one[1]
