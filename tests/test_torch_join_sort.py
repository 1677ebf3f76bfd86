"""The port's sort, merge, group-by and window ops (h2o3_tpu_torch/ops/
sort.py, merge.py, groupby.py, window.py) against the JAX package's, on
the CPU, after the reference's test_join_sort.py.

Tolerances: bit for bit for sort permutations (NA, +inf, descending,
multi-key, heavy ties), join output (values and row order; inner, left,
right and full; numeric, enum, string and multi-column keys; NA and
duplicate keys), group levels, row order, counts, min and max,
rank_within_groupby and difflag1, all up to the sign of a zero where
the reference gathers rows on its 8-device mesh (it sums the shards'
parts, so -0 comes back +0); group sums, means, sd and var to 1e-5
relative (the reference adds float32 partials per shard, ROADMAP C2).
The frames stay below the reference's sample-sort threshold (250k rows),
so both packages take the global stable argsort. gpu-marked tests hold
the card to the CPU and skip without a card."""

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th

from torch_port_support import assert_same, both_frames


def _sorted_ids(cols, by, ascending=True):
    from h2o3_tpu.ops.sort import sort_frame as jsort

    from h2o3_tpu_torch.ops.sort import sort_frame as tsort

    n = len(next(iter(cols.values()))[0])
    cols = dict(cols, rid=(np.arange(n, dtype=float), None))
    jf, tf = both_frames(cols)
    j, t = jsort(jf, by, ascending), tsort(tf, by, ascending)
    assert_same(j, t, zero_sign=False, ctx=(by, ascending))
    return t.col("rid").to_numpy().astype(np.int64)


def test_sort_na_and_inf_interleave_in_row_order(cl):
    """NaN reads as +inf and the sort is stable, so NA rows and real
    +inf rows keep their row order (a NaN-last sort would put every NA
    after every +inf); descending negates, so NA stays last."""
    a = np.array([np.inf, np.nan, 1.0, np.inf, np.nan, -np.inf, 0.0, -0.0])
    assert list(_sorted_ids({"a": (a, None)}, ["a"])) == \
        [5, 6, 7, 2, 0, 1, 3, 4]
    assert list(_sorted_ids({"a": (a, None)}, ["a"], False)) == \
        [0, 3, 2, 6, 7, 1, 4, 5]


@pytest.mark.parametrize("case", ["normal_na", "ties", "desc_ties",
                                  "enum_then_num", "num_desc_enum",
                                  "three_keys"])
def test_sort_permutations_bitwise(cl, case):
    rng = np.random.default_rng(len(case))
    n = 20_000
    a = rng.standard_normal(n)
    a[rng.random(n) < 0.05] = np.nan
    a[rng.random(n) < 0.01] = np.inf
    k = rng.integers(0, 4, n).astype(float)
    g = np.array(["u", "v", "w"], object)[rng.integers(0, 3, n)]
    g[rng.random(n) < 0.05] = None
    cols = {"a": (a, None), "k": (k, None), "g": (g, "enum")}
    by, asc = {"normal_na": (["a"], True), "ties": (["k"], True),
               "desc_ties": (["k"], False),
               "enum_then_num": (["g", "a"], True),
               "num_desc_enum": (["k", "g"], [False, True]),
               "three_keys": (["g", "k", "a"], [True, False, True])}[case]
    ids = _sorted_ids(cols, by, asc)
    # numpy's stable lexsort of the same keys (NaN -> +inf, -x for desc)
    keys = []
    for name, up in zip(by, asc if isinstance(asc, list) else [asc] * 3):
        v = (np.where(g == None, np.nan, np.searchsorted(  # noqa: E711
            ["u", "v", "w"], g.astype(str))) if name == "g"
             else cols[name][0]).astype(np.float32)
        v = v if up else -v
        keys.append(np.where(np.isnan(v), np.inf, v))
    want = np.lexsort(tuple(reversed(keys)))
    np.testing.assert_array_equal(ids, want)


def test_sort_rows_window(cl):
    from h2o3_tpu.ops.sort import sort_frame as jsort

    from h2o3_tpu_torch.ops.sort import sort_frame as tsort

    rng = np.random.default_rng(4)
    jf, tf = both_frames({"a": (rng.standard_normal(500), None)})
    assert_same(jsort(jf, "a", rows=(10, 40)), tsort(tf, "a", rows=(10, 40)),
                zero_sign=False)


def _join_cols(seed=3, nl=700, nr=500, kmax=200):
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, kmax, nl).astype(float)
    rk = rng.integers(0, kmax, nr).astype(float)
    lk[[5, 77]] = np.nan
    rk[[3]] = np.nan
    left = {"k": (lk, None), "lv": (rng.normal(size=nl), None),
            "lg": (np.array(["p", "q"], object)[rng.integers(0, 2, nl)],
                   "enum")}
    right = {"k": (rk, None), "rv": (rng.normal(size=nr), None),
             "lg": (np.array(["s", "t"], object)[rng.integers(0, 2, nr)],
                    "enum")}
    return left, right


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
@pytest.mark.parametrize("keys", ["numeric", "enum", "string", "multi"])
def test_merge_rows_and_order_bitwise(cl, how, keys):
    from h2o3_tpu.ops.merge import merge as jmerge

    from h2o3_tpu_torch.ops.merge import merge as tmerge

    left, right = _join_cols()
    if keys in ("enum", "string"):
        labels = np.array([f"k{i:03d}" for i in range(200)], object)
        for side in (left, right):
            v = side["k"][0]
            lab = np.where(np.isnan(v), None,
                           labels[np.nan_to_num(v).astype(int)])
            side["k"] = (lab, "enum" if keys == "enum" else None)
    if keys == "multi":
        for side, seed in ((left, 1), (right, 2)):
            n = len(side["k"][0])
            side["k2"] = (np.random.default_rng(seed).integers(
                0, 3, n).astype(float), None)
    jl, tl = both_frames(left)
    jr, tr = both_frames(right)
    by = ["k", "k2"] if keys == "multi" else ["k"]
    kw = dict(all_x=how in ("left", "full"), all_y=how in ("right", "full"),
              by_x=by, by_y=by)
    assert_same(jmerge(jl, jr, **kw), tmerge(tl, tr, **kw), zero_sign=False,
                ctx=(how, keys))


def test_merge_na_keys_never_match(cl):
    from h2o3_tpu.ops.merge import merge as jmerge

    from h2o3_tpu_torch.ops.merge import merge as tmerge

    jl, tl = both_frames({"k": (np.array([1.0, np.nan]), None),
                          "lv": (np.array([10.0, 20.0]), None)})
    jr, tr = both_frames({"k": (np.array([np.nan, 1.0]), None),
                          "rv": (np.array([7.0, 8.0]), None)})
    assert tmerge(tl, tr).nrows == 1
    for kw in ({}, {"all_x": True, "all_y": True}):
        assert_same(jmerge(jl, jr, **kw), tmerge(tl, tr, **kw))
    assert tmerge(tl, tr, all_x=True, all_y=True).nrows == 3


def test_merge_float32_keys_collide_above_2_24(cl):
    """Join keys compare as float32 in both packages: 2**24 and
    2**24 + 1 are one float32, so they match each other (ROADMAP C15)."""
    from h2o3_tpu.ops.merge import merge as jmerge

    from h2o3_tpu_torch.ops.merge import merge as tmerge

    big = float(2 ** 24)
    jl, tl = both_frames({"k": (np.array([big, big + 1, 5.0]), None),
                          "lv": (np.arange(3.0), None)})
    jr, tr = both_frames({"k": (np.array([big + 1, 5.0]), None),
                          "rv": (np.array([1.0, 2.0]), None)})
    t = tmerge(tl, tr)
    assert t.nrows == 3                     # exact integers would give 2
    assert_same(jmerge(jl, jr), t)


def _group_cols(seed=0, n=30_000):
    rng = np.random.default_rng(seed)
    g1 = np.array(["a", "b", "c", "d"], object)[rng.integers(0, 4, n)]
    g1[rng.random(n) < 0.02] = None
    g2 = np.array(["x", "y", "z"], object)[rng.integers(0, 3, n)]
    x = rng.standard_normal(n) * 10 + 3
    x[rng.random(n) < 0.03] = np.nan
    k = rng.integers(-3, 4, n).astype(float)
    k[rng.random(n) < 0.01] = np.nan
    return {"g1": (g1, "enum"), "g2": (g2, "enum"), "x": (x, None),
            "k": (k, None)}


@pytest.mark.parametrize("by", [["g1"], ["g1", "g2"], ["k"], ["g2", "k"]])
def test_groupby_levels_counts_and_sums(cl, by):
    from h2o3_tpu.ops.groupby import GroupBy as JGroupBy

    from h2o3_tpu_torch.ops.groupby import GroupBy as TGroupBy

    jf, tf = both_frames(_group_cols())

    def run(G, fr, ops):
        gb = G(fr, by).count()
        for op in ops:
            getattr(gb, op)("x")
        return gb.get_frame()

    exact = ("min", "max")
    assert_same(run(JGroupBy, jf, exact), run(TGroupBy, tf, exact))
    j = run(JGroupBy, jf, ("sum", "mean", "sd", "var"))
    t = run(TGroupBy, tf, ("sum", "mean", "sd", "var"))
    assert_same(j, t, rtol=1e-5, scale=1.0)


def test_group_sums_are_order_free(cl):
    """The port's group sums are int64 fixed point: the same bits under
    any row order, and the float64 sum rounded once (to an ulp); the
    reference's float32 partials agree to 1e-5 (ROADMAP C2)."""
    from h2o3_tpu_torch.ops.groupby import group_aggregates

    cols = _group_cols(seed=5)
    codes = torch.from_numpy(np.searchsorted(
        ["a", "b", "c", "d"], np.where(cols["g1"][0] == None, "a",  # noqa
                                       cols["g1"][0]).astype(str)))
    x = torch.from_numpy(cols["x"][0].astype(np.float32))
    perm = torch.from_numpy(np.random.default_rng(1).permutation(len(x)))
    a = group_aggregates(codes, x, 4)
    b = group_aggregates(codes[perm], x[perm], 4)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    xv = np.where(np.isnan(cols["x"][0]), 0, x.numpy().astype(np.float64))
    exact = np.bincount(codes.numpy(), weights=xv, minlength=4)
    np.testing.assert_allclose(a[1].numpy(), exact, rtol=1.2e-7)


def test_window_ops_bitwise(cl):
    from h2o3_tpu.rapids import Session as JSession
    from h2o3_tpu.rapids import exec_rapids as jexec

    from torch_port_support import install_both

    cols = _group_cols(seed=9, n=5000)
    cols["n"] = (np.where(np.arange(5000) % 97 == 0, np.nan,
                          np.arange(5000) % 11).astype(float), None)
    install_both("win.hex", cols)
    js, ts = JSession("w"), th.Session("w")
    for expr in ['(rank_within_groupby win.hex [0] [2] [1] "r" 0)',
                 '(rank_within_groupby win.hex [0 1] [3 2] [0 1] "r" 0)',
                 '(rank_within_groupby win.hex [4] [2] [0] "r" 0)',
                 "(difflag1 (cols win.hex [2]))",
                 "(difflag1 (cols win.hex [3]))"]:
        assert_same(jexec(expr, js), th.exec_rapids(expr, ts), ctx=expr)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_card_matches_cpu_bitwise():
    """On the card: sort permutations, join pairs, group levels, counts
    and sums, ranks equal the CPU's bit for bit; cumsum agrees to 1e-5
    of the running magnitude (the card scans in parallel, ROADMAP C16)."""
    _card()
    from h2o3_tpu_torch.ops.groupby import GroupBy
    from h2o3_tpu_torch.ops.merge import merge
    from h2o3_tpu_torch.ops.sort import sort_frame
    from h2o3_tpu_torch.rapids.eval import cumulative

    from torch_port_support import frames_bitwise

    cols = _group_cols(seed=3, n=100_000)
    left, right = _join_cols(nl=100_000, nr=20_000, kmax=5000)
    out = {}
    for dev in ("cpu", "cuda"):
        th.init(device=dev)
        fr = th.Frame()
        for n, (a, ct) in cols.items():
            fr.add(n, th.Column.from_numpy(a, ctype=ct, device=dev))
        lf, rf = th.Frame(), th.Frame()
        for side, f in ((left, lf), (right, rf)):
            for n, (a, ct) in side.items():
                f.add(n, th.Column.from_numpy(a, ctype=ct, device=dev))
        gb = GroupBy(fr, ["g1", "g2"]).count().sum("x").min("x").get_frame()
        out[dev] = (sort_frame(fr, ["g1", "x"]), merge(lf, rf),
                    merge(lf, rf, all_x=True, all_y=True), gb,
                    cumulative("add", fr.col("x").data).cpu().numpy())
    th.init(device="cpu")
    for a, b in zip(out["cpu"][:4], out["cuda"][:4]):
        frames_bitwise(a, b)
    x = np.nan_to_num(cols["x"][0].astype(np.float64))
    np.testing.assert_allclose(out["cuda"][4], out["cpu"][4], rtol=0,
                               atol=1e-5 * np.abs(x).sum())
