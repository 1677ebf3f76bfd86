"""The port's extended Rapids prims (h2o3_tpu_torch/rapids/prims_ext.py)
and the rest of eval.py's against the JAX package's, on the CPU: the
same frames under the same keys in both DKVs, the same statements
through both evaluators, family by family; one test checks that the
statements below name every prim the port registers.

Tolerances:
- bit for bit: the host suites (strings, time, search, repeaters,
  hist, mode, the kfold and split prims, runif, the munging prims),
  which/which.max/which.min, t, difflag1, rank_within_groupby, fillna,
  the structure prims (cols, rows, cbind, rbind, sort, merge, unique,
  table, GB levels and counts), and up to the sign of a zero where the
  reference gathers rows on its 8-device mesh (its shards' parts are
  summed, so -0 comes back +0);
- 1e-5 of max(|value|, scale): cor, distance, x (matrix product),
  skewness, kurtosis, sumaxis, prod, scale and GB's sums and means
  (float32 reductions in another order, ROADMAP C2)."""

import datetime as dt

import numpy as np
import pytest

import h2o3_tpu_torch as th

from torch_port_support import Both, assert_same, install_both

N = 120


def ext_cols(n=N, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n)
    a[rng.random(n) < 0.05] = np.nan
    g = np.array(["x", "y", "z"], object)[np.arange(n) % 3]
    g[[4, 50]] = None
    base = int(dt.datetime(2020, 3, 15, 14, 30, 45,
                           tzinfo=dt.timezone.utc).timestamp() * 1000)
    t = base + rng.integers(-10 ** 11, 10 ** 11, n)
    s = np.array(["alpha", "Beta", " gamma ", None, "delta-x"], object)[
        rng.integers(0, 5, n)]
    k = rng.integers(0, 6, n).astype(float)
    return {"a": (a, None), "b": (2.0 * np.arange(n), None),
            "g": (g, "enum"), "t": (t, "time"), "s": (s, None),
            "k": (k, None), "c": (rng.uniform(0.5, 2.0, n), None)}


@pytest.fixture(scope="module")
def frames(cl):
    rng = np.random.default_rng(1)
    install_both("ext.hex", ext_cols())
    install_both("num.hex", {n: (rng.standard_normal(N), None)
                             for n in ("p", "q", "r")})
    install_both("small.hex", {"p": (rng.standard_normal(5), None),
                               "q": (rng.standard_normal(5), None)})
    install_both("str.hex", {
        "s": (np.array(["  Apple ", "banana", "Cherry", None, "banana"],
                       object), "enum"),
        "w": (np.array(["kitten", "sitting", None, "flaw", "lawn"],
                       object), None)})
    x = np.array([1.0, np.nan, np.nan, 4.0, np.nan, 6.0, np.nan, np.nan,
                  np.nan, 10.0])
    install_both("na.hex", {"x": (x, None), "y": (x[::-1].copy(), None)})
    install_both("mp.hex", {"id": (np.array(["r1", "r2", "r3"], object),
                                   "enum"),
                            "c1": (np.array([1.0, 2.0, np.nan]), None),
                            "c2": (np.array([3.0, 4.0, 5.0]), None)})
    install_both("dd.hex", {"k": (np.array([1.0, 1.0, 2.0, 2.0, 3.0, 1.0]),
                                  None),
                            "v": (np.arange(6.0), None)})
    install_both("corpus.hex", {
        "doc": (np.array([1.0, 1.0, 2.0, 3.0]), None),
        "text": (np.array(["the cat sat", "the dog", None, "a cat a dog"],
                          object), None)})
    install_both("gp.hex", {
        "grp": (np.array(["g1", "g1", "g1", "g2", "g2"], object), "enum"),
        "perm": (np.array(["A", "B", "C", "D", "E"], object), "enum"),
        "by": (np.array(["D", "C", "C", "D", "C"], object), "enum"),
        "amt": (np.array([10.0, 20.0, 30.0, 40.0, 50.0]), None)})
    install_both("auc.hex", {
        "p": (np.array([0.1, 0.4, 0.35, 0.8, 0.8, 0.2, np.nan]), None),
        "y": (np.array([0.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0]), None)})
    install_both("gs.hex", {
        "who": (np.array(["b", "a", "b", "c", "a", "b"], object), None),
        "v": (np.array([3.0, 1.0, np.nan, 2.0, 1.0, -1.0]), None)})
    install_both("ts.hex", {"x": (rng.standard_normal((8,)), None),
                            "y": (rng.standard_normal((8,)), None),
                            "z": (rng.standard_normal((8,)), None),
                            "w": (rng.standard_normal((8,)), None)})
    return "ext.hex"


@pytest.fixture()
def both(frames):
    s = Both("ext")
    yield s
    s.end()


A, B, G, T, S, K, C = (f"(cols ext.hex [{i}])" for i in range(7))

# family -> [(statement, rtol, scale)] (rtol None: bit for bit)
FAMILIES = {
    "structure": [
        ("(cols ext.hex [0 2])", None, 0), ("(cols_py ext.hex 'g')", None, 0),
        ("(rows ext.hex [3:10])", None, 0), ("(rows ext.hex [5 1 9])", None, 0),
        ("(rows ext.hex [-1 -2])", None, 0),
        (f"(cbind {A} {B} ext.hex)", None, 0),
        ("(rbind ext.hex ext.hex)", None, 0),
        ("(colnames= ext.hex [0 1] ['x1' 'x2'])", None, 0),
        ("(append ext.hex (+ (cols ext.hex [1]) 1) 'b1')", None, 0),
        (f"(:= ext.hex {A} [1] [])", None, 0),
        ("(:= ext.hex 3 [0] [])", None, 0),
        ("(levels ext.hex)", None, 0), ("(nlevels ext.hex)", None, 0),
        ("(getrow (rows (cols ext.hex [0 1]) [2]))", None, 0),
        ("(flatten (rows (cols ext.hex [2]) [1]))", None, 0),
        ("(flatten (rows (cols ext.hex [1]) [1]))", None, 0),
        ("(none 1 2)", None, 0),
        ("(is.factor ext.hex)", None, 0), ("(is.numeric ext.hex)", None, 0),
        ("(is.character ext.hex)", None, 0),
        ("(any.factor ext.hex)", None, 0),
        ("(columnsByType ext.hex 'numeric')", None, 0),
        ("(columnsByType ext.hex 'categorical')", None, 0),
        ("(columnsByType ext.hex 'time')", None, 0),
        ("(filterNACols ext.hex 0.01)", None, 0),
        ("(any.na ext.hex)", None, 0), ("(any.na (cols ext.hex [1]))", None, 0),
        ("(nacnt (cols ext.hex [0 2 3]))", None, 0),
    ],
    "factors": [
        (f"(asfactor {K})", None, 0), (f"(as.factor {B})", None, 0),
        (f"(as.numeric {G})", None, 0), (f"(asnumeric {K})", None, 0),
        (f"(as.numeric (asfactor {K}))", None, 0),
        (f"(as.character {G})", None, 0), ("(ascharacter str.hex)", None, 0),
        (f"(relevel {G} 'z')", None, 0), (f"(setLevel {G} 'y')", None, 0),
        (f"(setDomain {G} 0 ['p' 'q' 'r'])", None, 0),
        (f"(cut {B} [0 50 100 300] ['lo' 'mid' 'hi'] 1 1 3)", None, 0),
        (f"(cut {A} [-3 0 3] [] 0 0 2)", None, 0),
    ],
    "sort_merge_group": [
        ("(sort ext.hex [0])", None, 0), ("(sort ext.hex [2 0] [1 -1])",
                                          None, 0),
        ("(sort ext.hex 'k' 0)", None, 0),
        ("(merge ext.hex (cols ext.hex [2 5]) 0 0 [] [] 'auto')", None, 0),
        ("(unique (cols ext.hex [2 5]))", None, 0),
        ("(table (cols ext.hex [2]))", None, 0),
        ("(table (cols ext.hex [2 5]))", None, 0),
        ('(GB ext.hex [2] "nrow" 0 "all" "min" 1 "all" "max" 0 "all")',
         None, 0),
        ('(GB ext.hex [2 5] "nrow" 0 "all")', None, 0),
        ('(rank_within_groupby ext.hex [2] [0] [1] "rnk" 0)', None, 0),
        ('(rank_within_groupby ext.hex [2 5] [1 0] [0 1] "rnk" 0)', None, 0),
        ('(rank_within_groupby gs.hex [0] [1] [1] "rnk" 0)', None, 0),
        ("(dropdup dd.hex [0] 'first')", None, 0),
        ("(dropdup dd.hex [0] 'last')", None, 0),
        ("(topn ext.hex 1 5 1)", None, 0), ("(topn ext.hex 0 10 -1)", None, 0),
        ("(na.omit ext.hex)", None, 0),
    ],
    "reduce": [
        ('(GB ext.hex [2] "sum" 0 "all" "mean" 1 "all" "sd" 6 "all" '
         '"var" 6 "all")', 1e-5, 1.0),
        ("(sumaxis (cols ext.hex [0 1 5 6]) 1 0)", 1e-5, 100.0),
        ("(sumaxis num.hex 1 1)", 1e-5, 3.0),
        ("(sumNA (cols ext.hex [1]) 1)", 1e-5, 1.0),
        ("(sumNA ext.hex 1)", 1e-5, 1.0),
        (f"(prod {C})", 1e-5, 0), ("(prod.na (cols dd.hex [0]))", 1e-5, 0),
        (f"(skewness {A} True)", 1e-5, 1.0),
        (f"(kurtosis {C} True)", 1e-5, 1.0), ("(skewness num.hex 1)", 1e-5, 1.0),
        ("(scale num.hex 1 1)", 1e-5, 1.0),
        ("(cor num.hex num.hex 'everything' 'pearson')", 1e-5, 1.0),
        ("(cor (cols ext.hex [0 1 5 6]) (cols ext.hex [0 1 5 6]) "
         "'complete.obs' 'pearson')", 1e-5, 1.0),
        ("(cor num.hex num.hex 'complete.obs' 'spearman')", 1e-5, 1.0),
        (f"(cor {A} {C} 'complete.obs' 'pearson')", 1e-5, 1.0),
        ("(distance (cols num.hex [1 2]) small.hex 'l2')", 1e-5, 1.0),
        ("(distance (cols num.hex [0 1]) small.hex 'l1')", 1e-5, 1.0),
        ("(distance (cols num.hex [0 1]) small.hex 'cosine')", 1e-5, 1.0),
        ("(distance (cols num.hex [0 1]) small.hex 'cosine_sq')", 1e-5, 1.0),
        ("(x (t small.hex) small.hex)", 1e-5, 1.0),
        ("(x num.hex (t (cols num.hex [0 1 2])))", 1e-5, 1.0),
    ],
    "host_numeric": [
        ("(t small.hex)", None, 0), (f"(hist {A} 10)", None, 0),
        (f"(hist {C} 'sturges')", None, 0), (f"(hist {B} [0 60 240])", None, 0),
        (f"(mode {G})", None, 0), (f"(mode {K})", None, 0),
        (f"(mad {C} 1.4826)", None, 0), (f"(h2o.mad {C} 'low' 1.4826)", None, 0),
        (f"(h2o.mad {A} 'interpolate' 1.4826)", None, 0),
        (f"(maxNA {B})", None, 0), (f"(minNA {A})", None, 0),
        (f"(signif {A} 2)", None, 0), ("(signif ext.hex 1)", None, 0),
        (f"(which (> {A} 1))", None, 0), ("(which.max num.hex True 0)", None, 0),
        ("(which.min num.hex True 1)", None, 0),
        ("(which.max num.hex True 1)", None, 0),
        (f"(match {G} ['y' 'z'] NaN _)", None, 0), (f"(match {K} [3 1] -1 _)",
                                                     None, 0),
        ("(seq 1 5 1)", None, 0), ("(seq 10 1 -2.5)", None, 0),
        ("(seq_len 4)", None, 0), ("(rep_len 7 3)", None, 0),
        (f"(rep_len (rows {C} [0:3]) 8)", None, 0),
        (f"(difflag1 {B})", None, 0), (f"(difflag1 {A})", None, 0),
        ("(h2o.fillna na.hex 'forward' 0 1)", None, 0),
        ("(h2o.fillna na.hex 'backward' 0 2)", None, 0),
        ("(h2o.fillna na.hex 'forward' 1 1)", None, 0),
        ("(perfectAUC (cols auc.hex [0]) (cols auc.hex [1]))", None, 0),
        ("(isax ts.hex 2 4 0)", None, 0),
        ("(apply (cols num.hex [0 1]) 1 { x . (max x) })", None, 0),
        ("(apply num.hex 2 { x . (max x) })", None, 0),
    ],
    "draws": [
        ("(h2o.runif ext.hex 42)", None, 0), ("(kfold_column ext.hex 5 42)",
                                              None, 0),
        ("(modulo_kfold_column ext.hex 4)", None, 0),
        (f"(stratified_kfold_column {G} 3 7)", None, 0),
        (f"(h2o.random_stratified_split {G} 0.25 3)", None, 0),
        ("(h2o.splitframe ext.hex [0.3 0.3] 11)", None, 0),
    ],
    "strings": [
        ("(tolower str.hex)", None, 0), ("(toupper str.hex)", None, 0),
        ("(trim str.hex)", None, 0), ("(lstrip str.hex ' A')", None, 0),
        ("(rstrip str.hex ' ')", None, 0), ("(substring str.hex 1 4)", None, 0),
        ("(substring str.hex 2 NaN)", None, 0),
        ("(entropy str.hex)", None, 0), ("(countmatches str.hex ['an' 't'])",
                                         None, 0),
        ("(grep (cols str.hex [0]) 'an' 0 0 1)", None, 0),
        ("(grep (cols str.hex [1]) 'IT' 1 1 0)", None, 0),
        ("(strsplit (cols str.hex [0]) 'n')", None, 0),
        ("(tokenize (cols str.hex [1]) 't')", None, 0),
        ("(strDistance (cols str.hex [1]) (cols str.hex [0]) 'lev' 1)",
         None, 0),
        ("(strDistance (cols str.hex [1]) (cols str.hex [0]) 'jw' 1)",
         None, 0),
        ("(replacefirst str.hex 'a' 'A' 0)", None, 0),
        ("(replaceall str.hex 'an' '_' 1)", None, 0),
        ("(strlen str.hex)", None, 0), ("(nchar (cols ext.hex [4]))", None, 0),
        ("(tf-idf corpus.hex 0 1 1 0)", None, 0),
        (f"(== {S} 'Beta')", None, 0), (f"(!= {K} '3')", None, 0),
    ],
    "time": [
        (f"({p} {T})", None, 0) for p in
        ("year", "month", "day", "dayOfWeek", "week", "hour", "minute",
         "second", "millis")] + [
        ("(mktime 2020 2 14 14 30 45 0)", None, 0),
        ("(moment (cols dd.hex [0]) 0 1 2 3 4 5)", None, 0),
        ("(as.Date (cols str.hex [1]) 'yyyy-MM-dd')", None, 0),
        ("(getTimeZone)", None, 0), ("(setTimeZone 'UTC')", None, 0),
        ("(listTimeZones)", None, 0),
    ],
    "reshape": [
        ('(melt mp.hex [0] [1 2] "variable" "value" 0)', None, 0),
        ('(melt mp.hex [0] [] "var" "val" 1)', None, 0),
        ('(grouped_permute gp.hex 1 [0] 2 3)', None, 0),
        ('(ddply ext.hex [2] { x . (mean (cols_py x "b") True 0) })', 1e-5,
         1.0),
        ('(ddply ext.hex [5] { x . (nrow x) })', None, 0),
    ],
}

IMPURE = [",", "h2o.impute", "rename", "setproperty", "pivot", "ls", "rm",
          "tmp=", "assign", "model.reset.threshold",
          "segment_models_as_frame", "num_valid_substrings", "quantile",
          "median", "h2o.splitframe"]


def _run_family(both, fam):
    for expr, rtol, scale in FAMILIES[fam]:
        j, t = both.run(expr)
        assert_same(j, t, rtol=rtol, scale=scale, ctx=expr, zero_sign=False)


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_prim_family_matches_jax(both, fam):
    _run_family(both, fam)


def test_stateful_prims(both, tmp_path):
    """The prims that change state or read files: impute in place,
    rename a key, pivot a melted temp, splitframe's assigned parts, a
    property, the word-list substrings, ls."""
    from h2o3_tpu.core.dkv import DKV as JDKV

    install_both("imp.hex", {
        "a": (np.array([1.0, np.nan, 3.0, 3.0, np.nan]), None),
        "g": (np.array(["u", None, "v", "v", "u"], object), "enum")})
    for expr in ["(h2o.impute imp.hex 0 'median' 'interpolate' [] _ _)",
                 "(h2o.impute imp.hex 1 'mode' 'interpolate' [] _ _)"]:
        j, t = both.run(expr)
        assert_same(j, t, ctx=expr)
    assert_same(JDKV.get("imp.hex"), th.DKV.get("imp.hex"), ctx="imputed")
    both.run('(tmp= melted (melt mp.hex [0] [1 2] "variable" "value" 0))')
    j, t = both.run('(pivot melted "id" "variable" "value")')
    assert_same(j, t, ctx="pivot")
    j, t = both.run("(h2o.splitframe ext.hex [0.5] 3)")
    assert_same(j, t, ctx="split")
    assert_same(JDKV.get("ext.hex_split_1"), th.DKV.get("ext.hex_split_1"))
    install_both("ren.hex", {"v": (np.arange(3.0), None)})
    both.run("(rename 'ren.hex' 'ren2.hex')")
    assert th.DKV.get("ren.hex") is None and JDKV.get("ren.hex") is None
    assert th.DKV.get("ren2.hex").key == JDKV.get("ren2.hex").key == \
        "ren2.hex"
    assert both.run("(setproperty 'p.x' 'v1')") == ("v1", "v1")
    # the parser reads ',' as blank, so the sequence prim is called as is
    from h2o3_tpu.rapids.eval import PRIMS as JPRIMS

    from h2o3_tpu_torch.rapids.eval import PRIMS

    assert JPRIMS[","](None, 1.0, 2.0) == PRIMS[","](None, 1.0, 2.0) == 2.0
    words = tmp_path / "words.txt"
    words.write_text("an\nna\nban\n")
    j, t = both.run(f"(num_valid_substrings str.hex '{words}')")
    assert_same(j, t, ctx="substrings")
    j, t = both.run("(ls)")
    assert {"ext.hex", "ren2.hex"} <= set(t.col(0).values()) and \
        {"ext.hex", "ren2.hex"} <= set(j.col(0).values())


def test_model_reset_threshold(both):
    """model.reset.threshold reads a model from the DKV by key and
    returns its old threshold; a model-less key raises."""
    from h2o3_tpu.core.dkv import DKV as JDKV
    from h2o3_tpu.models.glm import GLM as JGLM

    from torch_port_support import train_cols

    jf, tf = install_both("thr.hex", train_cols(n=128, seed=5))
    jm = JGLM(family="binomial", lambda_=0.0).train(y="y", training_frame=jf)
    JDKV.put("thr_model", jm)
    th.GLM(family="binomial", lambda_=0.0, model_id="thr_model").train(
        y="y", training_frame=tf)
    j, t = both.run("(model.reset.threshold 'thr_model' 0.3)")
    assert_same(j, t, rtol=1e-4, scale=1.0)
    m = th.DKV.get("thr_model")
    assert m._output.training_metrics.auc_data.max_f1_threshold == 0.3
    from h2o3_tpu.rapids import exec_rapids as jexec

    for run, sess in ((jexec, both.j), (th.exec_rapids, both.t)):
        with pytest.raises(ValueError):
            run("(model.reset.threshold 'no_such_model' 0.3)", sess)


def test_segment_models_waits_for_segments(both):
    """The prim reads segment models from the DKV (the table itself is
    held to the reference in test_torch_ensemble.py); a key holding none
    raises in both packages."""
    from h2o3_tpu.rapids import exec_rapids as jexec

    for run, sess in ((jexec, both.j), (th.exec_rapids, both.t)):
        with pytest.raises(ValueError, match="not a SegmentModels key"):
            run("(segment_models_as_frame 'no_such_segments')", sess)


def test_statements_cover_every_prim(frames):
    """Every prim the port registers is named by a statement of this
    file or of test_torch_rapids.py (or is one of the stateful prims
    above), and the port registers exactly the reference's prims. A UDF
    registered in both packages (extensions.register_udf) runs as the
    prim `udf.<name>` in both, with the same result bit for bit."""
    import re
    from pathlib import Path

    from h2o3_tpu import extensions as jext
    from h2o3_tpu.rapids.eval import PRIMS as JPRIMS

    from h2o3_tpu_torch import extensions as text
    from h2o3_tpu_torch.rapids.eval import PRIMS
    from h2o3_tpu_torch.rapids.parser import parse as tparse

    def square_plus(a, c):
        return a * a + c

    try:
        jext.register_udf("cover_sq", square_plus)
        text.register_udf("cover_sq", square_plus)
        assert "cover_sq" in text.udfs()
        both = Both("udf")
        j, t = both.run("(udf.cover_sq (cols ext.hex ['a']) 3)")
        assert_same(j, t, ctx="udf.cover_sq")
        both.end()
    finally:
        # a UDF left in the reference's shared table breaks later tests
        # of the same worker
        JPRIMS.pop("udf.cover_sq", None)
        PRIMS.pop("udf.cover_sq", None)
    # either table may hold a `udf.` prim that another test of the same
    # worker registered (the reference's test_coverage_bc.py does)
    assert {k for k in PRIMS if not k.startswith("udf.")} == \
        {k for k in JPRIMS if not k.startswith("udf.")}
    here = Path(__file__).resolve()
    text = here.read_text() + (here.parent /
                               "test_torch_rapids.py").read_text()
    from test_torch_rapids import BIT_BINOPS, BIT_UNOPS, GAMMA_UNOPS, \
        TOL_UNOPS

    named = set(re.findall(r"\(([^\s()'\"\[\]{}]+)", text))
    named |= {st[0].name for fam in FAMILIES.values() for st in
              (tparse(e) for e, _, _ in fam)}
    named |= set(BIT_BINOPS + BIT_UNOPS + GAMMA_UNOPS + TOL_UNOPS + IMPURE)
    named |= {"cumsum", "cumprod", "cummin", "cummax"}
    missing = sorted(k for k in set(PRIMS) - named
                     if not k.startswith("udf."))
    assert not missing, missing
