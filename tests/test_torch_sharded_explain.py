"""Explanation on row-sharded frames (h2o3_tpu_torch/explain.py,
models/model.py's `partial_plot` and `predict_contributions`,
models/tree/shared_tree.py's `predict_leaf_node_assignment`,
models/tree/gbm.py's `staged_predict_proba`): ranks run as threads of
this process (`run_ranks`), R = 2, 3 and 4. The models: the JAX
package's bernoulli GBM of tests/test_torch_explain.py (4 trees, carried
across), and a DRF regression of 3 trees on its regression fixture and
a multinomial GBM that the port trains in one process; each rank
explains its own block of rows.

Bars: leaf assignment (`Path` codes and domains, `Node_ID`), staged
probabilities and contributions bit for bit one process's; partial
dependence (1-D, 2-D, weighted, ICE) of the bernoulli GBM: grids equal,
mean and stddev within 1e-6 of one process (the ranks' float64 sums
against numpy's float32 mean and std there) and of the JAX package; the
DRF regression's (means near 6.45) within ROADMAP C55's bar, 1e-6 of
the response's scale; contributions against the JAX package at
tests/test_torch_explain.py's bar (rtol 1e-5, atol 1e-7, BiasTerm bit
for bit). No row is gathered: each rank reads its own rows of a
result."""

import numpy as np
import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch.core import sharded_frame as SF
from h2o3_tpu_torch.core.frame import widen
from h2o3_tpu_torch.parallel import mesh as M

from test_torch_explain import PDP, _assert_tables, _reg_cols, _setup_cols
from test_torch_sharded import run_ranks
from torch_port_support import both_frames, carry_forest


@pytest.fixture(autouse=True)
def _port_cpu():
    th.init(device="cpu")


def _port_frame(cols):
    fr = th.Frame()
    for nm, (a, ct) in cols.items():
        fr.add(nm, th.Column.from_numpy(a, ctype=ct))
    return fr


def _multi_cols(n=384, seed=3):
    rng = np.random.default_rng(seed)
    x1, x2 = rng.standard_normal(n), rng.standard_normal(n)
    g = np.array(["a", "b", "c"], object)[rng.integers(0, 3, n)]
    u = 1.5 * x1 - x2 + 0.8 * (g == "a") + rng.logistic(size=n) * 0.5
    code = np.searchsorted([-1.0, 0.0, 1.0], u)
    y = np.array(["k0", "k1", "k2", "k3"], object)[code]
    return {"x1": (x1, None), "x2": (x2, None), "g": (g, "enum"),
            "y": (y, "enum")}


@pytest.fixture(scope="module")
def models(cl):
    """{name: (cols, JAX model or None, the port's model)}: the JAX
    package's bernoulli GBM carried across, and a DRF regression and a
    multinomial GBM the port trains in one process."""
    from h2o3_tpu.models.tree.gbm import GBM

    from h2o3_tpu_torch import convert

    th.init(device="cpu")
    out = {}
    cols = _setup_cols()
    jf, _tf = both_frames(cols)
    jm = GBM(ntrees=4, max_depth=3, seed=1).train(
        x=["x1", "x2", "g"], y="y", training_frame=jf)
    out["gbm"] = (cols, jm, convert.gbm_model_from_numpy(carry_forest(jm)))
    rcols = _reg_cols()
    out["drf"] = (rcols, None, th.DRF(
        ntrees=3, max_depth=4, seed=2, sample_rate=1.0, mtries=3).train(
        y="y", training_frame=_port_frame(rcols)))
    mcols = _multi_cols()
    tm = th.GBM(ntrees=3, max_depth=3, seed=1).train(
        y="y", training_frame=_port_frame(mcols))
    out["multinomial"] = (mcols, None, tm)
    return out


def _local(fr):
    """{column: (domain, this process's rows)} of a result frame, read
    from the rank's own block (no gather)."""
    return {n: (fr.col(n).domain, widen(fr.col(n).data).cpu().numpy())
            for n in fr.names}


def _on_ranks(R, cols, fn):
    """fn(model frame) on R ranks, each on its block of `cols`' rows;
    -> [(rank's (lo, hi), fn's result)], asserting no rank gathered."""
    before = SF.counters()["gathered_rows"]

    def rank(r, m):
        fr = _port_frame(cols)
        assert fr.shard == m.rows(fr.nrows)
        return fr.shard, fn(fr)

    outs = run_ranks(R, rank)
    assert SF.counters()["gathered_rows"] == before
    return outs


def _assert_blocks(one, outs):
    for (lo, hi), got in outs:
        assert list(got) == list(one)
        for n, (dom, arr) in one.items():
            gdom, garr = got[n]
            assert gdom == dom, n
            want = arr[lo:hi]
            assert garr.dtype == want.dtype and np.array_equal(
                garr.view(np.uint8), want.view(np.uint8)), n


LEAF_MODELS = ("gbm", "drf", "multinomial")


@pytest.mark.parametrize("R", [2, 3, 4])
@pytest.mark.parametrize("which", LEAF_MODELS)
def test_leaf_assignment_is_one_process(models, which, R):
    cols, _jm, tm = models[which]
    for kind in ("Path", "Node_ID"):
        one = _local(tm.predict_leaf_node_assignment(_port_frame(cols),
                                                     type=kind))
        outs = _on_ranks(R, cols, lambda fr: _local(
            tm.predict_leaf_node_assignment(fr, type=kind)))
        _assert_blocks(one, outs)
    if which == "multinomial":
        assert list(one)[:3] == ["T1.C1", "T1.C2", "T1.C3"]


def test_leaf_path_domain_holds_leaves_only_other_ranks_reached(models):
    """A leaf that no row of this rank reaches is still in the domain:
    the domains are the cloud's (one all-reduce), as one process's."""
    cols, _jm, tm = models["gbm"]
    order = np.argsort(cols["x1"][0], kind="stable")
    cols = {k: (a[order], ct) for k, (a, ct) in cols.items()}
    one = tm.predict_leaf_node_assignment(_port_frame(cols))
    outs = _on_ranks(4, cols, lambda fr: (
        tm.predict_leaf_node_assignment(fr)))
    doms = [one.col(n).domain for n in one.names]
    for (lo, hi), got in outs:
        assert [got.col(n).domain for n in got.names] == doms
        assert got.shard == (lo, hi) and got.nrows == one.nrows
    assert any(len(np.unique(widen(got.col(n).data).numpy())) < len(d)
               for _sh, got in outs for n, d in zip(got.names, doms))


@pytest.mark.parametrize("R", [2, 3, 4])
@pytest.mark.parametrize("which", ["gbm", "multinomial"])
def test_staged_probabilities_are_one_process(models, which, R):
    cols, _jm, tm = models[which]
    one = _local(tm.staged_predict_proba(_port_frame(cols)))
    _assert_blocks(one, _on_ranks(
        R, cols, lambda fr: _local(tm.staged_predict_proba(fr))))


@pytest.mark.parametrize("R", [2, 3, 4])
@pytest.mark.parametrize("which", ["gbm", "drf"])
def test_contributions_are_one_process(models, which, R):
    cols, _jm, tm = models[which]
    one = _local(tm.predict_contributions(_port_frame(cols)))
    _assert_blocks(one, _on_ranks(
        R, cols, lambda fr: _local(tm.predict_contributions(fr))))


def test_contributions_against_the_jax_package(models):
    cols, jm, tm = models["gbm"]
    jf, _tf = both_frames(cols)
    want = jm.predict_contributions(jf)
    n = len(next(iter(cols.values()))[0])
    a = np.stack([np.asarray(want.col(c).to_numpy())[:n]
                  for c in want.names], 1)
    for (lo, hi), got in _on_ranks(3, cols, lambda fr: _local(
            tm.predict_contributions(fr))):
        assert list(got) == list(want.names)
        b = np.stack([got[c][1] for c in got], 1)
        assert np.array_equal(np.ascontiguousarray(b[:, -1]).view(np.uint64),
                              np.ascontiguousarray(a[lo:hi, -1]).view(
                                  np.uint64))
        np.testing.assert_allclose(b, a[lo:hi], rtol=1e-5, atol=1e-7)


# row 700 of 832 lies in the last rank's block for R = 2, 3 and 4
PDP_ONE = dict(PDP, ice_late_row=dict(cols=["x1", "g"], nbins=5,
                                      row_index=700))


@pytest.mark.parametrize("R", [2, 3, 4])
@pytest.mark.parametrize("case", sorted(PDP_ONE))
def test_partial_dependence_is_one_process(models, case, R):
    cols, _jm, tm = models["gbm"]
    kw = PDP_ONE[case]
    one = tm.partial_plot(_port_frame(cols), **kw)
    for _sh, got in _on_ranks(R, cols, lambda fr: tm.partial_plot(fr,
                                                                  **kw)):
        _assert_tables(one, got, case)
        if "row_index" in kw:
            assert all(s == 0.0 for t in got for s in t["stddev_response"])


@pytest.mark.parametrize("case", sorted(PDP))
def test_partial_dependence_against_the_jax_package(models, case):
    cols, jm, tm = models["gbm"]
    jf, _tf = both_frames(cols)
    want = jm.partial_plot(jf, **PDP[case])
    for _sh, got in _on_ranks(2, cols, lambda fr: tm.partial_plot(
            fr, **PDP[case])):
        _assert_tables(want, got, case)


def _assert_tables_c55(want, got):
    """ROADMAP C55: grids equal, mean and stddev within 1e-6 of the
    response's scale (max(1, the largest |mean|)): one process takes
    numpy's float32 mean and std, whose rounding grows with the
    response, the ranks float64 sums."""
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert list(a["values"]) == list(b["values"])
        scale = max(1.0, float(np.max(np.abs(a["mean_response"]))))
        for k in ("mean_response", "stddev_response"):
            np.testing.assert_allclose(b[k], a[k], rtol=0,
                                       atol=1e-6 * scale, err_msg=k)


def test_regression_partial_dependence_across_ranks(models):
    """The DRF regression's PDP (every column, `explain.partial_dependence`
    directly), its means near 6.45, against one process's within C55's
    bar."""
    from h2o3_tpu_torch import explain

    cols, _jm, tm = models["drf"]
    one = explain.partial_dependence(tm, _port_frame(cols), nbins=5)
    for _sh, got in _on_ranks(3, cols, lambda fr: (
            explain.partial_dependence(tm, fr, nbins=5))):
        _assert_tables_c55(one, got)


def test_grid_of_a_column_without_finite_values_is_empty_on_every_rank():
    from h2o3_tpu_torch import explain

    v = np.full(96, np.nan)
    v[5] = 2.5              # on rank 0 only

    def rank(r, m):
        return (explain._grid_for(th.Column.from_numpy(np.full(96, np.nan)),
                                  8),
                explain._grid_for(th.Column.from_numpy(v), 8))

    assert run_ranks(3, rank) == [([], [2.5])] * 3
    with M.alone():
        assert explain._grid_for(th.Column.from_numpy(v), 8) == [2.5]
