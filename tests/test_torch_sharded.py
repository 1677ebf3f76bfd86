"""The row-sharded data plane of the port (h2o3_tpu_torch/parallel/mesh.py,
core/{sharded_frame,mrtask,dkv}.py, the cross-rank histogram): ranks run
as threads of this process over one ``torch.distributed.HashStore``,
each with its own gloo group, on the CPU. Held against one process of
the port bit for bit where the math is order-free (histograms, trees,
edges, counts) and against the JAX package (its Pallas histogram's XLA
twin, its 8-device `map_reduce`, `shard_geometry`, its metrics merge)
at the reference's tolerances."""

import base64
import json
import pickle
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

import h2o3_tpu_torch as th
from h2o3_tpu_torch.core import sharded_frame
from h2o3_tpu_torch.core.frame import Column, Frame
from h2o3_tpu_torch.models.tree import hist_gather as hg
from h2o3_tpu_torch.parallel import mesh as M

from test_pallas_hist import _case


@pytest.fixture(autouse=True)
def _port_cpu():
    th.init(device="cpu")


def run_ranks(R, fn, timeout_s=30.0):
    """fn(rank, mesh) on R threads, each with its own mesh over one
    HashStore and current for the thread; their results in rank order."""
    store = dist.HashStore()
    out, errs = [None] * R, []

    def run(r):
        m = M.RowMesh(r, R, "cpu", store, timeout_s=timeout_s)
        try:
            with M.use(m):
                out[r] = fn(r, m)
        except BaseException as e:   # noqa: BLE001 — re-raised below
            errs.append(e)

    ths = [threading.Thread(target=run, args=(r,)) for r in range(R)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout_s * 4)
    assert not any(t.is_alive() for t in ths), "a rank hung"
    if errs:
        raise errs[0]
    return out


def _hist_case(kind):
    binned, node, w, y, offsets, TB = _case(3, 640, 4, 8, 6,
                                            ragged_bins=True)
    if kind == "nan":
        y = y.copy()
        y[17] = np.nan
    return binned.astype(np.uint8), node, w, y, offsets, TB


def _blocks(R, n, kind):
    """Rank row blocks; "empty" gives the last rank no rows."""
    if kind != "empty":
        return [M.row_block(n, r, R) for r in range(R)]
    cuts = np.linspace(0, n, R).astype(int).tolist() + [n]
    return [(cuts[r], cuts[r + 1]) for r in range(R)]


@pytest.mark.parametrize("R", [1, 2, 3])
@pytest.mark.parametrize("kind", ["plain", "empty", "nan"])
def test_cross_rank_hist_ref_is_bitwise_the_one_call_version(R, kind):
    binned, node, w, y, offsets, TB = _hist_case(kind)
    S, n = 6, len(node)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    one = hg.hist_gather_ref(t(binned), t(node), t(w), t(y),
                             offsets=offsets, TB=TB, S=S)
    blocks = _blocks(R, n, kind)

    def rank(r, m):
        lo, hi = blocks[r]
        return hg.hist_gather(t(binned[lo:hi]), t(node[lo:hi]),
                              t(w[lo:hi]), t(y[lo:hi]), offsets=offsets,
                              TB=TB, S=S, mesh=m, n_global=n)

    for got in run_ranks(R, rank):
        assert torch.equal(got.view(torch.int32), one.view(torch.int32))
    if kind == "nan":
        assert torch.isnan(one[:, 1]).all() and torch.isfinite(one[:, 0]).all()


def test_cross_rank_hist_against_the_jax_xla_twin(cl):
    import jax.numpy as jnp

    from h2o3_tpu.models.tree import pallas_hist

    binned, node, w, y, offsets, TB = _hist_case("plain")
    S, n = 6, len(node)
    twin = np.asarray(pallas_hist.hist_gather_xla(
        *(jnp.asarray(a) for a in (binned, node, w, y)), offsets=offsets,
        TB=TB, S=S))
    t = lambda a: torch.as_tensor(a)  # noqa: E731

    def rank(r, m):
        lo, hi = m.rows(n)
        return hg.hist_gather(t(binned[lo:hi]), t(node[lo:hi]),
                              t(w[lo:hi]), t(y[lo:hi]), offsets=offsets,
                              TB=TB, S=S, mesh=m).numpy()

    # the reference holds its own lowerings to 1e-6 (test_pallas_hist.py)
    np.testing.assert_allclose(run_ranks(2, rank)[0], twin, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("R", [1, 2, 3])
def test_map_reduce_matches_the_jax_package(cl, R):
    import jax.numpy as jnp

    from h2o3_tpu.core import mrtask as jmr
    from h2o3_tpu.core.frame import Column as JColumn

    from h2o3_tpu_torch.core import mrtask

    v = np.arange(1000, dtype=np.float64) * 0.25
    want = float(jmr.map_reduce(lambda x: jnp.nansum(x),
                                [JColumn.from_numpy(v)]))

    def rank(r, m):
        c = Column.from_numpy(v)
        assert c.shard == m.rows(len(v))
        return float(mrtask.map_reduce(
            lambda x: torch.nansum(x.double()).reshape(1), [c])[0])

    assert run_ranks(R, rank) == [want] * R == [v.sum()] * R


@pytest.mark.parametrize("n", [64, 100, 1003])
def test_shard_geometry_matches_the_reference(cl, n):
    from h2o3_tpu.core import sharded_frame as jsf

    R = int(cl.row_shards)
    old = cl.args.row_align
    cl.args.row_align = 1           # the port pads nothing
    try:
        ref_rows, ref_idx = jsf.shard_geometry(cl, cl.pad_rows(n))
    finally:
        cl.args.row_align = old
    got = run_ranks(R, lambda r, m: sharded_frame.shard_geometry(n))
    assert {g[0] for g in got} == {ref_rows}
    assert set().union(*(g[1] for g in got)) == ref_idx
    blocks = [M.row_block(n, r, R) for r in range(R)]
    assert blocks == [(min(i * ref_rows, n), min((i + 1) * ref_rows, n))
                      for i in range(R)]


@pytest.mark.parametrize("R", [2, 3])
def test_rollups_across_ranks_are_the_clouds(R):
    rng = np.random.default_rng(2)
    v = rng.standard_normal(999).astype(np.float32)
    v[::37] = np.nan
    one = Column.from_numpy(v).rollups

    def rank(r, m):
        return Column.from_numpy(v).rollups

    for got in run_ranks(R, rank):
        assert (got.min, got.max, got.na_count, got.nz_count, got.rows) == \
            (one.min, one.max, one.na_count, one.nz_count, one.rows)
        assert got.mean == pytest.approx(one.mean, rel=1e-6, abs=1e-7)
        assert got.sigma == pytest.approx(one.sigma, rel=1e-6)


def test_columns_keep_their_rows_and_gather_on_to_numpy():
    vals = np.array(["b", "a", None, "c", "a", "b", "c"], dtype=object)
    x = np.arange(7, dtype=np.float32)
    sharded_frame.reset_counters()

    def rank(r, m):
        fr = Frame()
        fr.add("x", Column.from_numpy(x))
        fr.add("g", Column.from_numpy(vals, ctype="enum"))
        assert fr.nrows == 7 and fr.shard == m.rows(7)
        assert fr.local_rows == len(fr.col("x").data)
        return (fr.col("g").domain, fr.col("x").to_numpy(),
                fr.col("g").values())

    got = run_ranks(3, rank)
    for dom, xs, gs in got:
        assert dom == ["a", "b", "c"]
        assert np.array_equal(xs, x)
        assert list(gs) == list(vals)
    assert sharded_frame.counters()["gathered_rows"] == 3 * 2 * 7


def _train_frame(n=640, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    X[::29, 2] = np.nan
    logit = 2.0 * X[:, 0] - X[:, 1]
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-logit)), "Y", "N")
    g = np.array(["u", "v", "w"])[rng.integers(0, 3, n)]

    def make():
        fr = Frame.from_numpy(X, names=["a", "b", "c", "d"])
        fr.add("g", Column.from_numpy(g, ctype="enum"))
        fr.add("y", Column.from_numpy(y, ctype="enum"))
        return fr
    return make


def _forest(m):
    fo = m.forest
    return {k: np.asarray(getattr(fo, k)).copy()
            for k in ("feat", "thresh_bin", "na_left", "left", "right",
                      "leaf_val")}


@pytest.mark.parametrize("algo", ["gbm", "gbm_sampled", "drf"])
def test_trees_across_thread_ranks_are_the_one_process_forest(algo):
    make = _train_frame()

    def train():
        if algo == "drf":
            return th.DRF(ntrees=3, max_depth=4, seed=3).train(
                y="y", training_frame=make())
        return th.GBM(ntrees=4, max_depth=3, seed=1,
                      sample_rate=0.7 if algo == "gbm_sampled" else 1.0
                      ).train(y="y", training_frame=make())

    one = train()
    want = _forest(one)
    for m in run_ranks(3, lambda r, mesh: train()):
        got = _forest(m)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        assert m._output.training_metrics.auc == \
            one._output.training_metrics.auc


def test_glm_across_thread_ranks_within_the_c10_bar():
    make = _train_frame(seed=4)
    one = th.GLM(family="binomial", lambda_=0.0).train(
        y="y", training_frame=make())
    for m in run_ranks(2, lambda r, mesh: th.GLM(
            family="binomial", lambda_=0.0).train(y="y",
                                                  training_frame=make())):
        np.testing.assert_allclose(m.beta.numpy(), one.beta.numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert m.iterations == one.iterations


def test_fixed_point_sums_do_not_depend_on_the_split():
    from h2o3_tpu_torch.core.ops import fixed_point_group_sums

    rng = np.random.default_rng(9)
    v = torch.as_tensor(rng.standard_normal((500, 2)) * 1e3)
    idx = torch.as_tensor(rng.integers(0, 7, 500))
    one = fixed_point_group_sums(idx, v, 7)

    def rank(r, m):
        lo, hi = m.rows(500)
        return fixed_point_group_sums(idx[lo:hi], v[lo:hi], 7, m)

    for got in run_ranks(3, rank):
        assert torch.equal(got, one)
    np.testing.assert_allclose(one.numpy(), np.stack(
        [np.bincount(idx.numpy(), v[:, c].numpy(), 7) for c in range(2)],
        1), rtol=1e-9)


@pytest.mark.parametrize("size", [1, 3, 64])
def test_fixed_point_group_sums_are_each_groups_own_sum(size):
    """A group's sum does not depend on the other groups: one group is
    reduced densely, a few groups are spread over copies of them (here
    100,000 rows), and each group equals its rows summed alone."""
    from h2o3_tpu_torch.core.ops import (fixed_point_group_sums,
                                         fixed_point_sums)

    rng = np.random.default_rng(size)
    n = 100_000
    v = torch.as_tensor((rng.standard_normal((n, 2))
                         * 10.0 ** rng.integers(-4, 4, (n, 2))
                         ).astype(np.float32))
    v[7, 1] = float("inf")
    idx = torch.as_tensor(rng.integers(0, size, n))
    got = fixed_point_group_sums(idx, v, size)
    for g in range(size):
        want = fixed_point_sums(v[idx == g])
        assert torch.equal(got[g], want), g


def test_out_of_scope_work_refuses_a_sharded_frame():
    """What the row exchange does not serve yet (ROADMAP A14.6c part 4)
    refuses a row-sharded frame, naming that item: a PCA train (the
    Rapids prims, melt among them, all run there now), the isolation
    forests and the other builders, and the DeepLearning autoencoder."""

    def rank(r, m):
        fr = _train_frame(n=64)()
        with pytest.raises(NotImplementedError, match="A14.6c"):
            th.PCA(k=1).train(training_frame=fr)
        with pytest.raises(NotImplementedError, match="A14.6c"):
            th.IsolationForest(ntrees=2).train(training_frame=fr)
        with pytest.raises(NotImplementedError, match="A14.6c"):
            th.KMeans(k=2).train(training_frame=fr)
        with pytest.raises(NotImplementedError, match="A14.6c"):
            th.DeepLearning(epochs=1, autoencoder=True).train(
                training_frame=fr)
        return True

    assert run_ranks(2, rank) == [True, True]


def test_a_missing_peer_ends_the_collective_not_a_hang():
    from h2o3_tpu_torch.core.failure import CloudUnhealthyError

    store = dist.HashStore()
    m = M.RowMesh(0, 2, "cpu", store, timeout_s=1.0)
    with pytest.raises(CloudUnhealthyError, match="rank 0/2"):
        m.all_reduce(torch.ones(1))
    # the failed generation is retired: the next group is generation 1
    assert store.get("h2o3/mesh/generation") == b"1"


# -- the DKV's cross-process half (memory KV) ---------------------------------

@pytest.fixture()
def kv():
    from h2o3_tpu_torch.parallel import distributed as D

    with D.memory_kv() as store:
        yield store


def test_publish_fetch_remote_and_global_keys(kv):
    from h2o3_tpu_torch.core.dkv import DKV

    cfg = {"alpha": 0.5, "origin": 0}
    DKV.put("shared_cfg", cfg)
    assert DKV.publish("shared_cfg", cfg, replicate=True)
    assert DKV.publish("announced_only")
    DKV.remove("shared_cfg")
    assert "shared_cfg" in DKV.global_keys()
    assert "announced_only" in DKV.global_keys()
    got = DKV.fetch_remote("shared_cfg", timeout_ms=100)
    assert got == cfg and DKV.get("shared_cfg") == cfg   # cached locally
    assert DKV.fetch_remote("announced_only", timeout_ms=10) is None
    DKV.remove("shared_cfg")


def test_publish_checks_the_cap_before_the_meta_key(kv):
    from h2o3_tpu_torch.core.dkv import DKV

    big = np.zeros(9 * 1024 * 1024, np.uint8)
    with pytest.raises(ValueError, match="too large"):
        DKV.publish("too_big", big, replicate=True)
    assert not any(k.endswith("too_big") for k in kv)


def test_fetch_remote_refuses_a_malicious_blob(kv):
    import os

    from h2o3_tpu_torch.core.dkv import DKV

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    kv[DKV._META_PREFIX + "evil"] = json.dumps({"replicated": True})
    kv[DKV._BLOB_PREFIX + "evil"] = base64.b64encode(
        pickle.dumps(Evil())).decode()
    with pytest.raises(pickle.UnpicklingError):
        DKV.fetch_remote("evil", timeout_ms=10)
    assert DKV.get("evil") is None


def test_snapshot_carries_the_kv_and_restores_it_put_if_absent(kv):
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.parallel import distributed as D

    DKV.publish("snap_cfg", {"v": 1}, replicate=True)
    snap = DKV.snapshot_control_plane()
    assert set(snap["kv"]) == {DKV._META_PREFIX + "snap_cfg",
                               DKV._BLOB_PREFIX + "snap_cfg"}
    with D.memory_kv({DKV._META_PREFIX + "snap_cfg": "newer"}) as fresh:
        DKV.restore_control_plane({"objects": {}, "kv": snap["kv"]})
        assert fresh[DKV._META_PREFIX + "snap_cfg"] == "newer"   # kept
        assert fresh[DKV._BLOB_PREFIX + "snap_cfg"] == \
            snap["kv"][DKV._BLOB_PREFIX + "snap_cfg"]


def test_metrics_merge_the_clouds_series_as_the_reference(kv):
    from h2o3_tpu.obs import metrics as jm

    from h2o3_tpu_torch.obs import metrics as pm

    pm.inc("h2o3_oplog_ops_replayed_total", 3)
    mine = pm.REGISTRY.snapshot()
    other = json.loads(json.dumps(mine))
    for m in other:
        for s in m["samples"]:
            if "value" in s:
                s["value"] = float(s["value"]) + 2.0
            if "count" in s:
                s["count"] = int(s["count"]) + 1
    kv["obs/metrics/1"] = json.dumps({"proc": 1, "ts": 0, "metrics": other})
    got = pm.cluster_aggregate()
    want = jm.aggregate([{"proc": 0, "metrics": pm.REGISTRY.snapshot()},
                         {"proc": 1, "metrics": other}])
    by = {m["name"]: m for m in got}
    for w in want:
        g = by[w["name"]]
        assert g["type"] == w["type"]
        key = lambda s: tuple(sorted(s["labels"].items()))  # noqa: E731
        gs = {key(s): s for s in g["samples"]}
        for s in w["samples"]:
            t = gs[key(s)]
            for f in ("value", "sum", "count", "bucket_counts"):
                if f in s and w["type"] == "counter":
                    assert t[f] == pytest.approx(s[f])
    ops = by["h2o3_oplog_ops_replayed_total"]["samples"][0]["value"]
    mine_ops = [s["value"] for m in mine
                if m["name"] == "h2o3_oplog_ops_replayed_total"
                for s in m["samples"]][0]
    assert ops == pytest.approx(2 * mine_ops + 2.0)


def test_map_reduce_fault_point():
    from h2o3_tpu_torch.core import failure, mrtask

    c = Column.from_numpy(np.ones(8, np.float32))
    with failure.inject("mrtask.map_reduce"):
        with pytest.raises(failure.InjectedFault):
            mrtask.map_reduce(lambda x: x.sum().reshape(1), [c])
    assert mrtask.map_reduce(lambda x: x.sum().reshape(1), [c]).tolist() \
        == [8.0]


def test_runtime_merges_the_clouds_compile_families(kv):
    from h2o3_tpu.obs import compiles as jc

    from h2o3_tpu_torch.obs import compiles as pc

    other = {"proc": 1, "ts": 0.0, "phase_report": {},
             "compiles": {"families": {"tree": {
                 "compiles": 2, "hits_memory": 5, "hits_disk": 0,
                 "ms_total": 12.5, "ms_max": 9.0}},
                 "slowest": [], "rows_recorded": 2}}
    kv["obs/runtime/1"] = json.dumps(other)
    snaps = pc.cluster_runtime()
    assert [s["proc"] for s in snaps] == [0, 1]
    tables = [s["compiles"]["families"] for s in snaps]
    assert pc.merge_family_tables(tables) == jc.merge_family_tables(tables)
    assert pc.merge_family_tables(tables)["tree"]["hits_memory"] >= 5
    assert pc.publish_runtime() and "obs/runtime/0" in kv


def test_pack_features_packs_a_ranks_rows_and_counts_them():
    make = _train_frame(n=64)
    names = ["a", "b", "c", "d", "g"]
    one = sharded_frame.ShardedFrame.of(make(), names).pack_features(
        0, 64, 64)

    def rank(r, m):
        sf = sharded_frame.ShardedFrame.of(make(), names)
        lo, hi = m.rows(64)
        before = sharded_frame.counters()["packed_rows"]
        got = sf.pack_features(0, hi - lo, 48)
        assert sharded_frame.counters()["packed_rows"] >= before + hi - lo
        return lo, hi, got

    for lo, hi, got in run_ranks(2, rank):
        assert got.shape == (48, 5)
        assert torch.equal(got[: hi - lo].view(torch.int32),
                           one[lo:hi].view(torch.int32))
        assert not got[hi - lo:].any()


def test_checkpoint_rank_section_restores_a_ranks_own_rows(kv, tmp_path,
                                                           monkeypatch):
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.parallel import ckpt
    from h2o3_tpu_torch.parallel import distributed as D

    monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
    monkeypatch.setattr(D, "_PROC", 1)
    monkeypatch.setattr(D, "_NPROC", 2)
    x = np.arange(10, dtype=np.float32)
    m = M.RowMesh(1, 2, "cpu", dist.HashStore())
    with M.use(m):
        fr = Frame(key="sect.hex")
        fr.add("x", Column.from_numpy(x))
        fr.install()
        assert ckpt.write_rank_section(7) is not None
        snap = DKV.snapshot_control_plane()
        assert snap["sharded"] == ["sect.hex"]
        # the writer of the main snapshot was rank 0: its rows are not
        # this rank's, so its section's replace them
        DKV.remove("sect.hex")
        ckpt._restore_rank_section(7, {"rank": 0, "dkv": snap})
    got = DKV.get("sect.hex")
    assert got.shard == (5, 10)
    assert np.array_equal(got.col("x").data.numpy(), x[5:])
    DKV.remove("sect.hex")
