"""Frame rows sharded across two real gloo processes on the CPU: the port's
counterpart of the JAX package's two-process tier (tests/mp_worker.py).

1. Two ranks of tests/torch_mp_support.py (one process pair) hold their
   rows of the same frames and run the same trains: each rank holds its
   block, the column mean is the cloud's; the binomial GLM is the one-
   process port's (within 1e-6, ROADMAP C46) and the JAX package's
   within the C10 bar; the GBM (validation, early stopping) and the
   sampled DRF are bitwise the one-process port's forests, the GBM's
   predictions within 1e-5 of the JAX package's (C2); an imported CSV
   lands each rank's rows and gathers to the one-process import; a
   replicated DKV object is fetched across processes and listed.
   The JAX package's second tier (tests/mp_worker2.py) on the same
   pair: the sample sort, a join with a lookup frame and a group-by are
   one process's bit for bit (no row gathered), the sorted key the JAX
   package's, and DeepLearning's synchronous weights one process's.
2. This process coordinates a two-process cloud over REST (the second
   process pair, a follower of tests/torch_cloud_support.py): a parse,
   train and predict replay with the follower's collectives mirrored;
   the follower, killed after the train, rejoins from the train's own
   checkpoint with its rows and the forest; then it is killed mid-train
   and the coordinator's collective ends in CloudUnhealthyError within
   the mesh's timeout.
3. Munging and AutoML over REST on a sharded cloud: a parse, Rapids
   sort, merge and group-by statements and an AutoML build replay on
   the follower, which holds the same keys and its blocks of rows.
4. ROADMAP C47's window: a follower killed after an op's last
   collective but before its rank section and ack (a train, then a sort
   statement) rejoins through a joint replay of that op and holds the
   coordinator's objects and its own rows; an op that replaced one of
   its own inputs is refused that replay, and the rejoin fails.
"""

import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from test_torch_cloud_mp import _Cloud, _digests, _until
from torch_cloud_support import forest_digest
from torch_mp_support import GBM_PARAMS
from torch_rest_support import Rest, write_api_csv

pytestmark = pytest.mark.chaos

ROOT = Path(__file__).resolve().parent.parent
DEADLINE_S = 90.0
MESH_TIMEOUT_S = "10"
FOREST = ("feat", "thresh_bin", "na_left", "left", "right", "leaf_val")


def _data(n=640, nv=256):
    rng = np.random.default_rng(7)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-(2.0 * X[:, 0] - X[:, 1]))),
                 "Y", "N")
    vr = np.random.default_rng(11)
    Xv = vr.standard_normal((nv, 4)).astype(np.float32)
    yv = np.where(vr.random(nv) < 1 / (1 + np.exp(-(2.0 * Xv[:, 0]
                                                     - Xv[:, 1]))), "Y", "N")
    return X, y, Xv, yv


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """Both ranks' outputs of tests/torch_mp_support.py: one process pair
    for the whole session, whichever xdist worker gets there first (the
    others wait on its lock and read its files)."""
    import fcntl

    shared = tmp_path_factory.getbasetemp().parent / "torch_sharded_mp"
    shared.mkdir(exist_ok=True)
    with open(shared / "lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not (shared / "rank.1.json").exists():
                _run_pair(shared)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    ranks = []
    for pid in (0, 1):
        with open(shared / f"rank.{pid}.json") as f:
            info = json.load(f)
        ranks.append((info, dict(np.load(shared / f"rank.{pid}.npz",
                                         allow_pickle=False))))
    return {"ranks": ranks, "data": _data(), "csv": str(shared / "data.csv")}


def _run_pair(out):
    import torch.distributed as dist

    X, y, Xv, yv = _data()
    np.savez(out / "data.npz", X=X, y=y.astype("U1"), Xv=Xv,
             yv=yv.astype("U1"))
    rng = np.random.default_rng(5)
    with open(out / "data.csv", "w") as f:
        f.write("g,x,z\n")
        for i in range(333):
            f.write(f"{'abc'[rng.integers(3)]},{rng.normal():.5f},"
                    f"{i}\n")
    store = dist.TCPStore("127.0.0.1", 0, 2, True,
                          timeout=datetime.timedelta(seconds=60),
                          wait_for_workers=False)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "tests")]), TORCH_CPP_LOG_LEVEL="ERROR",
        H2O_TPU_MESH_TIMEOUT_S="60")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mp_support.py"),
         str(store.port), str(pid), str(out)], env=env,
        stdout=open(out / f"rank{pid}.log", "w"), stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    try:
        for p in procs:
            p.wait(DEADLINE_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = {pid: (out / f"rank{pid}.log").read_text()[-3000:]
            for pid in (0, 1)}
    assert all(p.returncode == 0 for p in procs), logs


def _one_process_frames():
    from h2o3_tpu_torch.core.frame import Column, Frame

    def frame(X, y):
        fr = Frame.from_numpy(X, names=["a", "b", "c", "d"])
        fr.add("y", Column.from_numpy(y.astype(object), ctype="enum"))
        return fr
    return frame


def test_ranks_hold_their_rows_and_the_clouds_mean(spmd):
    X = spmd["data"][0]
    got = [info for info, _a in spmd["ranks"]]
    assert [g["shard"] for g in got] == [[0, 320], [320, 640]]
    assert [g["backend"] for g in got] == ["gloo", "gloo"]
    for (info, arr), (lo, hi) in zip(spmd["ranks"], [(0, 320), (320, 640)]):
        assert np.array_equal(arr["a_shard"], X[lo:hi, 0])
        assert info["mean_a"] == pytest.approx(float(X[:, 0].mean()),
                                               rel=1e-6, abs=1e-7)
        assert info["gathered_in_train"] == 0


def test_glm_coefficients_against_one_process_and_the_jax_package(cl,
                                                                  spmd):
    import h2o3_tpu_torch as th
    from h2o3_tpu.core.frame import Column as JColumn, Frame as JFrame
    from h2o3_tpu.models.glm import GLM as JGLM

    X, y, _Xv, _yv = spmd["data"]
    th.init(device="cpu")
    one = th.GLM(family="binomial", lambda_=0.0, seed=1).train(
        y="y", training_frame=_one_process_frames()(X, y))
    jfr = JFrame.from_numpy(X.astype(np.float64), names=["a", "b", "c", "d"])
    jfr.add("y", JColumn.from_numpy(y.astype(object), ctype="enum"))
    jm = JGLM(family="binomial", lambda_=0.0, seed=1).train(
        y="y", training_frame=jfr)
    jbeta = np.asarray(jm.beta, np.float64).ravel()
    for info, arr in spmd["ranks"]:
        beta = arr["glm_beta"]
        np.testing.assert_allclose(beta, one.beta.numpy(), rtol=1e-6,
                                   atol=1e-6)            # ROADMAP C46
        np.testing.assert_allclose(beta, jbeta, rtol=1e-4, atol=1e-4)
        assert info["glm_iterations"] == one.iterations


def test_gbm_with_early_stopping_is_bitwise_one_process(cl, spmd):
    import h2o3_tpu_torch as th
    from h2o3_tpu.core.frame import Column as JColumn, Frame as JFrame
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    X, y, Xv, yv = spmd["data"]
    th.init(device="cpu")
    make = _one_process_frames()
    one = th.GBM(**GBM_PARAMS).train(
        y="y", training_frame=make(X, y), validation_frame=make(Xv, yv))
    history = one._output.scoring_history
    # early stopping fired, at the same tree as in one process
    assert history[-1]["tree"] < GBM_PARAMS["ntrees"]
    for info, arr in spmd["ranks"]:
        for k in FOREST:
            assert np.array_equal(arr[f"gbm_{k}"],
                                  np.asarray(getattr(one.forest, k))), k
        assert info["gbm_auc"] == one._output.training_metrics.auc
        assert info["gbm_valid_auc"] == one._output.validation_metrics.auc
        assert info["gbm_history"] == history
        assert all("validation_deviance" in h for h in history)

    def jframe(X_, y_):
        f = JFrame.from_numpy(X_.astype(np.float64),
                              names=["a", "b", "c", "d"])
        f.add("y", JColumn.from_numpy(y_.astype(object), ctype="enum"))
        return f
    jm = JGBM(**GBM_PARAMS).train(
        y="y", training_frame=jframe(X, y), validation_frame=jframe(Xv, yv))
    assert jm._output.scoring_history[-1]["tree"] == history[-1]["tree"]
    jp = np.asarray(jm.predict(jframe(X, y)).col("Y").to_numpy(),
                    np.float64)[: len(X)]
    for _info, arr in spmd["ranks"]:
        np.testing.assert_allclose(arr["gbm_pred"], jp, atol=1e-5)   # C2


def test_sampled_drf_is_bitwise_one_process(spmd):
    import h2o3_tpu_torch as th

    X, y, _Xv, _yv = spmd["data"]
    th.init(device="cpu")
    one = th.DRF(ntrees=5, max_depth=5, seed=3).train(
        y="y", training_frame=_one_process_frames()(X, y))
    for _info, arr in spmd["ranks"]:
        for k in FOREST:
            assert np.array_equal(arr[f"drf_{k}"],
                                  np.asarray(getattr(one.forest, k))), k


def test_imported_csv_lands_each_ranks_rows(spmd):
    import h2o3_tpu_torch as th

    th.init(device="cpu")
    one = th.import_file(spmd["csv"])
    for info, arr in spmd["ranks"]:
        assert info["csv_domain"] == one.col("g").domain
        for nm in one.names:
            assert np.array_equal(arr[f"csv_{nm}"], one.col(nm).to_numpy())
        assert info["csv_mean_x"] == pytest.approx(one.col("x").mean(),
                                                   rel=1e-6)
    assert [i["csv_shard"] for i, _a in spmd["ranks"]] == [[0, 167],
                                                          [167, 333]]
    th.DKV.remove(str(one.key))


def test_dkv_publish_and_fetch_across_processes(spmd):
    (i0, _a0), (i1, _a1) = spmd["ranks"]
    assert i0["had_cfg_before_fetch"] and not i1["had_cfg_before_fetch"]
    for info in (i0, i1):
        assert info["fetched"] == {"alpha": 0.5, "origin": 0}
        assert "shared_cfg" in info["global_keys"]
        assert info["gbm_key"] in info["global_keys"]


# -- REST on a row-sharded cloud, and a follower lost mid-train ----------

@pytest.fixture()
def sharded_cloud(tmp_path, monkeypatch):
    import h2o3_tpu_torch as th
    from h2o3_tpu_torch.api.server import start_server
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import oplog, supervisor

    monkeypatch.setenv("H2O_TPU_MESH_TIMEOUT_S", MESH_TIMEOUT_S)
    cloud = _Cloud(tmp_path, monkeypatch, auto_recover=False)
    # no interval checkpoints: a rejoin restores the checkpoint an op
    # that kept a collective's result ended in
    monkeypatch.setenv("H2O_TPU_OPLOG_CHECKPOINT_OPS", "0")
    cloud.env["H2O_TPU_OPLOG_CHECKPOINT_OPS"] = "0"
    th.init(device="cpu")
    D.initialize(store=cloud.store, num_processes=2, process_id=0)
    oplog.reset()
    supervisor.reset()
    srv = start_server(port=0)
    cloud.rest = Rest(srv.port)
    try:
        yield cloud
    finally:
        srv.stop()
        cloud.close()
        D.shutdown()
        oplog.reset()
        supervisor.reset()


def test_rest_over_the_oplog_a_rejoin_then_a_follower_lost_mid_train(
        sharded_cloud):
    from h2o3_tpu_torch import cluster as th_cluster
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.core.frame import Frame
    from h2o3_tpu_torch.parallel import ckpt, supervisor

    cloud = sharded_cloud
    fol = cloud.spawn("follower", 1)
    cloud.wait_file("ready.1", fol)
    _until(lambda: supervisor.evaluate() == supervisor.HEALTHY,
           "never HEALTHY")
    csv = write_api_csv(cloud.tmp / "train.csv", n=320)
    _setup, fr = cloud.rest.import_parse(csv)
    assert DKV.get(fr).shard == (0, 160) and DKV.get(fr).nrows == 320
    mk = cloud.rest.train("gbm", response_column="y", training_frame=fr,
                          ntrees=4, max_depth=3, seed=5)
    assert _digests(cloud, 1, fol, mk) == forest_digest(DKV.get(mk))
    cloud.rest.json("POST", f"/3/Predictions/models/{mk}/frames/{fr}",
                    data={"predictions_frame": "p_sharded"})
    got = cloud.rest.call("GET", "/3/DownloadDataset",
                          query={"frame_id": "p_sharded"})
    assert got[0] == 200 and got[2].count(b"\n") == 321
    assert isinstance(DKV.get("p_sharded"), Frame)
    rows = cloud.rest.call("GET", "/3/DownloadDataset",
                           query={"frame_id": fr})[2]

    # the follower lost after the train completed rejoins from the
    # train's own checkpoint: the suffix (a predict, two downloads)
    # replays alone
    seq = ckpt.latest_seq()
    assert seq is not None
    cloud.kill(fol)
    _until(lambda: supervisor.state() != supervisor.HEALTHY,
           "the supervisor never left HEALTHY")
    for name in ("models.1.json", "ready.1"):
        (cloud.tmp / name).unlink()
    fol = cloud.spawn("follower", 1, "--rejoin")
    assert int(cloud.wait_file("ready.1", fol)) > seq
    assert _digests(cloud, 1, fol, mk) == forest_digest(DKV.get(mk))
    _until(lambda: supervisor.state() == supervisor.HEALTHY,
           f"not HEALTHY again: {supervisor.status()['reason']}")
    # the rejoined rank holds its own rows of the frame and of the
    # predictions: both gather to what they were
    assert cloud.rest.call("GET", "/3/DownloadDataset",
                           query={"frame_id": fr})[2] == rows
    assert cloud.rest.call("GET", "/3/DownloadDataset",
                           query={"frame_id": "p_sharded"})[2] == got[2]

    mesh = th_cluster().mesh
    c0 = mesh.stats()["collectives"]
    out = cloud.rest.json("POST", "/3/ModelBuilders/gbm", data={
        "training_frame": fr, "response_column": "y", "ntrees": 400,
        "max_depth": 3, "seed": 5, "model_id": "long_gbm"})
    jk = out["job"]["key"]["name"]

    def job():
        return cloud.rest.json("GET", f"/3/Jobs/{jk}")["jobs"][0]

    # mid-train: the train's collectives are under way in both processes
    _until(lambda: mesh.stats()["collectives"] - c0 > 300,
           "the long train never ran", DEADLINE_S)
    t_kill = time.monotonic()
    cloud.kill(fol)
    while (st := job())["status"] != "FAILED":
        assert st["status"] == "RUNNING", st
        assert time.monotonic() - t_kill < float(MESH_TIMEOUT_S) + 15, \
            f"the train outlived its follower: {st}"
        time.sleep(0.05)
    assert "row mesh" in (st.get("exception") or "")
    assert supervisor.state() == supervisor.FAILED
    for k in (fr, mk, "p_sharded"):
        DKV.remove(k)


# -- the second tier (tests/mp_worker2.py) on the process pair ---------------

def test_sort_merge_group_by_and_dl_across_processes(cl, spmd):
    from h2o3_tpu.core.frame import Column as JColumn, Frame as JFrame
    from h2o3_tpu.ops.sort import sort_frame as jsort

    import h2o3_tpu_torch as th
    from torch_mp_support import DL_PARAMS, tier2_frames

    X, y, _Xv, _yv = spmd["data"]
    th.init(device="cpu")
    fr = _one_process_frames()(X, y)
    imp = th.import_file(spmd["csv"])
    one = tier2_frames(fr, imp)
    dl = th.DeepLearning(**DL_PARAMS).train(y="y", training_frame=fr)
    for pid, (info, arr) in enumerate(spmd["ranks"]):
        assert info["tier2_counters"]["gathered_rows"] == 0
        assert info["tier2_counters"]["exchanged_rows"] > 0
        assert info["tier2_counters"]["dl_batch_rows"] > 0
        for name, res in one.items():
            lo, hi = (0, -(-res.nrows // 2)) if pid == 0 else \
                (-(-res.nrows // 2), res.nrows)
            assert info[f"{name}_shard"] == [lo, hi]
            for nm in res.names:
                want = res.col(nm).data.float().numpy()
                assert np.array_equal(arr[f"{name}_{nm}"].view(np.uint8)
                                      if arr[f"{name}_{nm}"].dtype.kind
                                      == "f" else arr[f"{name}_{nm}"],
                                      res.col(nm).to_numpy().view(np.uint8)
                                      if arr[f"{name}_{nm}"].dtype.kind
                                      == "f" else res.col(nm).to_numpy()), \
                    (name, nm)
                assert np.array_equal(arr[f"{name}_local_{nm}"], want[lo:hi])
        for i, (W, b) in enumerate(dl.params_tree):
            assert np.array_equal(arr[f"dl_W{i}"], W.numpy())
            assert np.array_equal(arr[f"dl_b{i}"], b.numpy())
        assert info["dl_auc"] == dl._output.training_metrics.auc
    jf = JFrame.from_numpy(X.astype(np.float64), names=["a", "b", "c", "d"])
    jf.add("y", JColumn.from_numpy(y.astype(object), ctype="enum"))
    ja = np.asarray(jsort(jf, ["a"]).col("a").to_numpy())[: len(X)]
    for _info, arr in spmd["ranks"]:
        np.testing.assert_array_equal(arr["sort_a"], ja.astype(np.float32))
    th.DKV.remove(str(imp.key))


# -- munging and AutoML over REST; C47's window --------------------------------

def _frames(cloud, pid, proc, key):
    text = cloud.wait_file(f"frames.{pid}.json", proc,
                           lambda t: key in json.loads(t))
    return json.loads(text)[key]


def _csv_rows(body):
    lines = body.decode().strip().splitlines()
    return lines[0], lines[1:]


def test_munging_and_automl_over_rest_replay_on_the_follower(
        sharded_cloud):
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.parallel import supervisor

    cloud = sharded_cloud
    fol = cloud.spawn("follower", 1)
    cloud.wait_file("ready.1", fol)
    _until(lambda: supervisor.evaluate() == supervisor.HEALTHY,
           "never HEALTHY")
    csv = write_api_csv(cloud.tmp / "munge.csv", n=320)
    _setup, fr = cloud.rest.import_parse(csv)
    look = cloud.tmp / "look.csv"
    look.write_text("g,w\na,1.5\nb,-2\nc,4\n")
    _setup, lk = cloud.rest.import_parse(str(look))
    for key, ast in (
            ("srt", f"(assign srt (sort {fr} [1] [1]))"),
            ("mrg", f"(assign mrg (merge {fr} {lk} 0 0 [] [] 'auto'))"),
            ("gb", f"(assign gb (GB {fr} [0] 'mean' 1 'all' "
                   "'nrow' 0 'all'))")):
        cloud.rest.json("POST", "/99/Rapids",
                        data={"ast": ast, "session_id": "mp2"})
        n = DKV.get(key).nrows
        assert _frames(cloud, 1, fol, key)[0] == [-(-n // 2), n]
    body = cloud.rest.call("GET", "/3/DownloadDataset",
                           query={"frame_id": "srt"})[2]
    _hdr, rows = _csv_rows(body)
    xs = [float(r.split(",")[1]) for r in rows]
    assert len(xs) == 320 and xs == sorted(xs)
    assert DKV.get("mrg").nrows == 320 and DKV.get("gb").nrows == 3

    out = cloud.rest.json("POST", "/99/AutoMLBuilder", data={
        "input_spec": {"training_frame": fr, "response_column": "y"},
        "build_control": {"project_name": "mp_aml", "nfolds": 2,
                          "stopping_criteria": {"max_models": 2,
                                                "seed": 3}},
        "build_models": {"include_algos": ["GLM", "GBM"]}})
    job = cloud.rest.wait_job(out["job"]["key"]["name"], DEADLINE_S)
    assert job["status"] == "DONE", job.get("exception")
    aml = DKV.get("mp_aml")
    gbms = [m for m in aml.models if m.algo_name == "gbm"]
    assert gbms and len(aml.models) >= 2
    for m in gbms:
        assert str(m.key).startswith("mp_aml_")
        assert _digests(cloud, 1, fol, str(m.key)) == forest_digest(m)
    for k in (fr, lk, "srt", "mrg", "gb"):
        DKV.remove(k)


def test_a_follower_killed_after_the_last_collective_rejoins(
        sharded_cloud):
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.parallel import ckpt, supervisor

    cloud = sharded_cloud
    fol = cloud.spawn("follower", 1, "--die-at", "train")
    cloud.wait_file("ready.1", fol)
    _until(lambda: supervisor.evaluate() == supervisor.HEALTHY,
           "never HEALTHY")
    csv = write_api_csv(cloud.tmp / "win.csv", n=320)
    _setup, fr = cloud.rest.import_parse(csv)
    before = ckpt.latest_seq()
    out = cloud.rest.json("POST", "/3/ModelBuilders/gbm", data={
        "training_frame": fr, "response_column": "y", "ntrees": 3,
        "max_depth": 3, "seed": 5, "model_id": "win_gbm"})
    fol.wait(DEADLINE_S)                    # killed in the window
    assert fol.returncode == -9
    cloud.rest.wait_job(out["job"]["key"]["name"], DEADLINE_S)
    _until(lambda: supervisor.state() != supervisor.HEALTHY,
           "the supervisor never left HEALTHY")
    # the train's checkpoint was never booked: its op is in the suffix
    assert ckpt.latest_seq() == before
    for name in ("models.1.json", "frames.1.json", "ready.1"):
        (cloud.tmp / name).unlink(missing_ok=True)
    fol = cloud.spawn("follower", 1, "--rejoin", "--die-at", "rapids")
    cloud.wait_file("ready.1", fol)
    assert _digests(cloud, 1, fol, "win_gbm") == \
        forest_digest(DKV.get("win_gbm"))
    assert _frames(cloud, 1, fol, fr)[0] == [160, 320]
    # the coordinator books the joint replay's checkpoint
    _until(lambda: (ckpt.latest_seq() or -1) > (before or -1),
           "the joint replay's checkpoint was never booked")
    _until(lambda: supervisor.state() == supervisor.HEALTHY,
           f"not HEALTHY again: {supervisor.status()['reason']}")

    # the same window after a sort statement
    got = cloud.rest.call("POST", "/99/Rapids", data={
        "ast": f"(assign win_srt (sort {fr} [1] [1]))",
        "session_id": "win"})
    fol.wait(DEADLINE_S)
    assert fol.returncode == -9 and got[0] != 200
    _until(lambda: supervisor.state() != supervisor.HEALTHY,
           "the supervisor never left HEALTHY")
    for name in ("models.1.json", "frames.1.json", "ready.1"):
        (cloud.tmp / name).unlink(missing_ok=True)
    fol = cloud.spawn("follower", 1, "--rejoin")
    cloud.wait_file("ready.1", fol)
    assert _frames(cloud, 1, fol, "win_srt")[0] == [160, 320]
    _until(lambda: supervisor.state() == supervisor.HEALTHY,
           f"not HEALTHY again: {supervisor.status()['reason']}")
    body = cloud.rest.call("GET", "/3/DownloadDataset",
                           query={"frame_id": "win_srt"})[2]
    xs = [float(r.split(",")[1]) for r in _csv_rows(body)[1]]
    assert len(xs) == 320 and xs == sorted(xs)
    for k in (fr, "win_gbm", "win_srt"):
        DKV.remove(k)


def test_a_rejoin_refuses_to_replay_an_op_that_rewrote_its_input(
        sharded_cloud):
    """An op whose assign replaced one of its own inputs cannot run again
    on the coordinator beside the rejoiner (it would read its output): the
    coordinator refuses the joint replay, leaves its DKV as it was, and
    the rejoin fails naming the key."""
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.parallel import oplog, supervisor

    cloud = sharded_cloud
    fol = cloud.spawn("follower", 1, "--die-at", "rapids")
    cloud.wait_file("ready.1", fol)
    _until(lambda: supervisor.evaluate() == supervisor.HEALTHY,
           "never HEALTHY")
    csv = write_api_csv(cloud.tmp / "rw.csv", n=320)
    _setup, fr = cloud.rest.import_parse(csv)
    seq = oplog.current_seq()
    got = cloud.rest.call("POST", "/99/Rapids", data={
        "ast": f"(assign {fr} (rbind {fr} {fr}))", "session_id": "rw"})
    fol.wait(DEADLINE_S)                    # killed in the window
    assert fol.returncode == -9 and got[0] != 200
    assert DKV.get(fr).nrows == 640
    _until(lambda: supervisor.state() != supervisor.HEALTHY,
           "the supervisor never left HEALTHY")
    (cloud.tmp / "ready.1").unlink(missing_ok=True)
    fol = cloud.spawn("follower", 1, "--rejoin")
    fol.wait(DEADLINE_S)
    assert fol.returncode not in (0, None)
    assert not (cloud.tmp / "ready.1").exists()
    err = oplog.error_for(seq)
    assert err is not None and "cannot be replayed jointly" in err["trace"]
    assert fr in err["trace"]
    # the coordinator did not run the statement again
    assert DKV.get(fr).nrows == 640
    assert supervisor.state() != supervisor.HEALTHY
    DKV.remove(fr)


def test_the_window_fault_point_fires_before_the_rank_section(tmp_path,
                                                              monkeypatch):
    """`oplog.replay.collectives_done` fires after a replayed op's work
    and before its rank section: the window a rejoin's joint replay
    repairs (the two-process test kills the follower there)."""
    import inspect

    from h2o3_tpu_torch.core import failure
    from h2o3_tpu_torch.parallel import ckpt, oplog

    # the port's own fault point (the reference has no such window)
    assert 'faultpoint("oplog.replay.collectives_done")' in \
        inspect.getsource(oplog._replay)
    monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
    written = []
    monkeypatch.setattr(ckpt, "write_rank_section", written.append)
    with failure.inject("oplog.replay.collectives_done"):
        with pytest.raises(failure.InjectedFault):
            oplog._replay(3, "noop", {})
    assert written == [] and oplog.replaying_seq() is None


def test_the_coordinator_refuses_a_joint_replay_that_would_differ(
        monkeypatch):
    """`_joint_refusal`: an op whose end recorded a replaced DKV object,
    an op that changes state after it, or a third process each refuse
    the joint replay; an op at the head with nothing replaced is run."""
    import h2o3_tpu_torch as th
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.core.frame import Column, Frame
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import oplog

    def frame(n):
        fr = Frame()
        fr.add("x", Column.from_numpy(np.arange(n, dtype=np.float32)))
        return fr

    th.init(device="cpu")
    with D.memory_kv():
        monkeypatch.setattr(D, "process_count", lambda: 2)
        oplog.reset(4)
        try:
            for s, kind in ((1, "rapids"), (2, "noop"), (3, "checkpoint")):
                D.kv_put(f"oplog/{s}", json.dumps({"kind": kind,
                                                   "payload": {}}))
            assert oplog._joint_refusal(1) is None
            DKV.put("rw_a", frame(3))
            before = oplog._dkv_state()
            DKV.put("rw_b", frame(2))                 # a new key
            assert not oplog._note_rewrites(1, before)
            assert oplog._joint_refusal(1) is None
            DKV.put("rw_a", frame(3))                 # replaced
            assert oplog._note_rewrites(1, before)
            assert "rw_a" in oplog._joint_refusal(1)
            D.kv_delete("oplog/rewrites/1")
            D.kv_put("oplog/2", json.dumps({"kind": "train",
                                            "payload": {}}))
            assert oplog._joint_refusal(1) == "op 2 (train) ran after it"
            monkeypatch.setattr(D, "process_count", lambda: 3)
            assert "3 processes" in oplog._joint_refusal(1)
        finally:
            DKV.remove("rw_a")
            DKV.remove("rw_b")
            oplog.reset()
