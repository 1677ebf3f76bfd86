"""The port's control plane across real processes, on the CPU: a
``torch.distributed`` TCPStore that the test hosts, and processes of
tests/torch_cloud_support.py (each with a 60 s deadline) as followers,
a coordinator or a standby.

1. A REST GBM train on the in-test coordinator is replayed by a follower
   process: its forest is bitwise the coordinator's, every op acked.
2. The follower is killed: the cloud degrades and a request answers
   503; a restarted follower rejoins from the control-plane checkpoint
   (its model restored, not retrained), the supervisor returns to
   HEALTHY and a new op is acked.
3. The coordinator process is killed: the standby's watchdog wins the
   election (its epoch record lands by compare-and-set) and binds REST;
   once the ex-coordinator rejoins as a follower, a predict through the
   new coordinator is bitwise the baseline predict.

A ``gpu`` case holds the snapshot restore to the restorer's card.
"""

import datetime
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from torch_cloud_support import forest_digest
from torch_rest_support import Rest, write_api_csv

pytestmark = pytest.mark.chaos

ROOT = Path(__file__).resolve().parent.parent
PROC_DEADLINE_S = 60.0
KNOBS = {"H2O_TPU_HEARTBEAT_STALE_S": "3",
         "H2O_TPU_SUPERVISE_INTERVAL_S": "0.2",
         "H2O_TPU_OP_ACK_TIMEOUT_S": "20",
         "H2O_TPU_ELECTION_GRACE_S": "3",
         "H2O_TPU_OPLOG_CHECKPOINT_OPS": "2",
         "H2O_TPU_OPLOG_CKPT_ASYNC": "0",
         "H2O_TPU_RETRY_BASE_MS": "1"}


class _Cloud:
    """The test's store, its worker processes and their output dir."""

    def __init__(self, tmp, monkeypatch, auto_recover):
        import torch.distributed as dist

        self.tmp = tmp
        self.procs = []
        env = dict(KNOBS, H2O_TPU_OPLOG_CKPT_DIR=str(tmp / "ckpt"),
                   H2O_TPU_AUTO_RECOVER="1" if auto_recover else "0")
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        self.env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT), str(ROOT / "tests")]), TORCH_CPP_LOG_LEVEL="ERROR")
        self.store = dist.TCPStore("127.0.0.1", 0, 2, True,
                                   timeout=datetime.timedelta(seconds=60),
                                   wait_for_workers=False)

    def spawn(self, role, pid, *extra):
        log = open(self.tmp / f"{role}.{pid}.{len(self.procs)}.log", "w")
        p = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_cloud_support.py"),
             role, str(self.store.port), str(pid), str(self.tmp), *extra],
            env=self.env, stdout=log, stderr=subprocess.STDOUT)
        p.started = time.monotonic()
        self.procs.append(p)
        return p

    def wait_file(self, name, proc, pred=lambda text: True):
        """The text of OUTDIR/name once `pred` holds; fails when `proc`
        ends or its 60 s deadline passes."""
        path = self.tmp / name
        while True:
            if path.exists():
                text = path.read_text()
                if pred(text):
                    return text
            assert proc.poll() is None, (name, self.logs())
            assert time.monotonic() - proc.started < PROC_DEADLINE_S, \
                (name, self.logs())
            time.sleep(0.02)

    def kill(self, proc):
        proc.send_signal(signal.SIGKILL)
        proc.wait(PROC_DEADLINE_S)

    def logs(self):
        return {p.name: p.read_text()[-3000:]
                for p in self.tmp.glob("*.log")}

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(PROC_DEADLINE_S)


def _until(cond, what, deadline_s=PROC_DEADLINE_S):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < deadline_s, what
        time.sleep(0.02)


@pytest.fixture()
def coord_cloud(tmp_path, monkeypatch):
    """This process is the coordinator (process 0, the REST server) of a
    two-process cloud on the CPU; the follower is spawned by the test."""
    import h2o3_tpu_torch as th
    from h2o3_tpu_torch.api.server import start_server
    from h2o3_tpu_torch.parallel import distributed as D
    from h2o3_tpu_torch.parallel import oplog, supervisor

    cloud = _Cloud(tmp_path, monkeypatch, auto_recover=False)
    th.init(device="cpu")
    D.initialize(store=cloud.store, num_processes=2, process_id=0)
    oplog.reset()
    supervisor.reset()
    # the runtime booted before the cloud: the server starts the beater
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


def _follower_ready(cloud, *extra):
    """Spawn the follower and wait until it replays and the in-test
    coordinator's supervisor has seen its beat."""
    from h2o3_tpu_torch.parallel import supervisor

    fol = cloud.spawn("follower", 1, *extra)
    text = cloud.wait_file("ready.1", fol)
    _until(lambda: supervisor.evaluate() == supervisor.HEALTHY,
           f"never HEALTHY: {supervisor.status()['reason']}")
    return fol, text


def _digests(cloud, pid, proc, key):
    text = cloud.wait_file(f"models.{pid}.json", proc,
                           lambda t: key in json.loads(t))
    return json.loads(text)[key]


def _train_and_predict(rest, csv):
    _setup, fr = rest.import_parse(csv)
    mk = rest.train("gbm", response_column="y", training_frame=fr, ntrees=4,
                    max_depth=3, seed=5)
    rest.json("POST", f"/3/Predictions/models/{mk}/frames/{fr}",
              data={"predictions_frame": "p_base"})
    return fr, mk


def test_rest_train_is_replayed_by_a_follower_bitwise(coord_cloud):
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.parallel import oplog

    cloud = coord_cloud
    fol, _ = _follower_ready(cloud)
    csv = cloud.tmp / "train.csv"
    write_api_csv(csv, n=320)
    fr, mk = _train_and_predict(cloud.rest, str(csv))
    assert _digests(cloud, 1, fol, mk) == forest_digest(DKV.get(mk))
    # every op acknowledged: the follower's ack lag is 0
    lag = {r["process"]: r for r in oplog.follower_lag()}
    assert lag[1]["ack_lag"] == 0
    for k in (fr, mk, "p_base"):
        DKV.remove(k)


def test_killed_follower_rejoins_from_checkpoint_to_healthy(coord_cloud):
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.parallel import ckpt, supervisor

    cloud = coord_cloud
    fol, _ = _follower_ready(cloud)
    csv = cloud.tmp / "train.csv"
    write_api_csv(csv, n=320)
    fr, mk = _train_and_predict(cloud.rest, str(csv))
    want = forest_digest(DKV.get(mk))
    assert _digests(cloud, 1, fol, mk) == want
    # three acked ops crossed the interval of 2: a checkpoint op ran
    # and truncated its acknowledged prefix
    seq = ckpt.latest_seq()
    assert seq is not None and ckpt.truncated_through() == seq
    cloud.kill(fol)
    _until(lambda: supervisor.state() != supervisor.HEALTHY,
           "the supervisor never left HEALTHY")
    code, _h, body = cloud.rest.call(
        "POST", f"/3/Predictions/models/{mk}/frames/{fr}",
        data={"predictions_frame": "p_refused"})
    assert code == 503, body
    (cloud.tmp / "models.1.json").unlink()
    fol2 = cloud.spawn("follower", 1, "--rejoin")
    cursor = int(cloud.wait_file("ready.1", fol2,
                                 lambda t: t.strip() != "0"))
    assert cursor > seq
    # restored from the checkpoint, not retrained: the same forest
    assert _digests(cloud, 1, fol2, mk) == want
    _until(lambda: supervisor.state() == supervisor.HEALTHY,
           f"not HEALTHY again: {supervisor.status()['reason']}")
    cloud.rest.json("POST", f"/3/Predictions/models/{mk}/frames/{fr}",
                    data={"predictions_frame": "p_after"})
    for k in (fr, mk, "p_base", "p_after"):
        DKV.remove(k)


def test_killed_coordinator_is_replaced_by_election(tmp_path, monkeypatch):
    cloud = _Cloud(tmp_path, monkeypatch, auto_recover=True)
    try:
        coord = cloud.spawn("coordinator", 0)
        standby = cloud.spawn("standby", 1)
        rest = Rest(int(cloud.wait_file("port.0", coord)))
        cloud.wait_file("ready.1", standby)
        csv = tmp_path / "train.csv"
        write_api_csv(csv, n=320)
        fr, mk = _train_and_predict(rest, str(csv))
        base = rest.call("GET", "/3/DownloadDataset",
                         query={"frame_id": "p_base"})[2]
        digest = _digests(cloud, 1, standby, mk)
        cloud.kill(coord)
        rest2 = Rest(int(cloud.wait_file("port.1", standby)))
        rec = json.loads(cloud.store.get("oplog/epoch"))
        assert rec["epoch"] == 1 and rec["leader"] == 1
        # the ex-coordinator comes back as a follower of epoch 1
        back = cloud.spawn("follower", 0, "--rejoin")
        cloud.wait_file("ready.0", back)
        assert _digests(cloud, 0, back, mk) == digest

        def healthy():
            code, _h, body = rest2.call("GET", "/3/CloudStatus")
            return code == 200 and json.loads(body)["state"] == "HEALTHY"

        _until(healthy, "the new coordinator's cloud never got HEALTHY")
        rest2.json("POST", f"/3/Predictions/models/{mk}/frames/{fr}",
                   data={"predictions_frame": "p_new"})
        got = rest2.call("GET", "/3/DownloadDataset",
                         query={"frame_id": "p_new"})[2]
        assert got == base
    finally:
        cloud.close()


@pytest.mark.gpu
def test_card_written_snapshot_restores_onto_the_restorers_card():
    """A snapshot written from models and frames on the card restores its
    tensors onto the restoring process's runtime device, the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import h2o3_tpu_torch as th
    from h2o3_tpu_torch.core.dkv import DKV

    th.init(device="cuda")
    rng = np.random.default_rng(4)
    fr = th.Frame()
    fr.add("x", th.Column.from_numpy(rng.standard_normal(256)))
    fr.add("y", th.Column.from_numpy(rng.standard_normal(256)))
    fr.install()
    m = th.GBM(ntrees=3, max_depth=3, seed=1).train(y="y",
                                                     training_frame=fr)
    want = m.predict(fr)
    snap = DKV.snapshot_control_plane()
    keys = (str(fr.key), str(m.key))
    snap["objects"] = {k: snap["objects"][k] for k in keys}
    try:
        for k in keys:
            DKV.remove(k)
        DKV.restore_control_plane(snap)
        fr2, m2 = DKV.get(str(fr.key)), DKV.get(str(m.key))
        assert all(fr2.col(n).data.device.type == "cuda"
                   for n in fr2.names)
        got = m2.predict(fr2)
        for c in want.names:
            assert np.array_equal(got.col(c).to_numpy(),
                                  want.col(c).to_numpy()), c
    finally:
        for k in (str(fr.key), str(m.key)):
            DKV.remove(k)
