"""One process of a CPU test cloud of the port (tests/test_torch_cloud_mp.py):
a coordinator, a follower or a standby over a ``torch.distributed``
TCPStore that the test hosts.

Run as ``python tests/torch_cloud_support.py ROLE STORE_PORT PID OUTDIR
[--rejoin]``, with the repo on ``PYTHONPATH`` and the cloud's knobs in
the environment; the cloud has two processes. Every role boots the port
on the CPU and writes what the test reads into OUTDIR:

- ``coordinator``: the REST server; ``port.{pid}`` holds its port;
- ``follower``: `follower_loop` (after `distributed.rejoin()` with
  ``--rejoin``); ``ready.{pid}`` once it replays, and after every op
  ``models.{pid}.json``, the forest digest of every GBM in its DKV, and
  ``frames.{pid}.json``, each frame's shard and a digest of its rows
  there. With ``--die-at KIND`` it kills itself (SIGKILL) in the window
  after a replayed op of that kind finished its collectives and before
  its rank section and ack (the ``oplog.replay.collectives_done`` fault
  point);
- ``standby``: a follower whose recovery watchdog binds REST when it
  wins the standby election; ``port.{pid}`` holds that port.
"""

import hashlib
import json
import os
import sys
import threading
import time


def forest_digest(m) -> str:
    """sha256 over a tree model's forest arrays, leaf values included."""
    import numpy as np

    h = hashlib.sha256()
    fo = m.forest
    for k in ("feat", "thresh_bin", "na_left", "left", "right", "cat_split",
              "leaf_val"):
        a = np.ascontiguousarray(np.asarray(getattr(fo, k)))
        h.update(f"{k}{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def frame_digest(fr) -> list:
    """[shard, sha256 over this process's rows of every column]."""
    import numpy as np

    h = hashlib.sha256()
    for nm in fr.names:
        c = fr.col(nm)
        if c.data is not None:
            import torch

            t = c.data.cpu()
            # numpy has no bfloat16: hash its bits
            t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            a = np.ascontiguousarray(t.numpy())
            h.update(f"{nm}{a.dtype}{a.shape}".encode() + a.tobytes())
        else:
            h.update(repr(list(c.host_data)).encode())
    return [list(fr.shard) if fr.shard else None, h.hexdigest()]


def _die_at(kind: str) -> None:
    """SIGKILL this process at the window of the first replayed op of
    `kind`: its collectives done, its rank section and ack not yet."""
    import signal

    from h2o3_tpu_torch.core import failure
    from h2o3_tpu_torch.parallel import oplog

    replay, point = oplog._replay, failure.faultpoint
    now = {}

    def tracked(seq, k, payload):
        now["kind"] = k
        return replay(seq, k, payload)

    def fault(name):
        if name == "oplog.replay.collectives_done" and now.get("kind") == kind:
            os.kill(os.getpid(), signal.SIGKILL)
        return point(name)

    oplog._replay = tracked
    failure.faultpoint = fault


def _write(path: str, text: str) -> None:
    with open(path + ".part", "w") as f:
        f.write(text)
    os.replace(path + ".part", path)


def main(argv) -> None:
    import datetime

    import torch.distributed as dist

    role, port, pid, out = argv[0], int(argv[1]), int(argv[2]), argv[3]
    rejoin = "--rejoin" in argv
    die_at = argv[argv.index("--die-at") + 1] if "--die-at" in argv else None
    store = dist.TCPStore("127.0.0.1", port, 2, False,
                          timeout=datetime.timedelta(seconds=60))
    from h2o3_tpu_torch.parallel import distributed as D

    D.initialize(store=store, num_processes=2, process_id=pid)
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.api import server
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.parallel import oplog, watchdog

    h2o.init(device="cpu")
    if role == "coordinator":
        srv = server.start_server(port=0)
        _write(os.path.join(out, f"port.{pid}"), str(srv.port))
        while True:
            time.sleep(0.5)

    def dump(kind, payload):
        from h2o3_tpu_torch.core.frame import Frame

        digests, frames = {}, {}
        for k in DKV.keys():
            m = DKV.get(k)
            if getattr(m, "forest", None) is not None:
                digests[str(k)] = forest_digest(m)
            if isinstance(m, Frame) and m.ncols:
                frames[str(k)] = frame_digest(m)
        _write(os.path.join(out, f"models.{pid}.json"), json.dumps(digests))
        _write(os.path.join(out, f"frames.{pid}.json"), json.dumps(frames))

    if die_at:
        _die_at(die_at)

    cursor = D.rejoin() if rejoin else 0
    dump("ready", {})
    _write(os.path.join(out, f"ready.{pid}"), str(cursor))
    if role == "standby":
        box = {}

        def elect():
            box["srv"] = server.assume_coordination(port=0)
            _write(os.path.join(out, f"port.{pid}"), str(box["srv"].port))

        threading.Thread(
            target=lambda: oplog.follower_loop(idle_timeout_s=120,
                                               on_op=dump,
                                               start_seq=cursor),
            daemon=True).start()
        watchdog.Watchdog(interval=0.2, elect=elect, follow=False).start()
        while True:
            time.sleep(0.5)
    oplog.follower_loop(idle_timeout_s=120, on_op=dump, start_seq=cursor)


if __name__ == "__main__":
    main(sys.argv[1:])
