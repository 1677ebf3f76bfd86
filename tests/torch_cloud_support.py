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
  ``models.{pid}.json``, the forest digest of every GBM in its DKV;
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


def _write(path: str, text: str) -> None:
    with open(path + ".part", "w") as f:
        f.write(text)
    os.replace(path + ".part", path)


def main(argv) -> None:
    import datetime

    import torch.distributed as dist

    role, port, pid, out = argv[0], int(argv[1]), int(argv[2]), argv[3]
    rejoin = "--rejoin" in argv
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
        digests = {}
        for k in DKV.keys():
            m = DKV.get(k)
            if getattr(m, "forest", None) is not None:
                digests[str(k)] = forest_digest(m)
        _write(os.path.join(out, f"models.{pid}.json"), json.dumps(digests))

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
