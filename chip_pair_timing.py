"""Time two checkouts of the port against each other on one card, in one
call: each measurement runs in a fresh process per checkout, in the order
A, B, B, A, so that a drift of the machine shows as a gap between the two
runs of one checkout.

    python3 chip_pair_timing.py [--metrics A,B] [--munge A,B] [--shard A,B]
                                [--reps K] [--out FILE]

A and B are checkout roots, each holding ``chip_smoke.py`` and the
``h2o3_tpu_torch`` package; every process builds its checkout's kernels
and imports its package and its ``chip_smoke.py`` (for the flagship frame
and phase 3y's munging steps).

- ``--metrics``: the flagship GBM (1M rows, 20 trees of depth 5) trained
  after a warm-up, its wall and device time (torch.profiler, kernels
  summed) with the training metrics it computes; the metrics alone on
  its training predictions (median of 5, wall and device); and one
  DeepLearning epoch at the reference's defaults on the same frame
  (phase 3m's ``dl_train_s``).
- ``--munge``: two processes, ranks of a gloo row mesh on the one card,
  run phase 3y's munging steps (split, sort, merge, group-by) on the
  flagship frame sharded between them, three times; rank 0's seconds
  and exchanged bytes per step.
- ``--shard``: the same two ranks import the flagship CSV (written once,
  from B's ``chip_smoke.py``), warm up with a 2-tree GBM and run phase
  3y's ``_shard_slice`` (munging, the prim statements where the
  checkout has them, the 5-fold CV GBM, XGBoost, DeepLearning, AutoML);
  rank 0's seconds per train and the process's state (DKV keys, CUDA
  memory, resident set, threads, the mesh's collectives) before and
  after the prims and AutoML. Runs A, B, B', B', B, A (``--reps`` K
  times over), where B' is B with its prim statements skipped.

Prints one JSON object per process and, as its last line, all of them;
``--out`` writes them too. Exits 1 when a process fails or there is no
card.
"""

import json
import os
import subprocess
import sys
import time

WORKER_TIMEOUT_S = 900


def _sync():
    import torch

    torch.cuda.synchronize()


def _device_ms(fn):
    """Wall ms of one call of `fn` and the device ms of its kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    dev = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda) / 1e6
    return wall, dev


def _timed_s(fn):
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0


def _load_smoke(root):
    import runpy

    return runpy.run_path(os.path.join(root, "chip_smoke.py"))


def worker_metrics(root):
    import numpy as np

    import h2o3_tpu_torch as h2o

    cs = _load_smoke(root)
    dev = h2o.init().device
    F = cs["FLAGSHIP"]
    fr = cs["flagship_frame"](h2o, dev, F["n_rows"])

    def gbm():
        return h2o.GBM(ntrees=F["ntrees"], max_depth=F["max_depth"]).train(
            y="y", training_frame=fr)

    h2o.GBM(ntrees=2, max_depth=F["max_depth"]).train(y="y",
                                                      training_frame=fr)
    m, train_s = _timed_s(gbm)
    train_wall_ms, train_dev_ms = _device_ms(gbm)
    raw = m._predict_raw(m.adapt_test(fr))
    walls = []
    for _ in range(5):
        walls.append(_timed_s(lambda: m._make_metrics(fr, raw))[1] * 1e3)
    met_wall_ms, met_dev_ms = _device_ms(lambda: m._make_metrics(fr, raw))
    small = cs["flagship_frame"](h2o, dev, cs["DL"]["small_rows"], seed=1)
    h2o.DeepLearning(epochs=1, seed=cs["DL"]["seed"]).train(
        y="y", training_frame=small)
    _dl, dl_s = _timed_s(lambda: h2o.DeepLearning(
        epochs=1, seed=cs["DL"]["seed"]).train(y="y", training_frame=fr))
    return {"gbm_train_s": train_s, "gbm_profiled_wall_ms": train_wall_ms,
            "gbm_device_ms": train_dev_ms,
            "metrics_ms_median": float(np.median(walls)),
            "metrics_ms": walls, "metrics_profiled_wall_ms": met_wall_ms,
            "metrics_device_ms": met_dev_ms,
            "training_logloss": m._output.training_metrics.logloss,
            "dl_train_s": dl_s}


def worker_munge(root, rank):
    from h2o3_tpu_torch.parallel import distributed as D

    D.initialize()
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.parallel import mesh as M

    cs = _load_smoke(root)
    dev = h2o.init().device
    m = M.current()
    if m is None or m.size != 2 or m.rank != rank or dev.type != "cuda":
        raise SystemExit(f"rank {rank}: mesh {m and m.describe()} on {dev}")
    fr = cs["flagship_frame"](h2o, dev, cs["FLAGSHIP"]["n_rows"])
    reps = []
    for _ in range(3):
        _out, stats = cs["_munge_steps"](h2o, fr)
        reps.append(stats)
    return {"rank": rank, "shard": list(fr.shard), "backend": m.backend,
            "reps": reps}


def _state(h2o, m):
    """What the process holds that a later train could feel."""
    import threading

    import torch

    st = m.stats()
    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return {"dkv_keys": len(h2o.DKV.keys()),
            "cuda_allocated": torch.cuda.memory_allocated(),
            "cuda_reserved": torch.cuda.memory_reserved(),
            "rss_bytes": rss, "py_threads": threading.active_count(),
            "torch_threads": torch.get_num_threads(),
            "collectives": st["collectives"],
            "collective_s": st["seconds"]}


def worker_shard(root, rank, csv_path, prims):
    from h2o3_tpu_torch.parallel import distributed as D

    D.initialize()
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.parallel import mesh as M

    cs = _load_smoke(root)
    dev = h2o.init().device
    m = M.current()
    if m is None or m.size != 2 or m.rank != rank or dev.type != "cuda":
        raise SystemExit(f"rank {rank}: mesh {m and m.describe()} on {dev}")
    fr = h2o.import_file(csv_path, destination_frame="shard_flagship.hex")
    h2o.GBM(ntrees=2, max_depth=cs["FLAGSHIP"]["max_depth"]).train(
        y="y", training_frame=fr)
    _sync()
    probes = {}
    g = cs["_shard_slice"].__globals__
    prim_steps = g.get("_prim_steps")

    def probed_prims(*a, **k):
        probes["before_prims"] = _state(h2o, m)
        out = prim_steps(*a, **k) if prims else ({}, {}, {})
        _sync()
        probes["after_prims"] = _state(h2o, m)
        return out

    if prim_steps is not None:
        g["_prim_steps"] = probed_prims
    real_aml = h2o.H2OAutoML

    def probed_aml(*a, **k):
        aml = real_aml(*a, **k)
        train = aml.train

        def timed_train(*ta, **tk):
            probes["before_automl"] = _state(h2o, m)
            out = train(*ta, **tk)
            _sync()
            probes["after_automl"] = _state(h2o, m)
            return out

        aml.train = timed_train
        return aml

    h2o.H2OAutoML = probed_aml
    res = {}
    cs["_shard_slice"](h2o, dev, fr, m, res)
    keep = ("prims_wall_s", "sharded_cv_train_s", "sharded_xgb_train_s",
            "sharded_dl_train_s", "sharded_automl_train_s",
            "automl_leaderboard")
    return {"rank": rank, "prims": bool(prims and prim_steps),
            "munge_s": {k: v["s"] for k, v in res["munge"].items()},
            **{k: res[k] for k in keep if k in res}, "probes": probes}


def _worker(argv):
    kind, root = argv[0], argv[1]
    if kind == "metrics":
        res = worker_metrics(root)
    elif kind == "shard":
        res = worker_shard(root, int(argv[2]), argv[3], argv[4] == "1")
    else:
        res = worker_munge(root, int(argv[2]))
    res.update(kind=kind, root=root)
    print("RESULT " + json.dumps(res))


def _env(root, extra=None):
    env = dict(os.environ, PYTHONPATH=root, TORCH_CPP_LOG_LEVEL="ERROR")
    env.update(extra or {})
    return env


def _result(proc, out):
    for line in out.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"worker exited {proc.returncode}: {out[-3000:]}")


def _spawn(root, args, env):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", *args],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def run_metrics(root):
    p = _spawn(root, ["metrics", root], _env(root))
    out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
    return _result(p, out)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_munge(root, extra=()):
    port = _free_port()          # rank 0 hosts the cloud's store there
    kind = "shard" if extra else "munge"
    procs = [_spawn(root, [kind, root, str(r), *extra], _env(root, {
        "H2O_TPU_COORDINATOR": f"127.0.0.1:{port}",
        "H2O_TPU_NUM_PROCESSES": "2", "H2O_TPU_PROCESS_ID": str(r),
        "H2O_TPU_MESH_TIMEOUT_S": "120"})) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
    res = [_result(p, o) for p, o in zip(procs, outs)]
    if extra:
        res[0]["rank1_automl_train_s"] = res[1].get("sharded_automl_train_s")
    return res[0]


def _flagship_csv(root):
    """The flagship CSV phase 3y imports, written once from `root`'s
    chip_smoke.py into a temporary directory."""
    import runpy
    import tempfile

    cs = runpy.run_path(os.path.join(root, "chip_smoke.py"))
    path = os.path.join(tempfile.mkdtemp(prefix="pair_shard_"),
                        "flagship.csv")
    cs["write_csv"](path, cs["flagship_arrays"](cs["FLAGSHIP"]["n_rows"]),
                    cs["_repr_f32"])
    return path


def main(argv):
    if argv[:1] == ["--worker"]:
        _worker(argv[1:])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_pair_timing: no CUDA device", file=sys.stderr)
        return 1
    pairs, out_path = [], None
    for flag, fn in (("--metrics", run_metrics), ("--munge", run_munge)):
        if flag in argv:
            a, b = argv[argv.index(flag) + 1].split(",")
            pairs.append((flag[2:], fn, os.path.abspath(a),
                          os.path.abspath(b)))
    if "--out" in argv:
        out_path = argv[argv.index("--out") + 1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    results = []
    for kind, fn, a, b in pairs:
        for root in (a, b, b, a):
            res = fn(root)
            res["card"] = card.strip()
            print(json.dumps(res), flush=True)
            results.append(res)
    if "--shard" in argv:
        a, b = (os.path.abspath(x)
                for x in argv[argv.index("--shard") + 1].split(","))
        csv_path = _flagship_csv(b)
        try:
            reps = (int(argv[argv.index("--reps") + 1])
                    if "--reps" in argv else 1)
            for root, prims in ((a, 1), (b, 1), (b, 0), (b, 0), (b, 1),
                                (a, 1)) * reps:
                res = run_munge(root, (csv_path, str(prims)))
                res.update(kind="shard", root=root, card=card.strip())
                print(json.dumps(res), flush=True)
                results.append(res)
        finally:
            os.remove(csv_path)
            os.rmdir(os.path.dirname(csv_path))
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
