"""One rank of a two-process row-sharded cloud of the port on the CPU
(tests/test_torch_sharded_mp.py): the port's counterpart of the JAX
package's tests/mp_worker.py.

Run as ``python tests/torch_mp_support.py STORE_PORT PID OUTDIR`` with the
repo on ``PYTHONPATH``; the test hosts the TCPStore and wrote
``OUTDIR/data.npz`` (the training and validation arrays) and
``OUTDIR/data.csv``. Both ranks run the same steps, their collectives
keeping them in step; each writes ``OUTDIR/rank.{pid}.npz`` and
``OUTDIR/rank.{pid}.json`` with what the test compares: its shard, the
cloud's column mean, the GLM's coefficients, the GBM's (validation,
early stopping) and the sampled DRF's forests and gathered predictions,
the imported CSV's shard and gathered columns, and what the DKV's
cross-process half returned; then the JAX package's second tier
(tests/mp_worker2.py): the sample sort, a join with a lookup frame, a
group-by and a DeepLearning train, each rank's rows of their results
and the gathered results.
"""

import datetime
import json
import os
import sys


# stops early, at tree 8 of 12, in one process and in the JAX package
GBM_PARAMS = dict(ntrees=12, max_depth=3, seed=2, stopping_rounds=2,
                  score_tree_interval=1, stopping_tolerance=0.05)


def _forest(prefix, m, out):
    import numpy as np

    fo = m.forest
    for k in ("feat", "thresh_bin", "na_left", "left", "right", "leaf_val"):
        out[f"{prefix}_{k}"] = np.asarray(getattr(fo, k))


def main(argv) -> None:
    import numpy as np
    import torch.distributed as dist

    port, pid, outdir = int(argv[0]), int(argv[1]), argv[2]
    store = dist.TCPStore("127.0.0.1", port, 2, False,
                          timeout=datetime.timedelta(seconds=60))
    from h2o3_tpu_torch.parallel import distributed as D

    D.initialize(store=store, num_processes=2, process_id=pid)
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core import sharded_frame
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.core.frame import Column, Frame
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    cl = h2o.init(device="cpu")
    mesh = cl.mesh
    assert mesh is not None and mesh.size == 2 and mesh.rank == pid
    d = np.load(os.path.join(outdir, "data.npz"), allow_pickle=False)
    arr, info = {}, {"rank": pid, "backend": mesh.backend}

    def frame(X, y):
        fr = Frame.from_numpy(X, names=["a", "b", "c", "d"])
        fr.add("y", Column.from_numpy(y.astype(object), ctype="enum"))
        return fr

    fr, vfr = frame(d["X"], d["y"]), frame(d["Xv"], d["yv"])
    info["shard"] = list(fr.shard)
    info["local_rows"] = fr.local_rows
    info["mean_a"] = float(fr.col("a").mean())
    arr["a_shard"] = fr.col("a").data.float().numpy()
    sharded_frame.reset_counters()

    glm = h2o.GLM(family="binomial", lambda_=0.0, seed=1).train(
        y="y", training_frame=fr)
    arr["glm_beta"] = glm.beta.numpy()
    info["glm_iterations"] = int(glm.iterations)

    hg.launches = 0
    gbm = h2o.GBM(**GBM_PARAMS).train(
        y="y", training_frame=fr, validation_frame=vfr)
    _forest("gbm", gbm, arr)
    info["gbm_auc"] = float(gbm._output.training_metrics.auc)
    info["gbm_valid_auc"] = float(gbm._output.validation_metrics.auc)
    info["gbm_history"] = gbm._output.scoring_history
    drf = h2o.DRF(ntrees=5, max_depth=5, seed=3).train(y="y",
                                                       training_frame=fr)
    _forest("drf", drf, arr)
    info["gathered_in_train"] = sharded_frame.counters()["gathered_rows"]
    pred = gbm.predict(fr)
    arr["gbm_pred"] = pred.col("Y").to_numpy()      # gathered

    imp = h2o.import_file(os.path.join(outdir, "data.csv"),
                          destination_frame="mp_csv")
    info["csv_shard"] = list(imp.shard)
    info["csv_mean_x"] = float(imp.col("x").mean())
    for nm in imp.names:
        arr[f"csv_{nm}"] = imp.col(nm).to_numpy()
    info["csv_domain"] = imp.col("g").domain

    assert DKV.publish(str(gbm.key))
    if pid == 0:
        cfg = {"alpha": 0.5, "origin": 0}
        DKV.put("shared_cfg", cfg)
        DKV.publish("shared_cfg", cfg, replicate=True)
    info["had_cfg_before_fetch"] = DKV.contains("shared_cfg")
    mesh.barrier()
    info["fetched"] = DKV.fetch_remote("shared_cfg", timeout_ms=30000)
    info["global_keys"] = DKV.global_keys()
    info["gbm_key"] = str(gbm.key)

    _tier2(h2o, fr, imp, arr, info)

    np.savez(os.path.join(outdir, f"rank.{pid}.npz"), **arr)
    with open(os.path.join(outdir, f"rank.{pid}.json"), "w") as f:
        json.dump(info, f)
    mesh.barrier()          # neither rank leaves while the other gathers


def tier2_frames(fr, imp):
    """The second tier's results on `fr` (the training frame) and `imp`
    (the imported CSV): a sort, an inner join with a 3-row lookup on the
    enum key, a group-by."""
    import numpy as np

    from h2o3_tpu_torch.core.frame import Column, Frame
    from h2o3_tpu_torch.ops.groupby import GroupBy
    from h2o3_tpu_torch.ops.merge import merge
    from h2o3_tpu_torch.ops.sort import sort_frame

    look = Frame()
    look.add("g", Column.from_numpy(np.array(["a", "b", "c"], object),
                                    ctype="enum"))
    look.add("w", Column.from_numpy(np.array([1.5, -2.0, 4.0])))
    return {"sort": sort_frame(fr, ["a"]),
            "merge": merge(imp, look),
            "gb": GroupBy(imp, ["g"]).count().mean("x").sum("z")
            .get_frame()}


DL_PARAMS = dict(hidden=[8, 8], epochs=1, seed=4, mini_batch_size=16)


def _tier2(h2o, fr, imp, arr, info) -> None:
    from h2o3_tpu_torch.core import sharded_frame

    sharded_frame.reset_counters()
    out = tier2_frames(fr, imp)
    dl = h2o.DeepLearning(**DL_PARAMS).train(y="y", training_frame=fr)
    info["tier2_counters"] = sharded_frame.counters()
    for name, res in out.items():
        info[f"{name}_shard"] = list(res.shard)
        for nm in res.names:
            c = res.col(nm)
            arr[f"{name}_local_{nm}"] = c.data.float().numpy()
            arr[f"{name}_{nm}"] = c.to_numpy()          # gathered
    for i, (W, b) in enumerate(dl.params_tree):
        arr[f"dl_W{i}"], arr[f"dl_b{i}"] = W.numpy(), b.numpy()
    info["dl_auc"] = float(dl._output.training_metrics.auc)


if __name__ == "__main__":
    main(sys.argv[1:])
