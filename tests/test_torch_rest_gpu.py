"""The port's REST server on the card (needs a CUDA card; skips without
one): a REST train and predict bitwise with the same in-process calls,
and a DeepLearning train over REST, its step loop a CUDA graph captured
while 8 threads post predictions, bitwise with the same train alone.
This file imports nothing of JAX; run it on the card with
``python -m pytest -m gpu tests/test_torch_rest_gpu.py``."""

import threading

import numpy as np
import pytest
import torch

from torch_port_support import assert_bitwise, flagship_cols
from torch_rest_support import Rest


@pytest.fixture()
def card_server():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import h2o3_tpu_torch as th
    from h2o3_tpu_torch.api.server import start_server

    th.init(device="cuda")
    fr = th.Frame(key="gpu_fr")
    for name, (arr, ctype) in flagship_cols(20_000, seed=5).items():
        fr.add(name, th.Column.from_numpy(arr, ctype=ctype, device="cuda"))
    fr.install()
    srv = start_server(port=0)
    try:
        yield th, Rest(srv.port), fr
    finally:
        srv.stop()
        th.init(device="cpu")


def _forest(m):
    return {k: getattr(m.forest, k).cpu().numpy() if torch.is_tensor(
        getattr(m.forest, k)) else np.asarray(getattr(m.forest, k))
        for k in ("feat", "thresh_bin", "na_left", "left", "right",
                  "leaf_val")}


@pytest.mark.gpu
def test_rest_train_and_predict_on_the_card_equal_in_process(card_server):
    from h2o3_tpu_torch.models.tree import hist_gather as hg

    th, R, fr = card_server
    kw = dict(ntrees=5, max_depth=5, seed=1)
    hg.launches = 0
    mid = R.train("gbm", training_frame="gpu_fr", response_column="y", **kw)
    assert hg.launches == 25
    m = th.DKV.get(mid)
    ref = th.GBM(**kw).train(y="y", training_frame=fr)
    a, b = _forest(m), _forest(ref)
    for k in a:
        assert_bitwise(a[k], b[k], k)
    R.json("POST", f"/3/Predictions/models/{mid}/frames/gpu_fr",
           data={"predictions_frame": "gpu_pred"})
    got, want = th.DKV.get("gpu_pred"), ref.predict(fr)
    assert got.col("Y").data.device.type == "cuda"
    assert_bitwise(got.col("Y").data.cpu().numpy(),
                   want.col("Y").data.cpu().numpy())


@pytest.mark.gpu
def test_graph_captured_train_over_rest_during_requests(card_server):
    th, R, fr = card_server
    gbm = R.train("gbm", training_frame="gpu_fr", response_column="y",
                  ntrees=3, max_depth=3, seed=1)
    params = dict(hidden=[32, 32], epochs=1, seed=7)
    alone = th.DeepLearning(**params).train(y="y", training_frame=fr)
    stop = threading.Event()
    served, errors = [], []

    def client(i):
        while not stop.is_set():
            try:
                R.json("POST", f"/3/Predictions/models/{gbm}/frames/gpu_fr",
                       data={"predictions_frame": f"gpu_c{i}"})
                served.append(i)
            except Exception as e:   # noqa: BLE001 — reported below
                errors.append(e)
                return

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    try:
        mid = R.train("deeplearning", training_frame="gpu_fr",
                      response_column="y", hidden="[32, 32]", epochs=1,
                      seed=7)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    assert not errors and len(served) >= 8
    rest = th.DKV.get(mid)
    for (W, b), (W0, b0) in zip(rest.params_tree, alone.params_tree):
        assert_bitwise(W.cpu().numpy(), W0.cpu().numpy())
        assert_bitwise(b.cpu().numpy(), b0.cpu().numpy())
