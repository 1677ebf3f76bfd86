"""`GET /3/Models` lists every model in the DKV, a family without a
metrics schema of its own (an autoencoder's reconstruction error) through
the schema's generic fallback, which reads the metrics' shared fields."""

import numpy as np

import h2o3_tpu_torch as th
from h2o3_tpu_torch.api.server import start_server

from torch_rest_support import Rest


def test_models_route_lists_an_autoencoder():
    th.init(device="cpu")
    rng = np.random.default_rng(2)
    fr = th.Frame()
    for name in ("a", "b", "c"):
        fr.add(name, th.Column.from_numpy(rng.standard_normal(128)))
    m = th.DeepLearning(autoencoder=True, hidden=[2], epochs=1,
                        seed=1).train(training_frame=fr)
    srv = start_server(port=0)
    try:
        rest = Rest(srv.port)
        names = [x["model_id"]["name"]
                 for x in rest.json("GET", "/3/Models")["models"]]
        assert str(m.key) in names
        out = rest.json("GET", f"/3/Models/{m.key}")["models"][0]["output"]
        tm = out["training_metrics"]
        assert tm["MSE"] == m._output.training_metrics.mse
        assert tm["nobs"] == 128
    finally:
        srv.stop()
        th.DKV.remove(str(m.key))
