"""Serving over the port's REST server (mirrors the one-process cases of
tests/test_serving_qps.py): a coalesced flush over HTTP, 429 with
Retry-After on a shed (the same reply as the JAX server's), the async
/4 route bitwise with the sync /3 one, and the rule that keeps a
REST-launched train safe from concurrent requests: a DeepLearning
train started over REST while 8 threads post predictions ends with the
weights of the same train run alone. Both servers run in this process
on ephemeral ports, the port on the CPU."""

import json
import threading
import time

import numpy as np
import pytest

from torch_port_support import assert_bitwise, both_frames, train_cols
from torch_rest_support import Rest, start_both

KW = dict(ntrees=3, max_depth=3, nbins=16, seed=1)


@pytest.fixture(scope="module")
def env(cl):
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    import h2o3_tpu_torch as th

    with pytest.MonkeyPatch.context() as mp:
        js, ts = start_both(mp)
        try:
            jf, tf = both_frames(train_cols(n=384))
            for f in (jf, tf):
                f._key = type(f._key)("sv_fr")
                f.install()
            jm = JGBM(**KW).train(y="y", training_frame=jf)
            tm = th.GBM(**KW).train(y="y", training_frame=tf)
            jm._key = type(jm._key)("sv_gbm")
            tm._key = "sv_gbm"
            jm.install()
            tm.install()
            yield {"J": Rest(js.port), "T": Rest(ts.port), "tm": tm,
                   "tf": tf}
        finally:
            js.stop()
            ts.stop()


def _piece(tf, lo, hi, key):
    import h2o3_tpu_torch as th

    fr = th.Frame(key=key)
    for nm in tf.names:
        c = tf.col(nm)
        fr.add(nm, th.Column(c.data[lo:hi].clone(), c.ctype, hi - lo,
                             domain=c.domain))
    fr.install()
    return fr


def test_coalesced_flush_over_http(env, monkeypatch):
    import h2o3_tpu_torch as th
    from h2o3_tpu_torch import scoring
    from h2o3_tpu_torch.obs import metrics

    monkeypatch.setenv("H2O_TPU_SCORE_BATCH_WINDOW_MS", "200")
    T, tm, tf = env["T"], env["tm"], env["tf"]
    frames = [_piece(tf, 40 * i, 40 * i + 30 + i, f"sv_p{i}")
              for i in range(6)]
    refs = [tm.predict(fr) for fr in frames]
    scoring.session_for(tm).predict(frames[0])          # warm the bucket
    h = metrics.REGISTRY.get("h2o3_score_flush_requests")
    before = scoring.dispatch_counters().get("host", 0)
    n_before = sum(s["count"] for s in h.snapshot()["samples"])
    outs, tids = [None] * len(frames), [None] * len(frames)

    def post(i):
        code, hdrs, body = T.call(
            "POST", f"/3/Predictions/models/sv_gbm/frames/sv_p{i}",
            data={"predictions_frame": f"sv_o{i}"})
        assert code == 200, body[:300]
        outs[i], tids[i] = json.loads(body), hdrs.get("X-H2O3-Trace-Id")

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    flushes = sum(s["count"] for s in h.snapshot()["samples"]) - n_before
    disp = scoring.dispatch_counters().get("host", 0) - before
    # six requests within one window: fewer flushes and dispatches than
    # requests, and each request gets exactly its own rows
    assert 1 <= flushes < len(frames) and 1 <= disp < len(frames)
    # every request's own trace holds its wait, its finish (prediction
    # frame and metrics) and its reply; a request scored in another's
    # flush holds one batch span that names the leading trace
    led = 0
    for tid in tids:
        t0 = time.time()
        while True:       # the ingress span ends after the reply is out
            spans = T.json("GET", f"/3/Trace/{tid}")["spans"]
            names = [sp["name"] for sp in spans]
            if "ingress" in names:
                break
            assert time.time() - t0 < 10, names
            time.sleep(0.01)
        for want in ("score", "queue_wait", "finish", "metrics", "schema",
                     "reply"):
            assert names.count(want) == 1, (want, names)
        if "pack" in names:
            led += 1
            assert "batch" not in names, names
        else:
            batch = [sp for sp in spans if sp["name"] == "batch"]
            assert len(batch) == 1 and batch[0]["attrs"]["lead_trace"] \
                in tids, batch
    assert led == flushes
    for i, (fr, ref) in enumerate(zip(frames, refs)):
        assert outs[i]["predictions_frame"]["name"] == f"sv_o{i}"
        got = th.DKV.get(f"sv_o{i}")
        assert got.nrows == fr.nrows
        for nm in ("N", "Y"):
            assert_bitwise(got.col(nm).data.numpy(), ref.col(nm).data.numpy())


def test_v4_async_bitwise_with_v3_sync(env):
    import h2o3_tpu_torch as th

    T = env["T"]
    T.json("POST", "/3/Predictions/models/sv_gbm/frames/sv_fr",
           data={"predictions_frame": "sv_v3"})
    out = T.json("POST", "/4/Predictions/models/sv_gbm/frames/sv_fr")
    T.done_job(out)
    a, b = th.DKV.get("sv_v3"), th.DKV.get(out["dest"]["name"])
    for nm in ("N", "Y"):
        assert_bitwise(a.col(nm).data.numpy(), b.col(nm).data.numpy())
    assert list(a.col("predict").values()) == list(b.col("predict").values())


def test_shed_is_429_with_retry_after_like_the_reference(env, monkeypatch):
    from h2o3_tpu import admission as jadm

    from h2o3_tpu_torch import admission as tadm

    monkeypatch.setenv("H2O_TPU_SCORE_SLO_MS", "50")
    replies = []
    for R, adm in ((env["J"], jadm), (env["T"], tadm)):
        adm.CONTROLLER.reset()
        for _ in range(32):
            adm.CONTROLLER.note_latency("sv_gbm", 5000.0)
        g = adm.CONTROLLER._gate("sv_gbm")
        with g.cond:
            g.inflight = adm.CONTROLLER._limit(g)
        try:
            for route in ("/3/Predictions", "/4/Predictions"):
                code, h, body = R.call(
                    "POST", f"{route}/models/sv_gbm/frames/sv_fr")
                assert code == 429 and int(h["Retry-After"]) >= 1
                replies.append(body)
        finally:
            with g.cond:
                g.inflight = 0
            adm.CONTROLLER.reset()
    import json

    j = [json.loads(b) for b in replies[:2]]
    t = [json.loads(b) for b in replies[2:]]
    for a, b in zip(j, t):
        assert a["__meta"] == b["__meta"] and a["http_status"] == 429
        assert a["msg"].split(":")[0] == b["msg"].split(":")[0]


def _dl_weights(m):
    return [t.detach().cpu().numpy() for W, b in m.params_tree
            for t in (W, b)]


def test_rest_train_with_concurrent_predictions_equals_train_alone(env):
    import h2o3_tpu_torch as th

    T = env["T"]
    params = dict(hidden=[16, 16], epochs=1, seed=3, mini_batch_size=32)
    alone = th.DeepLearning(**params).train(y="y", training_frame=env["tf"])
    stop = threading.Event()
    served, errors = [], []

    def client(i):
        while not stop.is_set():
            try:
                T.json("POST", "/3/Predictions/models/sv_gbm/frames/sv_fr",
                       data={"predictions_frame": f"sv_c{i}"})
                served.append(i)
            except Exception as e:   # noqa: BLE001 — reported below
                errors.append(e)
                return

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    try:
        out = T.json("POST", "/3/ModelBuilders/deeplearning", data={
            "training_frame": "sv_fr", "response_column": "y",
            "hidden": "[16, 16]", "epochs": 1, "seed": 3,
            "mini_batch_size": 32})
        job = T.done_job(out)
        time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors and len(served) >= 8
    rest = th.DKV.get(job["dest"]["name"])
    for a, b in zip(_dl_weights(rest), _dl_weights(alone)):
        assert_bitwise(a, b)
    assert np.isfinite(rest.predict(env["tf"]).col("Y").data.numpy()).all()


def test_c35_listen_backlog_holds_concurrent_clients(env):
    """ROADMAP C35: the port's server listens with a backlog of 128 where
    the reference keeps Python's default of 5, so a burst of clients
    connecting at once is accepted rather than reset."""
    from http.server import ThreadingHTTPServer

    from h2o3_tpu_torch.api import server

    assert ThreadingHTTPServer.request_queue_size == 5
    assert server._HTTPServer.request_queue_size == 128
    T, n = env["T"], 32
    barrier = threading.Barrier(n)
    codes = [None] * n

    def ping(i):
        barrier.wait(timeout=30)
        codes[i] = T.call("GET", "/3/Ping")[0]

    threads = [threading.Thread(target=ping, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert codes == [200] * n
