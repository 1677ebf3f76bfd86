"""The port's observability plane against the JAX package's: the metrics
registry and /3/Metrics, spans and /3/Trace, the flight recorder, the
lifecycle phases and compile ledger on /3/Runtime, the profiler routes,
TLS and the pluggable login (mirrors the one-process cases of
tests/test_obs.py, tests/test_observability.py and
tests/test_runtime_phases.py). Both servers run in this process on
ephemeral ports, the port on the CPU."""

import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from torch_port_support import both_frames, train_cols
from torch_rest_support import Rest, start_both

_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+=\"[^\"]*\""
    r"(,[a-zA-Z0-9_]+=\"[^\"]*\")*\})? -?\S+$")


@pytest.fixture(scope="module")
def env(cl):
    import h2o3_tpu_torch as th

    with pytest.MonkeyPatch.context() as mp:
        js, ts = start_both(mp)
        try:
            jf, tf = both_frames(train_cols(n=256))
            for f in (jf, tf):
                f._key = type(f._key)("obs_fr")
                f.install()
            tm = th.GBM(ntrees=3, max_depth=3, nbins=16, seed=1).train(
                y="y", training_frame=tf)
            tm.install()
            yield {"J": Rest(js.port), "T": Rest(ts.port), "tm": tm}
        finally:
            js.stop()
            ts.stop()


def _series(R):
    out = R.json("GET", "/3/Metrics", query={"format": "json"})
    return {m["name"]: m for m in out["series"]}


def test_registry_names_and_types_equal_the_reference():
    from h2o3_tpu.obs import metrics as jm

    from h2o3_tpu_torch.obs import metrics as tm

    # the reference's series, plus the row exchange's counters (no
    # counterpart there), each a counter
    assert [n for n in tm.REGISTRY.names()
            if n not in tm.PORT_ONLY_SERIES] == jm.REGISTRY.names()
    for n in tm.PORT_ONLY_SERIES:
        assert tm.REGISTRY.get(n).mtype == "counter", n
    for n in jm.REGISTRY.names():
        a, b = tm.REGISTRY.get(n), jm.REGISTRY.get(n)
        assert (a.mtype, a.agg, a.buckets) == (b.mtype, b.agg, b.buckets), n
    with pytest.raises(ValueError):
        tm.REGISTRY.counter("h2o3_rest_requests_total", "dup")
    tm.inc("h2o3_no_such_series")                # never raises
    # a broken collector costs its own samples, not the scrape
    m = tm.REGISTRY.get("h2o3_oplog_current_seq")
    saved = m._fn
    m._fn = lambda: 1 / 0
    try:
        assert {s["name"] for s in tm.REGISTRY.snapshot()} == \
            set(tm.REGISTRY.names())
    finally:
        m._fn = saved


def test_metrics_route_matches_the_reference(env):
    J, T = env["J"], env["T"]
    for R in (J, T):
        R.json("GET", "/3/Cloud")
        R.json("GET", "/3/Frames")
        R.json("GET", "/3/Frames/no_such", status=404)
    from h2o3_tpu_torch.obs.metrics import PORT_ONLY_SERIES

    js, ts = _series(J), _series(T)
    assert set(js) == set(ts) - set(PORT_ONLY_SERIES)
    assert set(PORT_ONLY_SERIES) <= set(ts)
    for name in js:
        assert js[name]["type"] == ts[name]["type"], name
        jl = {tuple(sorted(s["labels"])) for s in js[name]["samples"]}
        tl = {tuple(sorted(s["labels"])) for s in ts[name]["samples"]}
        if jl and tl and name.startswith("h2o3_rest"):
            assert jl == tl, name
    for m in ts.values():
        if m["type"] == "histogram":
            for s in m["samples"]:
                assert set(s["quantiles"]) == {"p50", "p95", "p99"}
    code, h, body = T.call("GET", "/3/Metrics")
    assert code == 200 and h["Content-Type"].startswith(
        "text/plain; version=0.0.4")
    for ln in body.decode().splitlines():
        if ln and not ln.startswith("#"):
            assert _PROM_LINE.match(ln), ln


def test_request_counter_counts_the_requests_made(env):
    T = env["T"]

    def total():
        s = _series(T)["h2o3_rest_requests_total"]["samples"]
        return sum(x["value"] for x in s)

    before = total()
    for _ in range(5):
        T.json("GET", "/3/Ping")
    T.json("GET", "/3/Frames/no_such", status=404)
    # the six requests, plus the first scrape (counted as it ends)
    assert total() - before == 7
    four = [x for x in _series(T)["h2o3_rest_requests_total"]["samples"]
            if x["labels"] == {"status": "4xx"}]
    assert four and four[0]["value"] >= 1


def _trace(R, headers):
    """The request's trace once its ingress span has ended: the handler
    ends it after the reply is out, so the client may ask first."""
    tid = headers.get("X-H2O3-Trace-Id")
    assert tid
    t0 = time.time()
    while True:
        out = R.json("GET", f"/3/Trace/{tid}")
        if any(sp["name"] == "ingress" for sp in out["spans"]):
            break
        assert time.time() - t0 < 10, out["spans"]
        time.sleep(0.01)
    assert out["__meta"]["schema_name"] == "TraceV3"
    return out


def _names(node):
    return [node["name"]] + [n for c in node["children"] for n in _names(c)]


def test_trainer_and_rapids_span_trees(env):
    J, T = env["J"], env["T"]
    code, h, body = T.call("POST", "/3/ModelBuilders/gbm", data={
        "training_frame": "obs_fr", "response_column": "y", "ntrees": 2,
        "max_depth": 2, "nbins": 16, "seed": 1})
    assert code == 200
    T.done_job(json.loads(body))
    tr = _trace(T, h)
    root = tr["tree"][0]
    assert root["name"] == "ingress" and root["parent_id"] is None
    assert root["attrs"]["path"] == "/3/ModelBuilders/gbm"
    assert root["attrs"]["status"] == 200
    # the h2o3_rapids spans: the same statement's tree on both servers
    ast = "(tmp= obs_t (* (cols obs_fr [0]) 2))"
    trees = []
    for R in (J, T):
        code, h, _b = R.call("POST", "/99/Rapids",
                             data={"ast": ast, "session_id": "obs_s"})
        assert code == 200
        trees.append(_names(_trace(R, h)["tree"][0]))
    assert trees[1][0] == "ingress" and "parse" in trees[1]
    assert set(trees[1]) <= set(trees[0]) | {"plan", "fused_dispatch",
                                            "execute", "flush", "reply"}
    assert trees[1][:2] == trees[0][:2]
    lst = T.json("GET", "/3/Trace")["traces"]
    assert lst and all("trace_id" in x for x in lst)
    T.json("GET", "/3/Trace/nope", status=404)


def test_scoring_request_spans(env):
    T, tm = env["T"], env["tm"]
    code, h, _b = T.call("POST",
                         f"/3/Predictions/models/{tm.key}/frames/obs_fr")
    assert code == 200
    names = _names(_trace(T, h)["tree"][0])
    for want in ("ingress", "score", "queue_wait", "pack", "dispatch",
                 "fetch", "finish", "metrics", "schema", "reply"):
        assert want in names, (want, names)
    sm = T.json("GET", "/3/ScoringMetrics")
    from h2o3_tpu_torch import pipeline
    from h2o3_tpu_torch.rapids import fusion

    assert set(sm) >= {"models", "admission", "compile_cache", "data_plane",
                       "dispatches", "rapids", "pipeline"}
    assert sm["rapids"] == json.loads(json.dumps(fusion.stats()))
    assert set(sm["pipeline"]) == set(pipeline.stats())
    j = env["J"].json("GET", "/3/ScoringMetrics")
    assert set(j) == set(sm)
    # the reference's data-plane counters, plus the row exchange's
    assert set(j["data_plane"]) == set(sm["data_plane"]) - {
        "exchanged_rows", "exchanged_bytes", "dl_batch_rows"}


def test_flight_records(env, tmp_path, monkeypatch):
    from h2o3_tpu.obs import flight as jflight

    from h2o3_tpu_torch.obs import flight

    monkeypatch.setenv("H2O_TPU_OBS_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("H2O_TPU_OBS_FLIGHT_KEEP", "2")
    path = flight.record_flight("drill", extra={"why": "test"})
    assert path and os.path.dirname(path) == str(tmp_path)
    rec = json.loads(open(path).read())
    jpath = jflight.record_flight("drill_ref")
    jrec = json.loads(open(jpath).read())
    assert set(rec) - {"extra"} == set(jrec)
    assert rec["process_index"] == 0 and rec["extra"] == {"why": "test"}
    for i in range(3):
        flight.record_flight(f"gc{i}")
    T = env["T"]
    lst = T.json("GET", "/3/FlightRecords")
    assert lst["count"] == 2 == len(os.listdir(tmp_path))
    name = lst["records"][0]["name"]
    code, _h, body = T.call("GET", f"/3/FlightRecords/{name}")
    assert code == 200 and json.loads(body)["reason"].startswith("gc")
    T.json("GET", "/3/FlightRecords/..%2Fetc%2Fpasswd", status=404)


def test_runtime_ledger_lists_the_ports_builds(env, tmp_path, monkeypatch):
    from h2o3_tpu.obs import phases as jphases

    from h2o3_tpu_torch import native
    from h2o3_tpu_torch.memory import budget
    from h2o3_tpu_torch.obs import compiles, phases

    assert phases.PHASES == jphases.PHASES
    assert compiles.FAMILIES >= {"scoring", "rapids", "pipeline",
                                 "artifact"}
    T, tm = env["T"], env["tm"]
    # an artifact export (torch.export programs) and a fresh g++ build of
    # the host library both land in the ledger
    T.json("POST", f"/3/Artifacts/models/{tm.key}",
           data={"dir": str(tmp_path / "art"), "buckets": "[256]"})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.build()
    code, h, body = T.call("GET", "/3/Runtime")
    assert code == 200 and h.get("X-H2O3-Trace-Id")
    out = json.loads(body)
    assert out["__meta"]["schema_name"] == "RuntimeV3"
    for p in ("backend_init", "device_discovery", "server_start"):
        assert p in out["phase_report"], p
    fam = out["compile_families"]
    assert fam["artifact"]["compiles"] >= 1 and fam["kernel"]["compiles"] >= 1
    progs = {r["program"] for r in compiles.ledger_rows()}
    assert "g++ host library" in progs and "forest_b256" in progs
    assert all("signature" in r and "ms" in r
               for r in out["slowest_compiles"])
    assert set(out["memory"]) == set(budget.snapshot())
    assert out["processes"][0]["proc"] == 0
    one = T.json("GET", "/3/Runtime", query={"slowest": 1})
    assert len(one["slowest_compiles"]) <= 1
    j = env["J"].json("GET", "/3/Runtime")
    assert set(j) == set(out)


def test_runtime_counts_program_cache_hits(env):
    """A second identical request finds its bucket program in the
    session's cache: /3/Runtime's scoring family shows the hit."""
    T, tm = env["T"], env["tm"]

    def hits():
        fam = T.json("GET", "/3/Runtime")["compile_families"]
        return fam.get("scoring", {}).get("hits_memory", 0)

    path = f"/3/Predictions/models/{tm.key}/frames/obs_fr"
    T.json("POST", path)
    before = hits()
    T.json("POST", path)
    assert hits() >= before + 1


def test_profiler_routes_and_gauges(env, tmp_path):
    T = env["T"]
    prof = T.json("GET", "/3/Profiler")
    assert prof["nodes"] == []            # no card: no device gauges
    pdir = str(tmp_path / "prof")
    out = T.json("POST", "/3/Profiler/start", data={"dir": pdir})
    assert out["status"] == "capturing"
    T.json("POST", "/3/Profiler/start", status=409)
    T.json("POST", "/99/Rapids", data={"ast": "(* (cols obs_fr [0]) 3)",
                                       "session_id": "prof"})
    out = T.json("POST", "/3/Profiler/stop")
    assert out["status"] == "stopped" and out["captured_ms"] >= 0
    trace = json.loads(open(out["trace"]).read())
    assert trace["traceEvents"]
    T.json("POST", "/3/Profiler/stop", status=400)
    tl = T.json("GET", "/3/Timeline")["events"]
    assert {"rest", "profiler"} <= {e["kind"] for e in tl}


def test_timeline_kinds_and_reserved_keys():
    from h2o3_tpu_torch.utils import timeline

    timeline.record("flight", "x", time_ms=1)
    ev = timeline.events(1)[0]
    assert ev["kind"] == "flight" and ev["what"] == "x"
    assert ev["meta_time_ms"] == 1 and ev["time_ms"] > 1
    assert "rest" in timeline.KINDS and "self_benchmark" in timeline.KINDS


def test_tls_rest_bind(env, tmp_path):
    import ssl
    import urllib.request

    from h2o3_tpu_torch.api.server import start_server

    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-keyout", str(key), "-out", str(cert), "-days", "1",
                    "-nodes", "-subj", "/CN=localhost"],
                   check=True, capture_output=True, timeout=60)
    srv = start_server(port=0, ssl_certfile=str(cert), ssl_keyfile=str(key))
    try:
        assert srv.scheme == "https"
        sctx = ssl.create_default_context()
        sctx.check_hostname = False
        sctx.verify_mode = ssl.CERT_NONE
        with urllib.request.urlopen(f"https://127.0.0.1:{srv.port}/3/Cloud",
                                    context=sctx, timeout=30) as r:
            assert json.loads(r.read())["cloud_healthy"] is True
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/3/Cloud",
                                   timeout=5)
    finally:
        srv.stop()


def test_pluggable_login_module(env, monkeypatch):
    import base64

    from h2o3_tpu_torch.api.server import start_server

    mod = types.ModuleType("_torch_test_authmod")
    mod.check = lambda user, pw: user == "ldapuser" and pw == "s3cret"
    monkeypatch.setitem(sys.modules, "_torch_test_authmod", mod)
    monkeypatch.setenv("H2O_TPU_LOGIN_MODULE", "_torch_test_authmod:check")
    srv = start_server(port=0)
    try:
        R = Rest(srv.port)

        def get(creds=None):
            hdr = {} if creds is None else {
                "Authorization": "Basic "
                + base64.b64encode(creds.encode()).decode()}
            return R.call("GET", "/3/Cloud", headers=hdr)[0]

        assert get() == 401 and get("ldapuser:wrong") == 401
        assert get("ldapuser:s3cret") == 200
    finally:
        srv.stop()


def test_one_process_control_plane():
    from h2o3_tpu_torch.api.server import assume_coordination
    from h2o3_tpu_torch.parallel import (ckpt, distributed, oplog,
                                         supervisor, watchdog)

    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    assert not oplog.active() and oplog.broadcast("train", {}) is None
    with oplog.turn(None):
        pass
    assert supervisor.state() == supervisor.HEALTHY
    assert watchdog.MAX_ATTEMPTS == 5 and watchdog.enabled()
    with pytest.raises(oplog.ElectionLost):
        assume_coordination(port=0)
    assert ckpt.latest_seq() is None and ckpt.job_progress_records() == []


def test_job_ckpt_knob_arms_nothing(env, monkeypatch, tmp_path):
    """Durable job progress has landed: the knob now arms it on the
    builders that resume (test_torch_job_resume.py drives it); a REST
    train that completes leaves no progress behind and reads
    auto_recoverable False once DONE."""
    import h2o3_tpu_torch as th
    from h2o3_tpu_torch.parallel import ckpt

    monkeypatch.setenv("H2O_TPU_JOB_CKPT_ITERS", "1")
    monkeypatch.setenv("H2O_TPU_OPLOG_CKPT_DIR", str(tmp_path))
    assert ckpt.job_ckpt_iters() == 1
    assert {a for a, cls in th.BUILDERS.items()
            if cls.supports_iteration_resume} == {
        "gbm", "drf", "xgboost", "glm", "kmeans", "deeplearning"}
    T = env["T"]
    out = T.json("POST", "/3/ModelBuilders/gbm", data={
        "training_frame": "obs_fr", "response_column": "y", "ntrees": 2,
        "max_depth": 2, "nbins": 16, "seed": 1})
    job = T.done_job(out)
    assert job["auto_recoverable"] is False
    assert ckpt.job_progress_records() == []
    assert not list(tmp_path.iterdir())
    assert np.isfinite(T.json("GET", f"/3/Models/{job['dest']['name']}")
                       ["models"][0]["output"]["training_metrics"]["AUC"])
