"""h2o-r's wire transcript (tests/test_h2or_wire.py: h2o.init ->
h2o.importFile -> h2o.gbm -> predict, byte-encoded as RCurl sends it)
replayed against the port's server and the JAX package's, both in this
process on ephemeral ports (the port on the CPU). Every field the R
client reads is held equal between the two replies.

Reference: h2o-r/h2o-package/R/communication.R:49 (.h2o.doRawREST),
parse.R:62 (h2o.parseRaw), models.R:123 (.h2o.startModelJob),
models.R:679 (predict — v4 key/dest at top level), connection.R:465
(InitID session)."""

import json
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest

from torch_rest_support import JOB_DEADLINE_S, REQUEST_TIMEOUT_S, start_both


def _get(base, path, params=None):
    url = base + path
    if params:
        url += "?" + "&".join(f"{k}={urllib.parse.quote(str(v), safe='')}"
                              for k, v in params.items())
    with urllib.request.urlopen(url, timeout=REQUEST_TIMEOUT_S) as r:
        return json.loads(r.read())


def _post(base, path, params=None):
    body = "&".join(f"{k}={urllib.parse.quote(str(v), safe='')}"
                    for k, v in (params or {}).items()).encode()
    req = urllib.request.Request(
        base + path, data=body,
        headers={"Content-Type": "application/x-www-form-urlencoded"},
        method="POST")
    with urllib.request.urlopen(req, timeout=REQUEST_TIMEOUT_S) as r:
        return json.loads(r.read())


def _wait_job(base, job_key):
    t0 = time.time()
    while time.time() - t0 < JOB_DEADLINE_S:
        res = _get(base, f"/3/Jobs/{urllib.parse.quote(job_key, safe='')}")
        status = res["jobs"][0]["status"]
        if status in ("DONE", "FAILED", "CANCELLED"):
            assert status == "DONE", res["jobs"][0]
            return res["jobs"][0]
        time.sleep(0.05)
    raise AssertionError(f"job {job_key} past its deadline")


def _transcript(base, csv_path):
    """The R client's requests, in order; returns what it reads."""
    seen = {}
    cloud = _get(base, "/3/Cloud")
    seen["cloud"] = {k: type(cloud[k]).__name__ for k in
                     ("cloud_healthy", "cloud_size", "version", "nodes")}
    seen["cloud_healthy"] = cloud["cloud_healthy"]
    seen["version"] = cloud["version"]
    sid = _get(base, "/3/InitID")["session_key"]
    seen["session"] = bool(sid)
    imp = _get(base, "/3/ImportFiles", {"path": csv_path})
    seen["import"] = imp["destination_frames"]
    src = imp["destination_frames"][0]
    setup = _post(base, "/3/ParseSetup", {"source_frames": f'["{src}"]'})
    seen["setup"] = {k: setup[k] for k in (
        "number_columns", "column_names", "column_types", "parse_type",
        "separator", "check_header", "chunk_size", "destination_frame")}
    col_names = "[" + ",".join(f'"{c}"' for c in setup["column_names"]) + "]"
    col_types = "[" + ",".join(f'"{t}"' for t in setup["column_types"]) + "]"
    parse = _post(base, "/3/Parse", {
        "source_frames": f'["{src}"]', "destination_frame": "r_data.hex",
        "parse_type": setup["parse_type"], "separator": setup["separator"],
        "number_columns": setup["number_columns"], "single_quotes": "FALSE",
        "column_names": col_names, "column_types": col_types,
        "check_header": setup["check_header"], "delete_on_done": "TRUE",
        "chunk_size": setup.get("chunk_size", 4194304), "blocking": "FALSE"})
    seen["parse_dest"] = parse["destination_frame"]["name"]
    _wait_job(base, parse["job"]["key"]["name"])
    f0 = _get(base, "/3/Frames/r_data.hex")["frames"][0]
    seen["frame"] = (f0["rows"], [c["label"] for c in f0["columns"]],
                     [c["type"] for c in f0["columns"]],
                     [c["domain"] for c in f0["columns"]])
    builders = _get(base, "/3/ModelBuilders/gbm")
    params = builders["model_builders"]["gbm"]["parameters"]
    seen["builder"] = (any(p["name"] == "ntrees" for p in params),
                       all("type" in p for p in params))
    res = _post(base, "/3/ModelBuilders/gbm", {
        "training_frame": "r_data.hex", "response_column": "y",
        "ntrees": 5, "max_depth": 3, "seed": 1})
    job_key = res["job"]["key"]["name"]
    dest_key = res["job"]["dest"]["name"]
    _wait_job(base, job_key)
    m0 = _get(base, f"/3/Models/{dest_key}")["models"][0]
    seen["model"] = (m0["model_id"]["name"] == dest_key, m0["algo"],
                     m0["output"]["model_category"],
                     m0["output"]["names"], m0["output"]["domains"])
    seen["auc"] = m0["output"]["training_metrics"]["AUC"]
    pred = _post(base, f"/4/Predictions/models/{dest_key}/frames/r_data.hex")
    seen["v4"] = (bool(pred["key"]["name"]), bool(pred["dest"]["name"]),
                  pred["key"] == pred["job"]["key"])
    _wait_job(base, pred["key"]["name"])
    pfr = _get(base, f"/3/Frames/{pred['dest']['name']}",
                {"row_count": 800})["frames"][0]
    seen["pred_labels"] = [c["label"] for c in pfr["columns"]]
    seen["pred"] = [c["data"] for c in pfr["columns"]]
    req = urllib.request.Request(base + "/3/InitID", method="DELETE")
    with urllib.request.urlopen(req, timeout=REQUEST_TIMEOUT_S) as r:
        seen["end_status"] = r.status
    return seen


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    rng = np.random.default_rng(7)
    p = tmp_path_factory.mktemp("rwire") / "r_data.csv"
    with open(p, "w") as f:
        f.write("x1,x2,g,y\n")
        for i in range(800):
            x1, x2 = rng.normal(), rng.normal()
            g = "abc"[i % 3]
            pr = 1 / (1 + np.exp(-(1.2 * x1 - x2 + (g == "a"))))
            f.write(f"{x1:.5f},{x2:.5f},{g},{'YN'[int(rng.random() < pr)]}\n")
    return str(p)


def test_h2or_transcript_port_equals_reference(cl, csv_path, monkeypatch):
    js, ts = start_both(monkeypatch)
    try:
        j = _transcript(f"http://127.0.0.1:{js.port}", csv_path)
        t = _transcript(f"http://127.0.0.1:{ts.port}", csv_path)
    finally:
        js.stop()
        ts.stop()
    for k in ("cloud", "cloud_healthy", "version", "session", "import",
              "setup", "parse_dest", "frame", "builder", "model", "v4",
              "pred_labels", "end_status"):
        assert j[k] == t[k], (k, j[k], t[k])
    assert abs(j["auc"] - t["auc"]) <= 1e-6
    assert j["pred"][0] == t["pred"][0]                 # labels
    for a, b in zip(j["pred"][1:], t["pred"][1:]):      # to ROADMAP C2
        np.testing.assert_allclose(np.asarray(b, float),
                                   np.asarray(a, float), atol=1e-5)
