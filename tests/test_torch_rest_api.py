"""The port's REST server against the JAX package's: both servers run in
this process on ephemeral ports (the port on the CPU), take the same
requests on the same seeded CSV, and their replies are compared
(mirrors tests/test_rest_api.py and tests/test_flow_ui.py)."""

import json
import os

import numpy as np
import pytest

from torch_port_support import assert_bitwise
from torch_rest_support import Rest, start_both, write_api_csv

GBM = dict(ntrees=3, max_depth=3, nbins=16, seed=1)


@pytest.fixture(scope="module")
def env(cl, tmp_path_factory):
    csv = write_api_csv(tmp_path_factory.mktemp("rest") / "api_test.csv")
    with pytest.MonkeyPatch.context() as mp:
        js, ts = start_both(mp)
        J, T = Rest(js.port), Rest(ts.port)
        try:
            frames = {n: R.import_parse(csv)[1] for n, R in
                      (("jax", J), ("torch", T))}
            models = {n: R.train("gbm", training_frame=frames[n],
                                 response_column="y", **GBM)
                      for n, R in (("jax", J), ("torch", T))}
            yield {"J": J, "T": T, "csv": csv, "frames": frames,
                   "models": models}
        finally:
            js.stop()
            ts.stop()


def test_route_table_equals_the_reference():
    from h2o3_tpu.api import routes_ext as jext
    from h2o3_tpu.api import server as jsrv

    from h2o3_tpu_torch.api import routes_ext, server

    ours = {(m, p) for m, p, _h, _s in server.ROUTES}
    ref = {(m, p) for m, p, _h, _s in jsrv.ROUTES}
    assert ours == ref
    assert len(routes_ext.EXTRA_ROUTES) == len(jext.EXTRA_ROUTES) == 83
    assert all(h is not None for _m, _p, h, _s in server.ROUTES)


def test_cloud_and_about(env):
    J, T = env["J"], env["T"]
    jc, tc = J.json("GET", "/3/Cloud"), T.json("GET", "/3/Cloud")
    assert set(jc) == set(tc)
    assert set(jc["nodes"][0]) == set(tc["nodes"][0])
    assert tc["cloud_size"] == 1 and tc["cloud_healthy"]
    assert tc["cloud_status"] == "HEALTHY" and tc["version"] == jc["version"]
    assert tc["nodes"][0]["h2o"] == "cpu"            # the device it serves
    ja, ta = J.json("GET", "/3/About"), T.json("GET", "/3/About")
    assert [e["name"] for e in ja["entries"]] == \
        [e["name"] for e in ta["entries"]]
    assert T.json("GET", "/3/Ping")["status"] == "running"
    code, _h, _b = T.call("HEAD", "/3/Cloud")
    assert code == 200


def test_parse_setup_frames_and_summary(env):
    J, T, csv = env["J"], env["T"], env["csv"]
    js, ts = (R.json("POST", "/3/ParseSetup", data={"source_frames": [csv]})
              for R in (J, T))
    for k in ("column_names", "column_types", "separator", "check_header",
              "destination_frame", "number_columns"):
        assert js[k] == ts[k], k
    jk, tk = env["frames"]["jax"], env["frames"]["torch"]
    q = {"row_count": 320}
    jf = J.json("GET", f"/3/Frames/{jk}", query=q)["frames"][0]
    tf = T.json("GET", f"/3/Frames/{tk}", query=q)["frames"][0]
    assert jf["rows"] == tf["rows"] == 320
    assert jf["column_names"] == tf["column_names"]
    for jc, tc in zip(jf["columns"], tf["columns"]):
        assert (jc["type"], jc["domain"], jc["missing_count"]) == \
            (tc["type"], tc["domain"], tc["missing_count"])
        assert jc["data"] == tc["data"], jc["label"]
    js = J.json("GET", f"/3/Frames/{jk}/summary")["frames"][0]
    ts = T.json("GET", f"/3/Frames/{tk}/summary")["frames"][0]
    for jc, tc in zip(js["columns"], ts["columns"]):
        for k in ("mean", "sigma", "mins", "maxs", "zero_count",
                  "percentiles"):
            np.testing.assert_allclose(
                np.asarray(tc[k] if tc[k] is not None else np.nan, float),
                np.asarray(jc[k] if jc[k] is not None else np.nan, float),
                rtol=1e-6, atol=1e-6, err_msg=f"{jc['label']}.{k}")
    # light and the listing
    assert T.json("GET", f"/3/Frames/{tk}/light")["frames"][0]["rows"] == 320
    assert tk in [f["frame_id"]["name"]
                  for f in T.json("GET", "/3/Frames")["frames"]]


def test_download_dataset_bytes_equal(env):
    got = []
    for n, R in (("jax", env["J"]), ("torch", env["T"])):
        code, h, body = R.call("GET", "/3/DownloadDataset",
                               query={"frame_id": env["frames"][n]})
        assert code == 200
        got.append(body)
    assert got[0] == got[1]


def test_jobs_list_get_and_cancel(env):
    T = env["T"]
    jobs = T.json("GET", "/3/Jobs")["jobs"]
    assert jobs and all(j["status"] in ("DONE", "RUNNING", "CREATED",
                                        "FAILED", "CANCELLED")
                        for j in jobs)
    jid = jobs[0]["key"]["name"]
    assert T.json("GET", f"/3/Jobs/{jid}")["jobs"][0]["key"]["name"] == jid
    # a long train, cancelled mid-flight, ends CANCELLED (or DONE if it
    # won the race); the cancel reply has the reference's shape
    out = T.json("POST", "/3/ModelBuilders/gbm", data={
        "training_frame": env["frames"]["torch"], "response_column": "y",
        "ntrees": 500, "max_depth": 3, "nbins": 16, "seed": 1})
    jid = out["job"]["key"]["name"]
    assert T.json("POST", f"/3/Jobs/{jid}/cancel") == {
        "__meta": {"schema_version": 3, "schema_name": "JobsV3",
                   "schema_type": "Iced"}, "jobs": []}
    assert T.wait_job(jid)["status"] in ("CANCELLED", "DONE")
    for R in (env["J"], T):
        err = R.json("GET", "/3/Jobs/nope", status=404)
        assert err["__meta"]["schema_name"] == "H2OErrorV3"


def _rapids_value(R, out):
    if "key" in out:
        key = out["key"]["name"]
        fr = R.json("GET", f"/3/Frames/{key}",
                    query={"row_count": 1000})["frames"][0]
        return [c["data"] for c in fr["columns"]]
    return out.get("scalar", out.get("string"))


def test_rapids_over_http_equals_in_process(env):
    import h2o3_tpu.rapids as jr

    import h2o3_tpu_torch.rapids as tr

    J, T = env["J"], env["T"]
    stmts = ["(mean (cols {k} [1]) 0 0)",
             "(tmp= rfilt (rows {k} (> (cols {k} [1]) 0)))",
             "(nrow rfilt)",
             "(cols (* (cols {k} [1]) 2) [0])"]
    got = {}
    for n, R, pkg in (("jax", J, jr), ("torch", T, tr)):
        k = env["frames"][n]
        sess = pkg.Session(f"inproc_{n}")
        vals = []
        for s in stmts:
            ast = s.format(k=k)
            out = R.json("POST", "/99/Rapids",
                         data={"ast": ast, "session_id": "rest_s"})
            rest = _rapids_value(R, out)
            inproc = pkg.exec_rapids(ast, sess)
            if hasattr(inproc, "names"):
                inproc = [c for c in (inproc.col(nm).to_numpy()
                                      for nm in inproc.names)]
                np.testing.assert_array_equal(
                    np.asarray(rest, np.float64),
                    np.asarray(inproc, np.float64))
            else:
                assert rest == float(inproc)
            vals.append(rest)
        got[n] = vals
    for a, b in zip(got["jax"], got["torch"]):
        np.testing.assert_allclose(np.asarray(b, float),
                                   np.asarray(a, float), rtol=1e-6)


def test_gbm_and_glm_models_over_rest(env):
    J, T = env["J"], env["T"]
    jm = J.json("GET", f"/3/Models/{env['models']['jax']}")["models"][0]
    tm = T.json("GET", f"/3/Models/{env['models']['torch']}")["models"][0]
    assert jm["algo"] == tm["algo"] == "gbm"
    assert jm["output"]["model_category"] == tm["output"]["model_category"]
    assert jm["output"]["names"] == tm["output"]["names"]
    assert jm["output"]["domains"] == tm["output"]["domains"]
    jp = {p["name"]: p["actual_value"] for p in jm["parameters"]}
    tp = {p["name"]: p["actual_value"] for p in tm["parameters"]}
    for k in ("ntrees", "max_depth", "nbins", "seed", "learn_rate"):
        assert jp[k] == tp[k], k
    assert abs(jm["output"]["training_metrics"]["AUC"]
               - tm["output"]["training_metrics"]["AUC"]) <= 1e-6
    aucs = []
    for n, R in (("jax", J), ("torch", T)):
        mid = R.train("glm", training_frame=env["frames"][n],
                      response_column="y", family="binomial", lambda_=0)
        m = R.json("GET", f"/3/Models/{mid}")["models"][0]
        assert m["output"]["domains"][-1] == ["NO", "YES"]
        aucs.append(m["output"]["training_metrics"]["AUC"])
    assert abs(aucs[0] - aucs[1]) <= 1e-6
    assert env["models"]["torch"] in [
        m["model_id"]["name"] for m in T.json("GET", "/3/Models")["models"]]


def _pred_arrays(R, key):
    fr = R.json("GET", f"/3/Frames/{key}",
                query={"row_count": 1000})["frames"][0]
    return {c["label"]: c["data"] for c in fr["columns"]}


def test_predictions_sync_async_bitwise(env):
    import h2o3_tpu_torch as th

    J, T = env["J"], env["T"]
    tk, tmid = env["frames"]["torch"], env["models"]["torch"]
    v3 = T.json("POST", f"/3/Predictions/models/{tmid}/frames/{tk}",
                data={"predictions_frame": "p_v3"})
    assert v3["predictions_frame"]["name"] == "p_v3"
    assert v3["model_metrics"][0]["__meta"]["schema_name"] == \
        "ModelMetricsBinomialV3"
    v4 = T.json("POST", f"/4/Predictions/models/{tmid}/frames/{tk}")
    assert v4["key"] == v4["job"]["key"] and v4["dest"] == v4["job"]["dest"]
    T.done_job(v4)
    a = th.DKV.get("p_v3")
    b = th.DKV.get(v4["dest"]["name"])
    m, fr = th.DKV.get(tmid), th.DKV.get(tk)
    ref = m.predict(fr)
    for nm in ("NO", "YES"):
        assert_bitwise(a.col(nm).data.numpy(), b.col(nm).data.numpy(), nm)
        assert_bitwise(a.col(nm).data.numpy(), ref.col(nm).data.numpy(), nm)
    assert list(a.col("predict").values()) == list(ref.col("predict")
                                                   .values())
    # the JAX server's predictions, to the bars of ROADMAP C2
    jk, jmid = env["frames"]["jax"], env["models"]["jax"]
    jp = J.json("POST", f"/3/Predictions/models/{jmid}/frames/{jk}")
    jv = _pred_arrays(J, jp["predictions_frame"]["name"])
    tv = _pred_arrays(T, "p_v3")
    assert jv["predict"] == tv["predict"]
    np.testing.assert_allclose(np.asarray(tv["YES"], float),
                               np.asarray(jv["YES"], float), atol=1e-5)
    assert abs(jp["model_metrics"][0]["AUC"]
               - v3["model_metrics"][0]["AUC"]) <= 1e-6


def test_error_replies_match(env):
    J, T = env["J"], env["T"]
    cases = [("GET", "/3/Frames/no_such_frame", None, 404),
             ("GET", "/3/Models/no_such_model", None, 404),
             ("GET", "/3/NoSuchRoute", None, 404),
             ("POST", "/3/ModelBuilders/nosuchalgo",
              {"training_frame": "x"}, 404),
             ("POST", "/3/ModelBuilders/gbm", {"ntrees": 2}, 412),
             ("POST", "/3/ParseStream", {"destination_frame":
                                         env["frames"]["torch"]}, 400)]
    for method, path, data, status in cases:
        jo = J.json(method, path, data=data, status=status)
        to = T.json(method, path, data=data, status=status)
        assert jo["__meta"]["schema_name"] == to["__meta"]["schema_name"]
        assert jo["http_status"] == to["http_status"] == status
        assert jo["msg"] == to["msg"], (path, jo["msg"], to["msg"])


def test_flow_page_and_metadata(env):
    import h2o3_tpu.api as japi

    import h2o3_tpu_torch.api as tapi

    T = env["T"]
    ref = open(os.path.join(os.path.dirname(japi.__file__), "flow.html"),
               "rb").read()
    assert open(os.path.join(os.path.dirname(tapi.__file__), "flow.html"),
                "rb").read() == ref
    for path in ("/", "/flow/index.html"):
        code, h, body = T.call("GET", path)
        assert code == 200 and h["Content-Type"].startswith("text/html")
        assert body == ref
    eps = T.json("GET", "/3/Metadata/endpoints")["endpoints"]
    jeps = env["J"].json("GET", "/3/Metadata/endpoints")["endpoints"]
    assert [(e["http_method"], e["url_pattern"]) for e in eps] == \
        [(e["http_method"], e["url_pattern"]) for e in jeps]
    assert T.json("GET", "/3/Metadata/schemas/CloudV3")["schemas"]


def test_create_split_frame_and_network_test(env):
    T = env["T"]
    body = T.json("POST", "/3/CreateFrame", data={
        "rows": "200", "cols": "3", "seed": "7", "dest": "cf_test"})
    assert body["job"]["status"] == "DONE"
    body = T.json("POST", "/3/SplitFrame",
                  data={"dataset": "cf_test", "ratios": "[0.5]"})
    keys = [k["name"] for k in body["destination_frames"]]
    assert sum(T.json("GET", f"/3/Frames/{k}/light")["frames"][0]["rows"]
               for k in keys) == 200
    bench = T.json("GET", "/3/NetworkTest", query={"size": "64"})["bench"]
    assert bench["matmul_gflops"] > 0 and bench["psum_latency_us"] > 0
    assert "no collective" in bench["psum_probe"]


def test_thin_client_round_trip(env, monkeypatch):
    import webbrowser

    from h2o3_tpu_torch import client

    import h2o3_tpu_torch as th

    port = int(env["T"].base.rsplit(":", 1)[1])
    assert th.init(port=port) is client
    assert client.cluster_status()["cloud_size"] == 1
    fr = client.import_file(env["csv"], destination_frame="client.hex")
    assert fr.nrows == 320 and fr.names == ["g", "x", "y"]
    m = client.train("gbm", y="y", training_frame=fr, **GBM)
    assert m.auc > 0.7
    pred = m.predict(fr)
    assert pred.nrows == 320 and "predict" in pred.names
    with pytest.raises(client.H2OServerError):
        client.train("nosuchalgo", y="y",
                     training_frame=client.RemoteFrame("nope"))
    with pytest.raises(FileNotFoundError):
        client.import_file("/does/not/exist.csv")
    assert json.loads(json.dumps(th.cluster_info()))["cloud_size"] == 1
    opened = []
    monkeypatch.setattr(webbrowser, "open", opened.append)
    assert th.flow() == env["T"].base + "/flow/index.html" == opened[0]
