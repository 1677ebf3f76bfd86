"""The port's extended REST routes (api/routes_ext.py) against the JAX
package's: the same requests on both servers (ephemeral ports, the port
on the CPU) over the same seeded frame (mirrors the 23 tests of
tests/test_routes_ext.py)."""

import pickle
import re

import numpy as np
import pytest

from torch_port_support import assert_bitwise, both_frames
from torch_rest_support import Rest, start_both


@pytest.fixture(scope="module")
def env(cl):
    from h2o3_tpu.models.tree.gbm import GBM as JGBM

    import h2o3_tpu_torch as th

    rng = np.random.default_rng(3)
    n = 384
    cols = {"x": (rng.normal(size=n), None), "x2": (rng.normal(size=n), None),
            "g": (np.array(["u", "v", "w"])[rng.integers(0, 3, n)], "enum"),
            "y": (np.where(rng.random(n) > 0.5, "Y", "N"), "enum")}
    with pytest.MonkeyPatch.context() as mp:
        js, ts = start_both(mp)
        try:
            jf, tf = both_frames(cols)
            for f in (jf, tf):
                f._key = type(f._key)("ext_fr")
                f.install()
            kw = dict(ntrees=5, max_depth=3, nbins=16, seed=1)
            jm = JGBM(**kw).train(x=["x", "x2", "g"], y="y",
                                  training_frame=jf)
            tm = th.GBM(**kw).train(x=["x", "x2", "g"], y="y",
                                    training_frame=tf)
            jm.install()
            tm.install()
            yield {"J": Rest(js.port), "T": Rest(ts.port), "jf": jf,
                   "tf": tf, "jm": jm, "tm": tm}
        finally:
            js.stop()
            ts.stop()


def _both(env, method, path, **kw):
    return (env["J"].json(method, path.format(m=env["jm"].key), **kw),
            env["T"].json(method, path.format(m=env["tm"].key), **kw))


def test_route_diff_vs_the_jax_package_empty():
    from h2o3_tpu.api.server import ROUTES as JROUTES

    from h2o3_tpu_torch.api.server import ROUTES

    def norm(routes):
        return {(m, re.sub(r"\{[^}]+\}", "{}", p)) for m, p, _h, _s in routes}

    assert norm(JROUTES) - norm(ROUTES) == set()
    assert norm(ROUTES) - norm(JROUTES) == set()


def test_capabilities(env):
    j, t = _both(env, "GET", "/3/Capabilities")
    # the first entry names the runtime: h2o3_tpu against h2o3_tpu_torch
    assert [c["name"] for c in j["capabilities"]][1:] == \
        [c["name"] for c in t["capabilities"]][1:]
    assert t["capabilities"][0]["name"] == "h2o3_tpu_torch"
    j, t = _both(env, "GET", "/3/Capabilities/API")
    assert len(t["capabilities"]) == len(j["capabilities"]) > 100
    assert env["T"].json("GET", "/3/Capabilities/Core")["capabilities"]


def test_frame_columns_family(env):
    j, t = _both(env, "GET", "/3/Frames/ext_fr/columns")
    assert t["frames"][0]["column_names"] == j["frames"][0]["column_names"] \
        == ["x", "x2", "g", "y"]
    j, t = _both(env, "GET", "/3/Frames/ext_fr/columns/x")
    assert t["frames"][0]["columns"][0]["data"] == \
        j["frames"][0]["columns"][0]["data"]
    j, t = _both(env, "GET", "/3/Frames/ext_fr/columns/g/domain")
    assert t["domain"] == j["domain"] == [["u", "v", "w"]]
    j, t = _both(env, "GET", "/3/Frames/ext_fr/columns/x/summary")
    np.testing.assert_allclose(t["frames"][0]["columns"][0]["percentiles"],
                               j["frames"][0]["columns"][0]["percentiles"],
                               rtol=1e-6)
    t = env["T"].json("GET", "/3/FrameChunks/ext_fr")
    assert sum(c["row_count"] for c in t["chunks"]) == 384


def test_frame_export_and_binary_save_load(env, tmp_path):
    import h2o3_tpu_torch as th

    paths = [tmp_path / "j.csv", tmp_path / "t.csv"]
    env["J"].json("POST", "/3/Frames/ext_fr/export",
                  data={"path": str(paths[0]), "force": True})
    env["T"].json("POST", "/3/Frames/ext_fr/export",
                  data={"path": str(paths[1]), "force": True})
    assert paths[1].read_bytes() == paths[0].read_bytes()
    assert paths[1].read_text().startswith("x,")
    d = tmp_path / "frames"
    env["T"].json("POST", "/3/Frames/ext_fr/save", data={"dir": str(d)})
    before = th.DKV.get("ext_fr")
    out = env["T"].json("POST", "/3/Frames/load",
                        data={"dir": str(d), "frame_id": "ext_fr"})
    assert out["job"]["status"] == "DONE"
    after = th.DKV.get("ext_fr")
    assert after is not before
    for nm in before.names:
        assert_bitwise(after.col(nm).data.numpy(), before.col(nm).data.numpy())
        assert after.col(nm).domain == before.col(nm).domain


def test_model_binary_roundtrip(env, tmp_path):
    import h2o3_tpu_torch as th

    T, tm = env["T"], env["tm"]
    code, _h, blob = T.call("GET", f"/3/Models.fetch.bin/{tm.key}")
    assert code == 200 and len(blob) > 500
    d = tmp_path / "models"
    T.json("POST", f"/99/Models.bin/{tm.key}", data={"dir": str(d)})
    th.DKV.remove(str(tm.key))
    out = T.json("POST", "/99/Models.bin/",
                 data={"dir": str(d / str(tm.key))})
    assert out["models"][0]["model_id"]["name"] == str(tm.key)
    back = th.DKV.get(str(tm.key))
    assert back is not None and back is not tm
    assert_bitwise(back.predict(env["tf"]).col("Y").data.numpy(),
                   tm.predict(env["tf"]).col("Y").data.numpy())
    tm.install()
    up = T.json("POST", "/99/Models.upload.bin/uploaded_m", raw=blob)
    assert up["models"][0]["model_id"]["name"] == "uploaded_m"


def test_pojo_export(env):
    J, T = env["J"], env["T"]
    code, _h, src = T.call("GET", f"/3/Models.java/{env['tm'].key}")
    src = src.decode()
    assert code == 200 and "public class" in src and "score0" in src
    assert "static final int[][] FEAT" in src
    code, _h, prev = T.call("GET", f"/3/Models.java/{env['tm'].key}/preview")
    assert code == 200 and "public class" in prev.decode()
    code, _h, jsrc = J.call("GET", f"/3/Models.java/{env['jm'].key}")
    assert len(jsrc.decode().splitlines()) == len(src.splitlines())


def test_modelmetrics_family(env):
    j, t = _both(env, "POST", "/3/ModelMetrics/models/{m}/frames/ext_fr")
    assert abs(t["model_metrics"][0]["AUC"]
               - j["model_metrics"][0]["AUC"]) <= 1e-6
    T, mk = env["T"], str(env["tm"].key)
    lst = T.json("GET", "/3/ModelMetrics")
    assert any((mm.get("frame") or {}).get("name") == "ext_fr"
               for mm in lst["model_metrics"])
    assert T.json("GET", f"/3/ModelMetrics/models/{mk}")["model_metrics"]
    T.json("DELETE", f"/3/ModelMetrics/models/{mk}/frames/ext_fr")
    assert not T.json("GET", "/3/ModelMetrics/frames/ext_fr")["model_metrics"]


def test_metrics_from_predictions_frame(env):
    import h2o3_tpu_torch as th
    from h2o3_tpu.core.frame import Frame as JFrame

    env["jm"].predict(env["jf"], key="ext_pred").install()
    tp = env["tm"].predict(env["tf"])
    tp._key = th.Key("ext_pred")
    tp.install()
    aucs = []
    for R, f, F in ((env["J"], env["jf"], JFrame),
                    (env["T"], env["tf"], th.Frame)):
        actual = F(key="ext_actual")
        actual.add("y", f.col("y"))
        actual.install()
        out = R.json("POST", "/3/ModelMetrics/predictions_frame/ext_pred/"
                     "actuals_frame/ext_actual")
        aucs.append(out["model_metrics"][0]["AUC"])
    assert 0.0 <= aucs[1] <= 1.0 and abs(aucs[0] - aucs[1]) <= 1e-5


def test_nps(env, tmp_path, monkeypatch):
    monkeypatch.setenv("H2O_TPU_NPS_DIR", str(tmp_path / "nps"))
    T = env["T"]
    assert T.json("GET", "/3/NodePersistentStorage/configured")["configured"]
    T.json("POST", "/3/NodePersistentStorage/testcat/alpha",
           data={"value": "hello"})
    assert T.call("GET", "/3/NodePersistentStorage/testcat/alpha")[2] == \
        b"hello"
    lst = T.json("GET", "/3/NodePersistentStorage/testcat")
    assert any(e["name"] == "alpha" for e in lst["entries"])
    assert T.json("GET", "/3/NodePersistentStorage/categories/testcat/"
                  "exists")["exists"]
    path = "/3/NodePersistentStorage/categories/testcat/names/alpha/exists"
    assert T.json("GET", path)["exists"]
    T.json("DELETE", "/3/NodePersistentStorage/testcat/alpha")
    assert not T.json("GET", path)["exists"]


def test_admin_diagnostics(env):
    T = env["T"]
    assert T.json("GET", "/3/JStack")["traces"][0]["thread_traces"]
    T.json("GET", "/3/KillMinus3")
    echo = T.json("POST", "/3/LogAndEcho", data={"message": "ext-test"})
    assert echo["message"] == "ext-test"
    assert "cpu_ticks" in T.json("GET", "/3/WaterMeterCpuTicks/0")
    assert "persist_stats" in T.json("GET", "/3/WaterMeterIo")
    j, t = _both(env, "GET", "/3/SteamMetrics")
    assert set(j) == set(t) and t["cloud_size"] == 1
    assert T.json("POST", "/3/GarbageCollect")["freed_bytes"] >= 0
    T.json("POST", "/3/UnlockKeys")
    T.json("POST", "/3/CloudLock", data={"reason": "test"})


def test_typeahead_and_find(env, tmp_path):
    (tmp_path / "ta_one.csv").write_text("a\n1\n")
    out = env["T"].json("GET", "/3/Typeahead/files",
                        query={"src": str(tmp_path / "ta_"), "limit": 10})
    assert any("ta_one.csv" in m for m in out["matches"])
    q = {"key": "ext_fr", "column": "g", "row": 0, "match": "w"}
    j, t = _both(env, "GET", "/3/Find", query=q)
    assert t["next"] == j["next"] >= 0


def test_rapids_help_and_sample(env):
    j, t = _both(env, "GET", "/99/Rapids/help")
    assert "cumsum" in t["syntax"]
    assert set(j["syntax"]) <= set(t["syntax"]) | set(j["syntax"])
    q = {"dataset": "ext_fr", "rows": 50, "seed": 7}
    j, t = _both(env, "GET", "/99/Sample", query=q)
    assert t["frames"][0]["rows"] == j["frames"][0]["rows"] == 50


def test_missing_inserter(env):
    import h2o3_tpu_torch as th

    rng = np.random.default_rng(0)
    fr = th.Frame(key="mi_fr")
    fr.add("x", th.Column.from_numpy(rng.normal(size=300)))
    fr.install()
    env["T"].json("POST", "/3/MissingInserter",
                  data={"dataset": "mi_fr", "fraction": 0.3, "seed": 1})
    mask = np.isnan(fr.col("x").to_numpy())
    want = np.random.default_rng(1).random(300) < 0.3
    np.testing.assert_array_equal(mask, want)


def test_interaction(env):
    import h2o3_tpu_torch as th
    from h2o3_tpu.core.dkv import DKV as JDKV

    data = {"source_frame": "ext_fr", "factor_columns": ["g", "y"],
            "pairwise": False, "max_factors": 100, "dest": "gxy"}
    j, t = _both(env, "POST", "/3/Interaction", data=data)
    assert t["job"]["status"] == "DONE"
    ji, ti = JDKV.get("gxy"), th.DKV.get("gxy")
    assert ti.ncols == 1 and ti.names == ji.names
    c, jc = ti.col(ti.names[0]), ji.col(ji.names[0])
    assert c.domain == jc.domain and c.cardinality <= 6
    np.testing.assert_array_equal(c.to_numpy(), jc.to_numpy()[:384])


def test_dct_and_tabulate(env):
    import h2o3_tpu_torch as th
    from h2o3_tpu.core.dkv import DKV as JDKV

    data = {"dataset": "ext_fr", "dimensions": [2, 1, 1],
            "destination_frame": "dct_out"}
    _both(env, "POST", "/99/DCTTransformer", data=data)
    jd, td = JDKV.get("dct_out"), th.DKV.get("dct_out")
    assert td.ncols == 2 and td.names == jd.names
    for nm in td.names:
        np.testing.assert_allclose(td.col(nm).to_numpy(),
                                   jd.col(nm).to_numpy()[:384], atol=1e-5)
    data = {"dataset": "ext_fr", "predictor": "g", "response": "x"}
    j, t = _both(env, "POST", "/99/Tabulate", data=data)
    assert t["count_table"]["name"].startswith("Tabulate")
    assert t["count_table"]["data"] == j["count_table"]["data"]
    np.testing.assert_allclose(t["response_table"]["data"][1],
                               j["response_table"]["data"][1], rtol=1e-6)


def test_svmlight_over_rest(env, tmp_path):
    p = tmp_path / "small.svm"
    p.write_text("1 1:0.5 3:1.5\n0 2:2.0\n")
    out = env["T"].json("POST", "/3/ParseSVMLight",
                        data={"source_frames": [str(p)]})
    assert out["job"]["status"] == "DONE"


def test_grid_export_import(env, tmp_path):
    import h2o3_tpu_torch as th
    from h2o3_tpu_torch.grid import H2OGridSearch

    grid = H2OGridSearch(th.GBM(seed=1, ntrees=3, nbins=16),
                         {"max_depth": [2, 3]}, grid_id="ext_grid")
    grid.train(y="y", training_frame=env["tf"])
    T, d = env["T"], tmp_path / "grids"
    T.json("POST", "/3/Grid.bin/ext_grid/export",
           data={"grid_directory": str(d)})
    keys = [str(m.key) for m in grid.models]
    th.DKV.remove("ext_grid")
    for k in keys:
        th.DKV.remove(k)
    out = T.json("POST", "/3/Grid.bin/import",
                 data={"grid_path": str(d / "ext_grid")})
    assert out["grid_id"]["name"] == "ext_grid"
    assert any(g["grid_id"]["name"] == "ext_grid"
               for g in T.json("GET", "/99/Grids")["grids"])
    back = th.DKV.get("ext_grid")
    assert [str(m.key) for m in back.models] == keys
    for k, m in zip(keys, grid.models):
        assert_bitwise(th.DKV.get(k).predict(env["tf"]).col("Y").data.numpy(),
                       m.predict(env["tf"]).col("Y").data.numpy())
    # the library spelling of the same round trip
    again = H2OGridSearch.load(grid.save(str(tmp_path / "g2")))
    assert [str(m.key) for m in again.models] == keys
    T.json("POST", "/3/Grid.bin/import",
           data={"grid_path": str(d / keys[0])}, status=400)


def test_assembly_over_rest(env):
    import h2o3_tpu_torch as th

    steps = ["colSel__H2OColSelect__(cols_py dummy ['x','g'])__False__|"]
    data = {"frame": "ext_fr", "steps": steps, "assembly_id": "asm1"}
    j, t = _both(env, "POST", "/99/Assembly", data=data)
    assert t["assembly"]["name"] == "asm1"
    assert th.DKV.get(t["result"]["name"]).names == ["x", "g"]
    code, _h, src = env["T"].call("GET", "/99/Assembly.java/asm1/MyPipe")
    assert code == 200 and ("MyPipe" in src.decode()
                            or "step" in src.decode())


def test_metadata_detail_and_gated_routes(env):
    j, t = _both(env, "GET", "/3/Metadata/endpoints/cloud")
    assert t["endpoints"][0]["url_pattern"] == "/3/Cloud" == \
        j["endpoints"][0]["url_pattern"]
    sc = env["T"].json("GET", "/3/Metadata/schemaclasses/"
                       "water.api.schemas3.CloudV3")
    assert sc["schemas"][0]["name"] == "CloudV3"
    j, t = _both(env, "POST", "/3/SaveToHiveTable",
                 data={"table_name": "t"}, status=501)
    assert j["msg"] == t["msg"]
    out = env["T"].json("POST", "/3/DecryptionSetup", data={
        "decrypt_tool": "water.parser.NullDecryptionTool",
        "decrypt_impl": "nulltool"})
    assert out["decrypt_tool_id"]["name"] == "nulltool"


class _Evil:
    def __reduce__(self):
        return (print, ("pwned",))


def test_upload_bin_rejects_malicious_pickle(env):
    import torch

    for payload in (pickle.dumps(_Evil()), pickle.dumps(torch.ones(3))):
        code, _h, body = env["T"].call(
            "POST", "/99/Models.upload.bin/evil", raw=payload)
        assert code == 400 and b"rejected model upload" in body


def test_drf_binomial_pojo_clips_not_sigmoid(env):
    import h2o3_tpu_torch as th
    from h2o3_tpu_torch.models import pojo

    m = th.DRF(ntrees=5, max_depth=4, seed=1, nbins=16).train(
        x=["x", "x2", "g"], y="y", training_frame=env["tf"])
    src = pojo.pojo_source(m)
    assert "Math.exp(-f)" not in src
    assert "Math.min(Math.max(f, 0.0), 1.0)" in src


def test_find_skips_na_and_nonnumeric(env):
    import torch

    import h2o3_tpu_torch as th

    g = th.DKV.get("ext_fr").col("g")
    saved = g.data
    g.data = torch.where(torch.arange(saved.shape[0]) == 0,
                         torch.full_like(saved, -1), saved)
    try:
        hit = env["T"].json("GET", "/3/Find", query={
            "key": "ext_fr", "column": "g", "row": 0, "match": "u"})
        assert hit["next"] != 0
        out = env["T"].json("GET", "/3/Find", query={
            "key": "ext_fr", "column": "x", "row": 0, "match": "abc"})
        assert out["next"] == -1
    finally:
        g.data = saved


def test_drf_double_trees_pojo_per_class(cl):
    import h2o3_tpu_torch as th
    from h2o3_tpu_torch.models import pojo
    from h2o3_tpu_torch.models.mojo import _default_threshold

    th.init(device="cpu")
    rng = np.random.default_rng(4)
    n = 384
    X = rng.normal(size=(n, 2))
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-2 * X[:, 0])), "Y", "N")
    fr = th.Frame()
    fr.add("a", th.Column.from_numpy(X[:, 0]))
    fr.add("b", th.Column.from_numpy(X[:, 1]))
    fr.add("y", th.Column.from_numpy(y, ctype="enum"))
    m = th.DRF(ntrees=6, max_depth=4, binomial_double_trees=True,
               seed=4, nbins=16).train(y="y", training_frame=fr)
    src = pojo.pojo_source(m)
    assert "NCLASSES = 2" in src
    assert "acc[TREE_CLASS[t]]" in src
    assert f"preds[2] >= {_default_threshold(m)!r}" in src
