"""Thin HTTP client — the h2o-py surface over the REST API (the port's
own copy of h2o3_tpu/client.py).

Reference: h2o-py/h2o/h2o.py + backend/connection.py (H2OConnection) +
frame.py (H2OFrame over a lazy client-side AST, expr.py:27). The client
talks only HTTP/JSON: it holds expression handles and metadata, never
data. Every request carries a timeout (600 s) and every job poll a
deadline (`_wait_job`'s `timeout`, 3600 s).

Usage:
    from h2o3_tpu_torch import client as h2o
    h2o.connect(port=54321)
    fr = h2o.import_file("data.csv")
    m = h2o.train("gbm", y="y", training_frame=fr, ntrees=20)
    pred = h2o.predict(m, fr)
"""

from __future__ import annotations

import json
import time
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional

_BASE: Optional[str] = None
_SESSION: Optional[str] = None
_AUTH: Optional[str] = None            # precomputed Basic auth header


class H2OServerError(RuntimeError):
    pass


def _req(method: str, path: str, data: Optional[dict] = None,
         query: Optional[dict] = None) -> dict:
    if _BASE is None:
        raise RuntimeError("not connected — call client.connect(port=...)")
    url = _BASE + path
    if query:
        url += "?" + urllib.parse.urlencode(query)
    body = None
    headers = {}
    if _AUTH:
        headers["Authorization"] = _AUTH
    if data is not None:
        body = json.dumps(data).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=body, headers=headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        try:
            err = json.loads(e.read().decode())
            raise H2OServerError(err.get("msg", str(e))) from None
        except (ValueError, KeyError):
            raise H2OServerError(str(e)) from None


def connect(ip: str = "127.0.0.1", port: int = 54321,
            username: Optional[str] = None,
            password: Optional[str] = None) -> dict:
    global _BASE, _SESSION, _AUTH
    _BASE = f"http://{ip}:{port}"
    if username is not None:
        import base64

        _AUTH = "Basic " + base64.b64encode(
            f"{username}:{password or ''}".encode()).decode()
    else:
        _AUTH = None
    cloud = _req("GET", "/3/Cloud")
    _SESSION = _req("GET", "/4/sessions")["session_key"]
    return cloud


def cluster_status() -> dict:
    return _req("GET", "/3/Cloud")


class RemoteFrame:
    """Handle to a server-side frame (metadata only, like h2o-py H2OFrame)."""

    def __init__(self, frame_id: str, meta: Optional[dict] = None):
        self.frame_id = frame_id
        self._meta = meta

    # -- metadata ---------------------------------------------------------
    def _info(self) -> dict:
        if self._meta is None or "rows" not in self._meta:
            self._meta = _req("GET", f"/3/Frames/{self.frame_id}")["frames"][0]
        return self._meta

    @property
    def nrows(self) -> int:
        return int(self._info()["rows"])

    @property
    def ncols(self) -> int:
        return int(self._info()["num_columns"])

    @property
    def names(self) -> List[str]:
        return list(self._info()["column_names"])

    def head(self, rows: int = 10) -> List[dict]:
        fr = _req("GET", f"/3/Frames/{self.frame_id}",
                  query={"row_count": rows})["frames"][0]

        def cell(c, i):
            if c.get("string_data") is not None:
                vals = c["string_data"]
                return vals[i] if i < len(vals) else None
            vals = c.get("data") or []
            v = vals[i] if i < len(vals) else None
            if c["type"] == "enum" and isinstance(v, int) and c.get("domain"):
                return c["domain"][v]          # decode code -> label
            return None if v == "NaN" else v

        n = min(rows, fr["rows"])
        return [{c["label"]: cell(c, i) for c in fr["columns"]}
                for i in range(n)]

    def summary(self) -> dict:
        return _req("GET", f"/3/Frames/{self.frame_id}/summary")["frames"][0]["summary"]

    # -- rapids-backed ops -------------------------------------------------
    def _rapids_frame(self, ast: str) -> "RemoteFrame":
        out = rapids(ast)
        return RemoteFrame(out["key"]["name"], out)

    def cols(self, names) -> "RemoteFrame":
        sel = " ".join(f"'{n}'" for n in names)
        return self._rapids_frame(f"(cols_py {self.frame_id} [{sel}])")

    def mean(self, col: str) -> float:
        return rapids(f"(mean (cols_py {self.frame_id} '{col}'))")["scalar"]

    def delete(self):
        _req("DELETE", f"/3/Frames/{self.frame_id}")

    def __repr__(self):
        return f"<RemoteFrame {self.frame_id}>"


def rapids(ast: str) -> dict:
    return _req("POST", "/99/Rapids", data={"ast": ast, "session_id": _SESSION})


def import_file(path: str, destination_frame: Optional[str] = None) -> RemoteFrame:
    listing = _req("GET", "/3/ImportFiles", query={"path": path})
    if listing["fails"]:
        raise FileNotFoundError(path)
    setup = _req("POST", "/3/ParseSetup",
                 data={"source_frames": listing["files"]})
    parse = _req("POST", "/3/Parse", data={
        "source_frames": listing["files"],
        "destination_frame": destination_frame or setup["destination_frame"]})
    job = _wait_job(parse["job"]["key"]["name"])
    return RemoteFrame(job["dest"]["name"])


def _wait_job(job_id: str, timeout: float = 3600) -> dict:
    t0 = time.time()
    while True:
        job = _req("GET", f"/3/Jobs/{job_id}")["jobs"][0]
        if job["status"] in ("DONE", "FAILED", "CANCELLED"):
            if job["status"] == "FAILED":
                raise H2OServerError(job.get("exception") or "job failed")
            return job
        if time.time() - t0 > timeout:
            raise TimeoutError(f"job {job_id} timed out")
        time.sleep(0.2)


class RemoteModel:
    def __init__(self, model_id: str):
        self.model_id = model_id

    def info(self) -> dict:
        return _req("GET", f"/3/Models/{self.model_id}")["models"][0]

    @property
    def auc(self):
        out = self.info().get("output") or {}
        return (out.get("training_metrics") or {}).get("AUC")

    def predict(self, frame: RemoteFrame,
                destination_frame: Optional[str] = None) -> RemoteFrame:
        out = _req("POST",
                   f"/3/Predictions/models/{self.model_id}/frames/{frame.frame_id}",
                   data={"predictions_frame": destination_frame or ""})
        return RemoteFrame(out["predictions_frame"]["name"])

    def delete(self):
        _req("DELETE", f"/3/Models/{self.model_id}")

    def __repr__(self):
        return f"<RemoteModel {self.model_id}>"


def train(algo: str, y: Optional[str] = None, training_frame: RemoteFrame = None,
          validation_frame: Optional[RemoteFrame] = None, **params) -> RemoteModel:
    data: Dict[str, Any] = {"training_frame": training_frame.frame_id}
    if y:
        data["response_column"] = y
    if validation_frame is not None:
        data["validation_frame"] = validation_frame.frame_id
    data.update({k: (json.dumps(v) if isinstance(v, (list, dict)) else v)
                 for k, v in params.items()})
    out = _req("POST", f"/3/ModelBuilders/{algo}", data=data)
    job = _wait_job(out["job"]["key"]["name"])
    return RemoteModel(job["dest"]["name"])


def predict(model: RemoteModel, frame: RemoteFrame) -> RemoteFrame:
    return model.predict(frame)


def list_frames() -> List[str]:
    return [f["frame_id"]["name"] for f in _req("GET", "/3/Frames")["frames"]]


def list_models() -> List[str]:
    return [m["model_id"]["name"] for m in _req("GET", "/3/Models")["models"]]


def shutdown():
    _req("POST", "/3/Shutdown")
