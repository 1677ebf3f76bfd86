"""Shared fixtures of the REST parity tests: the JAX package's server and
the port's (on the CPU) on ephemeral ports in one process, and a small
HTTP helper with a timeout on every request and a deadline on every job
poll."""

import json
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np

REQUEST_TIMEOUT_S = 60.0
JOB_DEADLINE_S = 120.0


class Rest:
    """One server's base URL; `call` returns (status, headers, body)."""

    def __init__(self, port, scheme="http"):
        self.base = f"{scheme}://127.0.0.1:{port}"

    def call(self, method, path, data=None, query=None, form=False,
             raw=None, headers=None):
        url = self.base + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        hdrs = dict(headers or {})
        body = None
        if raw is not None:
            body = raw
            hdrs.setdefault("Content-Type", "application/octet-stream")
        elif data is not None and form:
            body = urllib.parse.urlencode(data).encode()
            hdrs["Content-Type"] = "application/x-www-form-urlencoded"
        elif data is not None:
            body = json.dumps(data).encode()
            hdrs["Content-Type"] = "application/json"
        req = urllib.request.Request(url, data=body, headers=hdrs,
                                     method=method)
        try:
            with urllib.request.urlopen(req,
                                        timeout=REQUEST_TIMEOUT_S) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def json(self, method, path, data=None, query=None, form=False,
             status=200, **kw):
        code, _h, body = self.call(method, path, data, query, form, **kw)
        out = json.loads(body.decode()) if body else {}
        assert code == status, (method, path, code, out.get("msg", out))
        return out

    def wait_job(self, job_id, deadline_s=JOB_DEADLINE_S):
        t0 = time.time()
        while True:
            job = self.json("GET", f"/3/Jobs/{job_id}")["jobs"][0]
            if job["status"] not in ("CREATED", "RUNNING"):
                return job
            assert time.time() - t0 < deadline_s, f"job {job_id} past " \
                f"its {deadline_s}s deadline"
            time.sleep(0.05)

    def done_job(self, out, deadline_s=JOB_DEADLINE_S):
        job = self.wait_job(out["job"]["key"]["name"], deadline_s)
        assert job["status"] == "DONE", job.get("exception")
        return job

    def import_parse(self, path, dest=None):
        """ImportFiles -> ParseSetup -> Parse, as h2o-py does; returns
        (setup reply, frame key)."""
        listing = self.json("GET", "/3/ImportFiles", query={"path": path})
        setup = self.json("POST", "/3/ParseSetup",
                          data={"source_frames": listing["files"]})
        out = self.json("POST", "/3/Parse", data={
            "source_frames": listing["files"],
            "destination_frame": dest or setup["destination_frame"]})
        job = self.done_job(out)
        return setup, job["dest"]["name"]

    def train(self, algo, deadline_s=JOB_DEADLINE_S, **params):
        out = self.json("POST", f"/3/ModelBuilders/{algo}", data=params)
        job = self.done_job(out, deadline_s)
        return job["dest"]["name"]


def start_both(monkeypatch):
    """(JAX server, port server) on ephemeral ports; the port on the
    CPU. The reference's sharded scoring flush hits this JAX build's
    shard_map error, so its sessions pack on the host (as in
    test_torch_scoring.py)."""
    import h2o3_tpu
    from h2o3_tpu import scoring as jscoring
    from h2o3_tpu.api.server import start_server as jstart

    import h2o3_tpu_torch as th
    from h2o3_tpu_torch.api.server import start_server as tstart

    monkeypatch.setattr(jscoring.ScoringSession, "_sharded_view",
                        lambda self, adapted: None)
    h2o3_tpu.init()
    th.init(device="cpu")
    return jstart(port=0), tstart(port=0)


def write_api_csv(path, n=320, seed=0):
    """tests/test_rest_api.py's fixture: g (3 levels), x normal, y YES/NO
    from x plus noise."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write("g,x,y\n")
        for i in range(n):
            g = ["a", "b", "c"][i % 3]
            x = rng.normal()
            f.write(f"{g},{x:.4f},"
                    f"{'YES' if x + rng.normal() * 0.3 > 0 else 'NO'}\n")
    return str(path)
