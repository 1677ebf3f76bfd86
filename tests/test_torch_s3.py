"""The port's S3 reader (h2o3_tpu_torch/persist/s3.py) on the CPU, against
the JAX package's (h2o3_tpu/persist/s3.py): the reference's mock-endpoint
tests (tests/test_formats_round4.py:132-170), signed and anonymous, with
both packages' frames equal (bit for bit, torch_port_support.
assert_frames_match); `_sign_v4` of a fixed request at a fixed time
equal as strings between the packages; gs:// still gated."""

import datetime
import http.server
import threading

import pytest

import h2o3_tpu_torch as th
from h2o3_tpu_torch.persist import s3

from torch_port_support import assert_frames_match

FIXED = datetime.datetime(2026, 5, 17, 8, 30, 45,
                          tzinfo=datetime.timezone.utc)


class _S3Mock(http.server.BaseHTTPRequestHandler):
    """A path-style S3 endpoint: GET /bucket/key serves stored bytes and
    records the request headers."""

    store = {}
    seen = []

    def do_GET(self):
        type(self).seen.append(dict(self.headers))
        body = self.store.get(self.path)
        if body is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture()
def endpoint(monkeypatch):
    """The mock on an ephemeral port. Object names are this file's own:
    each package caches a fetched URI for the life of the process, and
    tests/test_formats_round4.py serves other bytes under its names."""
    _S3Mock.store, _S3Mock.seen = {}, []
    srv = http.server.HTTPServer(("127.0.0.1", 0), _S3Mock)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    monkeypatch.setenv("H2O_TPU_S3_ENDPOINT",
                       f"http://127.0.0.1:{srv.server_port}")
    try:
        yield _S3Mock
    finally:
        srv.shutdown()
        srv.server_close()


def test_signed_import_matches_reference(cl, endpoint, monkeypatch):
    csv = b"a,b,c\n1,x,0.5\n2,y,1.5\n3,x,\n4,z,2.25\n"
    endpoint.store = {"/torchbkt/data/signed_ref.csv": csv,
                      "/torchbkt/data/signed_port.csv": csv}
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIATEST")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "secret")
    monkeypatch.setenv("AWS_SESSION_TOKEN", "tok")
    import h2o3_tpu

    jf = h2o3_tpu.import_file("s3://torchbkt/data/signed_ref.csv")
    th.init(device="cpu")
    tf = th.import_file("s3://torchbkt/data/signed_port.csv")
    assert tf.nrows == 4 and tf.names == ["a", "b", "c"]
    assert_frames_match(jf, tf, "s3 signed")
    assert len(endpoint.seen) == 2
    for hdrs in endpoint.seen:
        auth = hdrs.get("Authorization", "")
        assert auth.startswith("AWS4-HMAC-SHA256 Credential=AKIATEST/")
        assert "SignedHeaders=host;x-amz-content-sha256;x-amz-date;" \
               "x-amz-security-token, Signature=" in auth
        low = {k.lower(): v for k, v in hdrs.items()}
        assert low["x-amz-security-token"] == "tok"
        assert low["x-amz-content-sha256"]


def test_anonymous_import_matches_reference(cl, endpoint, monkeypatch):
    endpoint.store = {"/torchpub/anon_ref.csv": b"q\n1\n2\n",
                      "/torchpub/anon_port.csv": b"q\n1\n2\n"}
    monkeypatch.delenv("AWS_ACCESS_KEY_ID", raising=False)
    monkeypatch.delenv("AWS_SECRET_ACCESS_KEY", raising=False)
    import h2o3_tpu

    jf = h2o3_tpu.import_file("s3://torchpub/anon_ref.csv")
    th.init(device="cpu")
    tf = th.import_file("s3://torchpub/anon_port.csv")
    assert tf.nrows == 2
    assert_frames_match(jf, tf, "s3 anonymous")
    assert all("Authorization" not in h for h in endpoint.seen)


def test_missing_object_raises(endpoint):
    import urllib.error

    th.init(device="cpu")
    with pytest.raises(urllib.error.HTTPError):
        th.import_file("s3://torchpub/nothing.csv")


@pytest.mark.parametrize("token", [None, "sess"])
@pytest.mark.parametrize("url", [
    "https://bkt.s3.amazonaws.com/dir/file%20name.csv",
    "http://127.0.0.1:9000/bkt/a/b.csv?versionId=3"])
def test_sign_v4_equals_reference(monkeypatch, url, token):
    from h2o3_tpu.persist import s3 as js3

    class _Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return FIXED

    monkeypatch.setattr(js3.datetime, "datetime", _Clock)
    want = js3._sign_v4("GET", url, "eu-west-1", "AKIA", "sk", token)
    monkeypatch.setattr(s3, "_now", lambda: FIXED)
    assert s3._sign_v4("GET", url, "eu-west-1", "AKIA", "sk", token) == want
    assert s3._sign_v4("GET", url, "eu-west-1", "AKIA", "sk", token,
                       now=FIXED) == want
    assert want["x-amz-date"] == "20260517T083045Z"


def test_object_url_and_split_match_reference(monkeypatch):
    from h2o3_tpu.persist import s3 as js3

    for env in ({}, {"AWS_REGION": "eu-west-1"},
                {"H2O_TPU_S3_ENDPOINT": "http://localhost:9000/"}):
        for k in ("AWS_REGION", "H2O_TPU_S3_ENDPOINT"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for uri in ("s3://b/k.csv", "s3://b/dir/a b+c.csv"):
            assert s3.object_url(uri) == js3.object_url(uri)
    for bad in ("s3://bucket-only", "s3:///key"):
        with pytest.raises(ValueError):
            s3._split(bad)


def test_gs_and_hdfs_still_gated():
    from h2o3_tpu_torch.errors import CapabilityGate

    th.init(device="cpu")
    for uri in ("gs://b/k.csv", "hdfs://nn/k.csv"):
        with pytest.raises(CapabilityGate):
            th.import_file(uri)
