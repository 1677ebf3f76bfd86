"""S3 objects over plain HTTPS, no SDK (counterpart of
h2o3_tpu/persist/s3.py: `_split` :26, `_sign_v4` :35, `object_url` :77,
`fetch_s3` :89; h2o-persist-s3's PersistS3.java).

A GET of one object, signed with AWS Signature Version 4 when
``AWS_ACCESS_KEY_ID`` and ``AWS_SECRET_ACCESS_KEY`` are set (with
``AWS_SESSION_TOKEN`` and ``AWS_REGION``, default us-east-1), unsigned
otherwise (public buckets). ``H2O_TPU_S3_ENDPOINT`` points the request
at another endpoint with path-style addressing (a local S3-compatible
store). The object is fetched once into the persist cache directory and
parsed from there. The signing time comes from `_now`, one clock a test
can pin.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import shutil
import urllib.parse
import urllib.request
from typing import Dict, Optional, Tuple


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def _split(uri: str) -> Tuple[str, str]:
    p = urllib.parse.urlparse(uri)
    bucket, key = p.netloc, p.path.lstrip("/")
    if not bucket or not key:
        raise ValueError(f"malformed s3 uri {uri!r} (want s3://bucket/key)")
    return bucket, key


def _sign_v4(method: str, url: str, region: str, access_key: str,
             secret_key: str, session_token: Optional[str],
             now: Optional[datetime.datetime] = None) -> Dict[str, str]:
    """The headers of an empty-body request signed with AWS Signature
    Version 4 at `now` (default `_now()`)."""
    p = urllib.parse.urlparse(url)
    now = now or _now()
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(b"").hexdigest()
    headers = {"host": p.netloc, "x-amz-content-sha256": payload_hash,
               "x-amz-date": amz_date}
    if session_token:
        headers["x-amz-security-token"] = session_token
    signed = ";".join(sorted(headers))
    # the path is already percent-encoded by object_url: S3 canonicalises
    # it as sent, so quoting it again would break keys with spaces
    canonical = "\n".join([
        method, p.path or "/", p.query,
        "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
        signed, payload_hash])
    scope = f"{datestamp}/{region}/s3/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])

    def _h(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _h(("AWS4" + secret_key).encode(), datestamp)
    for part in (region, "s3", "aws4_request"):
        k = _h(k, part)
    sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    out = {k_: v for k_, v in headers.items() if k_ != "host"}
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}")
    return out


def object_url(uri: str) -> str:
    bucket, key = _split(uri)
    endpoint = os.environ.get("H2O_TPU_S3_ENDPOINT")
    if endpoint:
        return f"{endpoint.rstrip('/')}/{bucket}/{urllib.parse.quote(key)}"
    region = os.environ.get("AWS_REGION", "us-east-1")
    host = (f"{bucket}.s3.amazonaws.com" if region == "us-east-1"
            else f"{bucket}.s3.{region}.amazonaws.com")
    return f"https://{host}/{urllib.parse.quote(key)}"


def fetch_s3(uri: str) -> str:
    """s3://bucket/key -> a local path in the persist cache."""
    from h2o3_tpu_torch.persist import _local_name

    dest = _local_name(uri)
    if os.path.exists(dest):
        return dest
    url = object_url(uri)
    headers: Dict[str, str] = {}
    ak = os.environ.get("AWS_ACCESS_KEY_ID")
    sk = os.environ.get("AWS_SECRET_ACCESS_KEY")
    if ak and sk:
        headers = _sign_v4("GET", url, os.environ.get("AWS_REGION",
                                                      "us-east-1"),
                           ak, sk, os.environ.get("AWS_SESSION_TOKEN"))
    tmp = dest + ".part"
    with urllib.request.urlopen(urllib.request.Request(url, headers=headers),
                                timeout=120) as r, open(tmp, "wb") as f:
        shutil.copyfileobj(r, f)
    os.replace(tmp, dest)
    return dest
