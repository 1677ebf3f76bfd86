"""Persist backends: a URI scheme registry for data sources (counterpart
of h2o3_tpu/persist/__init__.py, water/persist/PersistManager.java).

Schemes resolve to local file paths: plain paths and ``file://`` URIs
directly, ``http(s)://`` and ``s3://`` objects (persist/s3.py, SigV4
signing over the stdlib) fetched once into a process-local cache
directory; the parse then runs on the local copy. `register_scheme`
installs a backend at run time. ``gs://`` and ``hdfs://`` raise
CapabilityGate, as in the reference: their SDKs are not installed.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional

from h2o3_tpu_torch.errors import CapabilityGate

_CACHE_DIR: Optional[str] = None

# scheme -> fetch(uri) -> local path
_SCHEMES: Dict[str, Callable[[str], str]] = {}


def cache_dir() -> str:
    global _CACHE_DIR
    if _CACHE_DIR is None:
        _CACHE_DIR = tempfile.mkdtemp(prefix="h2o3_tpu_torch_persist_")
    return _CACHE_DIR


def register_scheme(scheme: str, fetch: Callable[[str], str]) -> None:
    """Install a storage backend: fetch(uri) returns a local file path."""
    _SCHEMES[scheme.lower()] = fetch


def _local_name(uri: str) -> str:
    """Stable cache file name keeping the remote basename (the extension
    drives the parser's format dispatch)."""
    base = os.path.basename(urllib.parse.urlparse(uri).path) or "download"
    h = hashlib.sha1(uri.encode()).hexdigest()[:12]
    return os.path.join(cache_dir(), f"{h}_{base}")


def _fetch_http(uri: str) -> str:
    dest = _local_name(uri)
    if os.path.exists(dest):
        return dest
    tmp = dest + ".part"
    with urllib.request.urlopen(uri, timeout=60) as r, open(tmp, "wb") as f:
        shutil.copyfileobj(r, f)
    os.replace(tmp, dest)
    return dest


def _fetch_file(uri: str) -> str:
    return urllib.request.url2pathname(urllib.parse.urlparse(uri).path)


def _gated(scheme: str, what: str):
    def fetch(uri: str) -> str:
        raise CapabilityGate(
            f"{scheme}:// URIs need {what}. Fetch the object to a local "
            f"path (or an http(s) endpoint) and import that instead.")

    return fetch


register_scheme("http", _fetch_http)
register_scheme("https", _fetch_http)
register_scheme("file", _fetch_file)
from h2o3_tpu_torch.persist.s3 import fetch_s3  # noqa: E402

register_scheme("s3", fetch_s3)
register_scheme("gs", _gated("gs", "the google-cloud-storage SDK, which is "
                                   "not installed"))
register_scheme("hdfs", _gated("hdfs", "the pyarrow HadoopFileSystem SDK, "
                                       "which is not installed"))


def is_remote(path: str) -> bool:
    return "://" in path


def resolve(path: str) -> str:
    """URI -> local path (identity for plain paths)."""
    if not is_remote(path):
        return path
    scheme = path.split("://", 1)[0].lower()
    fetch = _SCHEMES.get(scheme)
    if fetch is None:
        raise ValueError(f"no persist backend registered for scheme "
                         f"{scheme!r} (have: {sorted(_SCHEMES)})")
    return fetch(path)


def resolve_all(paths: List[str]) -> List[str]:
    return [resolve(p) for p in paths]
