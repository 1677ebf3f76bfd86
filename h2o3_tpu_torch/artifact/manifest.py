"""Versioned artifact manifest: the schema-validated front door
(counterpart of h2o3_tpu/artifact/manifest.py; the format string, the
version and the schema are the reference's, so either package reads the
other's artifacts).

The manifest (``manifest.json`` in the artifact directory) names every
payload file with its sha256, so a loader rejects a tampered or
truncated artifact before any of its bytes are interpreted, and refuses
future format versions instead of misreading them. Every read goes
through :func:`read_manifest` (structural validation) and
:func:`read_payload` (checksum-verified bytes).

The port ships one exported program per row bucket in the list
``programs`` (``program_b{N}.pt2``, a ``torch.export`` ExportedProgram);
the reference's ``executables`` and ``stablehlo`` lists stay present and
empty. A reference artifact has no ``programs``: its loader reads only
the packed arrays, which both packages share.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict

FORMAT = "h2o3-tpu-aot-artifact"
FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"


class ArtifactError(ValueError):
    """Malformed / tampered / incompatible artifact."""


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def file_entry(name: str, data: bytes) -> Dict[str, Any]:
    return {"name": name, "sha256": sha256_bytes(data), "bytes": len(data)}


def write_payload(art_dir: str, name: str, data: bytes) -> Dict[str, Any]:
    """Write one payload file atomically and return its manifest entry."""
    path = os.path.join(art_dir, name)
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return file_entry(name, data)


def _check_name(name: str) -> str:
    """Payload names are bare filenames inside the artifact dir — a
    manifest must not be able to point the loader outside it."""
    if not name or os.path.basename(name) != name or name.startswith("."):
        raise ArtifactError(f"illegal payload file name {name!r}")
    return name


def read_payload(art_dir: str, entry: Dict[str, Any]) -> bytes:
    """Checksum-verified payload read; raises ArtifactError on mismatch,
    truncation, or a manifest entry pointing outside the directory."""
    if not isinstance(entry, dict) or not entry.get("name") \
            or not entry.get("sha256"):
        raise ArtifactError(f"malformed payload entry {entry!r}")
    path = os.path.join(art_dir, _check_name(str(entry["name"])))
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise ArtifactError(f"payload {entry['name']!r} unreadable: {e}") \
            from None
    if sha256_bytes(data) != entry["sha256"]:
        raise ArtifactError(
            f"payload {entry['name']!r} checksum mismatch — artifact is "
            "corrupt or was tampered with")
    return data


# required manifest keys -> type check (None = any JSON value)
_SCHEMA = {
    "format": str,
    "format_version": int,
    "algo": str,
    "model_category": str,
    "model_checksum": str,
    "nclasses": int,
    "per_class_trees": bool,
    "max_depth": int,
    "init_f": float,
    "names": list,
    "domains": dict,
    "post": dict,
    "default_threshold": float,
    "files": dict,
    "buckets": list,
    "executables": list,
    "stablehlo": list,
}


def new_manifest(**fields) -> Dict[str, Any]:
    m = {"format": FORMAT, "format_version": FORMAT_VERSION,
         "created_ts": time.time()}
    m.update(fields)
    return m


def write_manifest(art_dir: str, manifest: Dict[str, Any]) -> str:
    validate(manifest)
    path = os.path.join(art_dir, MANIFEST_NAME)
    tmp = path + ".part"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def validate(m: Any) -> Dict[str, Any]:
    if not isinstance(m, dict):
        raise ArtifactError("manifest is not a JSON object")
    if m.get("format") != FORMAT:
        raise ArtifactError(
            f"not an {FORMAT} artifact (format={m.get('format')!r})")
    ver = m.get("format_version")
    if not isinstance(ver, int) or ver > FORMAT_VERSION or ver < 1:
        raise ArtifactError(
            f"artifact format_version {ver!r} is not supported by this "
            f"runtime (supports 1..{FORMAT_VERSION}) — export/load version "
            "mismatch")
    for key, typ in _SCHEMA.items():
        if key not in m:
            raise ArtifactError(f"manifest missing required key {key!r}")
        if typ is float and isinstance(m[key], int):
            continue                      # JSON ints are acceptable floats
        if typ is not None and not isinstance(m[key], typ):
            raise ArtifactError(
                f"manifest key {key!r} has type {type(m[key]).__name__}, "
                f"expected {typ.__name__}")
    mt = m.get("model_type", "forest")
    if mt not in ("forest", "glm", "pipeline"):
        raise ArtifactError(
            f"unsupported model_type {mt!r} (this runtime loads 'forest', "
            "'glm' and 'pipeline' artifacts)")
    if mt == "glm":
        if not isinstance(m.get("glm"), dict):
            raise ArtifactError("glm artifact manifest missing its 'glm' "
                                "configuration block")
        if "glm" not in m["files"]:
            raise ArtifactError("glm artifact manifest names no 'glm' "
                                "payload file")
    elif mt == "pipeline":
        p = m.get("pipeline")
        if not isinstance(p, dict):
            raise ArtifactError("pipeline artifact manifest missing its "
                                "'pipeline' block")
        if not isinstance(p.get("inputs"), list) or not p["inputs"]:
            raise ArtifactError("pipeline artifact declares no raw "
                                "inputs")
        if p.get("inner") not in ("forest", "glm"):
            raise ArtifactError(
                f"pipeline artifact wraps unsupported inner model "
                f"{p.get('inner')!r}")
        if "pipeline" not in m["files"]:
            raise ArtifactError("pipeline artifact manifest names no "
                                "'pipeline' payload file")
    elif "forest" not in m["files"]:
        raise ArtifactError("forest artifact manifest names no 'forest' "
                            "payload file")
    progs = m.get("programs", [])
    if not isinstance(progs, list):
        raise ArtifactError("manifest key 'programs' is not a list")
    for entry in list(m["files"].values()) + list(m["executables"]) \
            + list(m["stablehlo"]) + list(progs):
        if not isinstance(entry, dict) or "name" not in entry \
                or "sha256" not in entry:
            raise ArtifactError(f"malformed file entry {entry!r}")
        _check_name(str(entry["name"]))
    return m


def read_manifest(art_dir: str) -> Dict[str, Any]:
    path = os.path.join(art_dir, MANIFEST_NAME)
    try:
        with open(path, encoding="utf-8") as f:
            raw = f.read()
    except OSError as e:
        raise ArtifactError(f"no readable {MANIFEST_NAME} in {art_dir!r}: "
                            f"{e}") from None
    try:
        m = json.loads(raw)
    except ValueError as e:
        raise ArtifactError(f"{MANIFEST_NAME} is not valid JSON: {e}") \
            from None
    return validate(m)
