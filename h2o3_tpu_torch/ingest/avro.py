"""Avro Object Container File decoder, pure stdlib (copy of
h2o3_tpu/ingest/avro.py).

Reference: h2o-parsers/h2o-avro-parser/src/main/java/water/parser/avro/
AvroParser.java:1 (record-per-row ingestion of primitive/nullable-union
fields). Spec: the 1.x container format — magic `Obj\\x01`, a file-metadata
map carrying avro.schema (JSON) + avro.codec, a 16-byte sync marker, then
blocks of (record_count, byte_size, serialized records)[sync].

Supported: null/boolean/int/long/float/double/string/bytes/enum fields and
["null", primitive] unions (the shapes AvroParser.java ingests — complex
nested types raise, same as the reference's guardedParse skip). Codecs:
null + deflate (zlib)."""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

MAGIC = b"Obj\x01"


class _Reader:
    def __init__(self, buf: bytes):
        self.b = buf
        self.i = 0

    def read(self, n: int) -> bytes:
        out = self.b[self.i:self.i + n]
        if len(out) != n:
            raise ValueError("truncated avro data")
        self.i += n
        return out

    def long(self) -> int:
        """zigzag varint."""
        shift, acc = 0, 0
        while True:
            if self.i >= len(self.b):
                raise ValueError("truncated avro data")
            byte = self.b[self.i]
            self.i += 1
            acc |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def eof(self) -> bool:
        return self.i >= len(self.b)


def _read_value(r: _Reader, schema):
    if isinstance(schema, list):                    # union: long index
        idx = r.long()
        return _read_value(r, schema[idx])
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "enum":
            return schema["symbols"][r.long()]
        if t in ("record", "map", "array", "fixed"):
            raise ValueError(
                f"avro complex type {t!r} not supported (AvroParser.java "
                "ingests flat records; flatten before import)")
        schema = t
    if schema == "null":
        return None
    if schema == "boolean":
        return bool(r.read(1)[0])
    if schema in ("int", "long"):
        return r.long()
    if schema == "float":
        return struct.unpack("<f", r.read(4))[0]
    if schema == "double":
        return struct.unpack("<d", r.read(8))[0]
    if schema in ("string", "bytes"):
        n = r.long()
        raw = r.read(n)
        return raw.decode() if schema == "string" else raw
    raise ValueError(f"unknown avro type {schema!r}")


def _base_type(schema) -> str:
    if isinstance(schema, list):                    # ["null", X]
        non_null = [s for s in schema if s != "null"]
        return _base_type(non_null[0]) if non_null else "null"
    if isinstance(schema, dict):
        return "enum" if schema["type"] == "enum" else str(schema["type"])
    return str(schema)


def _schema_types(fields) -> List[str]:
    out = []
    for fld in fields:
        bt = _base_type(fld["type"])
        if bt in ("int", "long", "float", "double", "boolean"):
            out.append("real")
        elif bt == "enum":
            out.append("enum")
        else:
            out.append("string")
    return out


def _read_header(r: "_Reader") -> Tuple[dict, bytes]:
    """Shared container-header decode: -> (schema json, sync marker).
    Consumes MAGIC + the file-metadata map."""
    if r.read(4) != MAGIC:
        raise ValueError("not an avro container file")
    meta: Dict[str, bytes] = {}
    while True:
        n = r.long()
        if n == 0:
            break
        if n < 0:                                   # block with byte size
            r.long()
            n = -n
        for _ in range(n):
            k = r.read(r.long()).decode()
            meta[k] = r.read(r.long())
    sync = r.read(16)
    schema = json.loads(meta["avro.schema"].decode())
    if schema.get("type") != "record":
        raise ValueError("avro top-level schema must be a record")
    schema["_codec"] = meta.get("avro.codec", b"null").decode()
    return schema, sync


def avro_schema(path: str) -> Tuple[List[str], List[str]]:
    """Names + types from the file-metadata block only — the ParseSetup
    tier never decodes data blocks (cheap-schema pattern, like the
    parquet footer probe)."""
    with open(path, "rb") as f:
        head = f.read(1 << 20)          # metadata fits well under 1 MB
    schema, _sync = _read_header(_Reader(head))
    fields = schema["fields"]
    return [f["name"] for f in fields], _schema_types(fields)


def parse_avro_host(path: str) -> Tuple[Dict[str, np.ndarray], List[str],
                                        List[str]]:
    """-> (cols, names, types) with types in the framework vocabulary
    (real / enum / string)."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    schema, sync = _read_header(r)
    codec = schema["_codec"]
    fields = schema["fields"]
    names = [f["name"] for f in fields]
    rows: List[list] = []
    while not r.eof():
        count = r.long()
        size = r.long()
        block = r.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec != "null":
            raise ValueError(f"avro codec {codec!r} not supported "
                             "(null/deflate only)")
        br = _Reader(block)
        for _ in range(count):
            rows.append([_read_value(br, f["type"]) for f in fields])
        if r.read(16) != sync:
            raise ValueError("avro sync marker mismatch (corrupt file)")
    cols: Dict[str, np.ndarray] = {}
    types: List[str] = []
    for j, fld in enumerate(fields):
        bt = _base_type(fld["type"])
        vals = [row[j] for row in rows]
        if bt in ("int", "long", "float", "double", "boolean"):
            cols[names[j]] = np.asarray(
                [np.nan if v is None else float(v) for v in vals], np.float64)
            types.append("real")
        elif bt == "enum":
            cols[names[j]] = np.asarray(
                ["" if v is None else str(v) for v in vals], object)
            types.append("enum")
        else:                                       # string / bytes / null
            cols[names[j]] = np.asarray(
                ["" if v is None else
                 (v.decode(errors="replace") if isinstance(v, bytes) else
                  str(v)) for v in vals], object)
            types.append("string")
    return cols, names, types


# ---------------------------------------------------------------------------
# writer (tests + export parity; enough of the spec to round-trip)
# ---------------------------------------------------------------------------

def _zigzag(n: int) -> bytes:
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def write_avro(path: str, cols: Dict[str, list], schema_fields: List[dict],
               codec: str = "null") -> str:
    """Minimal container writer (test fixture / export helper)."""
    schema = {"type": "record", "name": "frame",
              "fields": schema_fields}
    names = [f["name"] for f in schema_fields]
    n = len(cols[names[0]])
    body = bytearray()
    for i in range(n):
        for f in schema_fields:
            v = cols[f["name"]][i]
            t = f["type"]
            if isinstance(t, list):                 # ["null", X]
                if v is None:
                    body += _zigzag(0)
                    continue
                body += _zigzag(1)
                t = [s for s in t if s != "null"][0]
            if t in ("int", "long"):
                body += _zigzag(int(v))
            elif t == "double":
                body += struct.pack("<d", float(v))
            elif t == "float":
                body += struct.pack("<f", float(v))
            elif t == "boolean":
                body += bytes([1 if v else 0])
            elif t == "string":
                raw = str(v).encode()
                body += _zigzag(len(raw)) + raw
            else:
                raise ValueError(f"writer: unsupported type {t!r}")
    payload = bytes(body)
    if codec == "deflate":
        co = zlib.compressobj(wbits=-15)
        payload = co.compress(payload) + co.flush()
    sync = b"\x07" * 16
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    out.write(_zigzag(len(meta)))
    for k, v in meta.items():
        out.write(_zigzag(len(k)) + k.encode())
        out.write(_zigzag(len(v)) + v)
    out.write(_zigzag(0))
    out.write(sync)
    out.write(_zigzag(n))
    out.write(_zigzag(len(payload)))
    out.write(payload)
    out.write(sync)
    with open(path, "wb") as f:
        f.write(out.getvalue())
    return path
