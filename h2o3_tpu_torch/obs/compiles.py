"""The compile ledger (counterpart of h2o3_tpu/obs/compiles.py), for
``GET /3/Runtime`` and the ``h2o3_compile_ledger_*`` series.

The reference routes every XLA compile through one chokepoint. The port
compiles other things, and each records one ledger row here, with the
same fields: program family (closed :data:`FAMILIES` enumeration),
signature hash, wall ms, cache disposition (compile | memory | disk),
device kind, and the device bytes the program's first run measured
where the caller has them. What the port records:

- ``scoring`` / ``explain``: the CUDA-graph capture of a scoring
  session's bucket program (scoring.py, `BucketProgram._capture`);
- ``rapids``: the capture of a fused Rapids program (rapids/fusion.py);
- ``pipeline``: a munge→score program built (pipeline.py);
- ``train``: DeepLearning's captured step loop (models/deeplearning.py);
- ``artifact``: a ``torch.export`` program of artifact/export.py;
- ``kernel``: an ``nvcc`` build of a CUDA kernel (kernels.py) or the
  ``g++`` build of the host library (native.py).

A program found in its cache is a hit (:func:`record_hit`): the
scoring sessions' bucket programs and the fused Rapids and pipeline
programs record theirs, so the per-family table tells hit ratios, not
only compile counts. The
families that fed ``artifact/compile_cache.note_compile`` before the
ledger (scoring, explain, rapids, artifact) still do, from here: one
writer, no drift.

Import cost: stdlib only."""

from __future__ import annotations

import collections
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional

# closed program-family enumeration: the reference's names where the
# port compiles the same thing, plus train (DeepLearning's captured step
# loop) and kernel (nvcc/g++ builds), which the reference compiles
# through XLA or not at all
FAMILIES = frozenset({"scoring", "explain", "rapids", "pipeline",
                      "artifact", "train", "kernel"})

# families whose compiles feed artifact/compile_cache.note_compile
_CACHED_FAMILIES = ("scoring", "explain", "rapids", "artifact")

_LOCK = threading.Lock()
_ROWS: "collections.deque[dict]" = collections.deque(maxlen=512)
_AGG: Dict[str, Dict[str, float]] = {}
# (family, tier) -> hit count, bumped LOCK-FREE on the warm dispatch
# path and folded into family_table() at read time
_HIT_COUNTS: Dict[tuple, int] = {}


def _check(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown compile family {family!r}; the "
                         f"enumeration is closed: {sorted(FAMILIES)}")


def _sig(signature: Any) -> str:
    """Stable short hash of whatever signature material the caller has
    (model checksum + bucket, an AST signature, a geometry tuple)."""
    raw = signature if isinstance(signature, str) else repr(signature)
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def _device_kind() -> Optional[str]:
    """The booted device's identity ("cuda/<name>" or "cpu"), None
    before a boot. Never initializes CUDA itself."""
    import sys

    rt = sys.modules.get("h2o3_tpu_torch.core.runtime")
    cl = getattr(rt, "_CLUSTER", None) if rt else None
    if cl is None:
        return None
    dev = cl.device
    if dev.type != "cuda":
        return dev.type
    try:
        import torch

        return f"cuda/{torch.cuda.get_device_name(dev)}"
    except Exception:   # noqa: BLE001
        return "cuda"


def _agg_for(family: str) -> Dict[str, float]:
    a = _AGG.get(family)
    if a is None:
        a = _AGG[family] = {"compiles": 0, "hits_memory": 0, "hits_disk": 0,
                            "ms_total": 0.0, "ms_max": 0.0}
    return a


def _append(row: dict) -> None:
    with _LOCK:
        _ROWS.append(row)
        a = _agg_for(row["family"])
        a["compiles"] += 1
        a["ms_total"] += row["ms"]
        a["ms_max"] = max(a["ms_max"], row["ms"])


def record_compile(family: str, signature: Any, ms: float,
                   program: Optional[str] = None,
                   hbm_bytes: Optional[int] = None) -> dict:
    """One program built (a capture, an export, a compiler run) in `ms`
    wall milliseconds; `hbm_bytes` is the device memory its first run
    took, where the caller measured it."""
    _check(family)
    row = {"ts": time.time(), "family": family, "signature": _sig(signature),
           "ms": round(float(ms), 3), "cache": "compile",
           "device_kind": _device_kind(), "program": program,
           "hbm_bytes": int(hbm_bytes) if hbm_bytes is not None else None}
    _append(row)
    if family in _CACHED_FAMILIES:
        from h2o3_tpu_torch.artifact import compile_cache

        compile_cache.note_compile(row["ms"])
    return row


class timed:
    """``with compiles.timed(family, signature, program): build()``
    records one compile row with the block's wall time, if the block
    returns normally."""

    def __init__(self, family: str, signature: Any = None,
                 program: Optional[str] = None):
        _check(family)
        self.family, self.signature, self.program = \
            family, signature, program
        self.hbm_bytes: Optional[int] = None
        self.row: Optional[dict] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.row = record_compile(
                self.family, self.signature if self.signature is not None
                else self.program, (time.perf_counter() - self._t0) * 1000,
                program=self.program, hbm_bytes=self.hbm_bytes)
        return False


def record_hit(family: str, tier: str = "memory") -> None:
    """A compile AVOIDED: `tier` is ``memory`` (a program found in its
    in-process cache) or ``disk`` (an export found in the compile
    cache's disk tier). Hits bump the per-family aggregate ONLY — they
    never consume the bounded compile-row ring (warm traffic would
    otherwise evict every ``cache="compile"`` row and empty
    /3/Runtime's slowest-N on exactly the long-lived servers it exists
    for), and the warm path pays no signature hashing or device
    lookup."""
    _check(family)
    if tier not in ("memory", "disk"):
        raise ValueError(f"unknown cache tier {tier!r}")
    # lock-free counter bump: this runs once per warm fused dispatch (the
    # hottest path in the engine), which must not serialize on the same
    # process-wide lock compile recording and /3/Runtime snapshots take.
    # A GIL-raced lost increment on an observability ratio is acceptable;
    # family_table() folds these in at read time.
    k = (family, tier)
    _HIT_COUNTS[k] = _HIT_COUNTS.get(k, 0) + 1


# ---------------------------------------------------------------------------
# snapshots / cluster aggregation (GET /3/Runtime)
# ---------------------------------------------------------------------------

def ledger_rows(n: Optional[int] = None) -> List[dict]:
    with _LOCK:
        rows = list(_ROWS)
    return rows[-n:] if n else rows


def family_table() -> Dict[str, Dict[str, float]]:
    with _LOCK:
        out = {f: dict(a) for f, a in _AGG.items()}
    for (fam, tier), n in list(_HIT_COUNTS.items()):
        a = out.setdefault(fam, {"compiles": 0, "hits_memory": 0,
                                 "hits_disk": 0, "ms_total": 0.0,
                                 "ms_max": 0.0})
        a["hits_memory" if tier == "memory" else "hits_disk"] = n
    return out


def slowest(n: int = 10) -> List[dict]:
    rows = [r for r in ledger_rows() if r["cache"] == "compile"]
    return sorted(rows, key=lambda r: r["ms"], reverse=True)[:max(n, 0)]


def snapshot(slowest_n: int = 10) -> dict:
    return {"families": family_table(), "slowest": slowest(slowest_n),
            "rows_recorded": len(ledger_rows())}


def _proc_index() -> int:
    from h2o3_tpu_torch.parallel import distributed as D

    return D.process_index()


def runtime_snapshot(slowest_n: int = 10) -> dict:
    """This process's /3/Runtime contribution: the phase summary and the
    ledger (``GET /3/Runtime`` serves the phase history beside it)."""
    from h2o3_tpu_torch.obs import phases

    return {"proc": _proc_index(), "ts": time.time(),
            "phase_report": phases.phase_report(),
            "compiles": snapshot(slowest_n)}


_KV_PREFIX = "obs/runtime/"


def publish_runtime() -> bool:
    """Publish this process's runtime snapshot to the cloud KV (with the
    metrics' throttled publish) so the coordinator's /3/Runtime is the
    cloud's."""
    import json

    from h2o3_tpu_torch.parallel import distributed as D

    try:
        return D.kv_put(_KV_PREFIX + str(_proc_index()),
                        json.dumps(runtime_snapshot(), default=str))
    except Exception:   # noqa: BLE001 — best effort by contract
        return False


def cluster_runtime(slowest_n: int = 10) -> List[dict]:
    """This process's live snapshot and every other process's published
    one (remote rows carry their publish default, 10 slowest)."""
    import json

    from h2o3_tpu_torch.parallel import distributed as D

    me = _proc_index()
    out = [runtime_snapshot(slowest_n)]
    for _k, v in D.kv_dir(_KV_PREFIX):
        try:
            rec = json.loads(v)
        except (ValueError, TypeError):
            continue
        if isinstance(rec, dict) and rec.get("proc") != me:
            out.append(rec)
    return out


def merge_family_tables(tables: List[Dict[str, dict]]) -> Dict[str, dict]:
    """Per-family aggregates summed across processes (ms_max the max)."""
    merged: Dict[str, dict] = {}
    for table in tables:
        for fam, a in (table or {}).items():
            m = merged.setdefault(fam, {"compiles": 0, "hits_memory": 0,
                                        "hits_disk": 0, "ms_total": 0.0,
                                        "ms_max": 0.0})
            for k in ("compiles", "hits_memory", "hits_disk", "ms_total"):
                m[k] += a.get(k, 0)
            m["ms_max"] = max(m["ms_max"], a.get("ms_max", 0.0))
    return merged


def reset_for_tests() -> None:
    with _LOCK:
        _ROWS.clear()
        _AGG.clear()
    _HIT_COUNTS.clear()
