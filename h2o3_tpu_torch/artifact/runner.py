"""Standalone scorer of an artifact directory (counterpart of
h2o3_genmodel/aot.py `AotScorer` :111, `load_artifact` :496 and
h2o3_genmodel/aot_predict.py).

It imports torch, numpy and the standard library, and nothing of the
training stack. Run it as a file path, so the package's own
``__init__`` (which imports every model) never runs:

    python h2o3_tpu_torch/artifact/runner.py --artifact DIR \\
        --input in.csv --output out.csv [--raw-npz raw.npz] [--device cpu]

A pipeline artifact (``model_type`` "pipeline", artifact/pipeline.py)
scores raw rows: its programs compute the engineered features and run
the model core in one program, over the raw inputs the manifest names.

``--device`` defaults to ``cuda`` and fails when there is no card. On
the card each row bucket's exported program (``program_b{N}.pt2``) runs
eagerly once and is then captured in a CUDA graph of its own; later
requests copy their rows into the bucket's static inputs and replay. A
replay overwrites the static outputs, so every window's rows are copied
out first. Matmuls run in full float32 (TF32 off), as the package pins
them in process. ``--raw-npz`` also writes the margins (or a GLM's
response) and the probabilities or values: the handle for comparing
with in-process serving.

Every payload is read through the manifest's sha256 gate before any of
its bytes are interpreted; the npz is read with ``allow_pickle=False``,
and ``torch.export.load`` runs only on bytes whose digest matched.
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import io
import json
import os
import sys
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

_FORMAT = "h2o3-tpu-aot-artifact"
_FORMAT_VERSION = 1


class ArtifactError(ValueError):
    """Malformed, tampered or incompatible artifact."""


# ---------------------------------------------------------------------------
# manifest and payloads (the standalone twin of artifact/manifest.py)
# ---------------------------------------------------------------------------

def _read_manifest(art_dir: str) -> Dict[str, Any]:
    path = os.path.join(art_dir, "manifest.json")
    try:
        with open(path, encoding="utf-8") as f:
            m = json.load(f)
    except (OSError, ValueError) as e:
        raise ArtifactError(f"no readable manifest in {art_dir!r}: {e}") \
            from None
    if not isinstance(m, dict) or m.get("format") != _FORMAT:
        raise ArtifactError(f"not an {_FORMAT} artifact")
    ver = m.get("format_version")
    if not isinstance(ver, int) or not 1 <= ver <= _FORMAT_VERSION:
        raise ArtifactError(
            f"artifact format_version {ver!r} unsupported by this runtime "
            f"(supports 1..{_FORMAT_VERSION})")
    for key in ("model_category", "names", "files", "buckets", "post",
                "max_depth", "nclasses", "init_f", "model_checksum"):
        if key not in m:
            raise ArtifactError(f"manifest missing required key {key!r}")
    return m


def _read_payload(art_dir: str, entry: Dict[str, Any]) -> bytes:
    name = str(entry.get("name") or "")
    if not name or os.path.basename(name) != name or name.startswith("."):
        raise ArtifactError(f"illegal payload file name {name!r}")
    try:
        with open(os.path.join(art_dir, name), "rb") as f:
            data = f.read()
    except OSError as e:
        raise ArtifactError(f"payload {name!r} unreadable: {e}") from None
    if hashlib.sha256(data).hexdigest() != entry.get("sha256"):
        raise ArtifactError(f"payload {name!r} checksum mismatch — "
                            "artifact is corrupt or was tampered with")
    return data


def _padded_edges(flat: np.ndarray, lens: np.ndarray, F: int) -> np.ndarray:
    lens = [int(v) for v in np.asarray(lens).reshape(-1)]
    ep = np.full((F, max(lens, default=0) or 1), np.inf, np.float32)
    pos = 0
    for i, ln in enumerate(lens):
        ep[i, :ln] = np.asarray(flat[pos: pos + ln], np.float32)
        pos += ln
    return ep


def _resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to score on "
                           "the CPU")
    return dev


# ---------------------------------------------------------------------------
# one row bucket: static inputs, and a CUDA graph on the card
# ---------------------------------------------------------------------------

class _Bucket:
    """A bucket's program over static inputs of `bucket` rows. The first
    run is eager; on the card it is then captured, and later runs copy
    their rows in and replay. `run` returns the first m output rows as a
    tensor no replay writes."""

    def __init__(self, program, statics: List[torch.Tensor],
                 consts: tuple, device: torch.device):
        self.program = program
        self.statics = statics
        self.consts = consts
        self.device = device
        self.graph = None
        self.out = None
        self.ran = False

    def run(self, cols: List[torch.Tensor], m: int) -> torch.Tensor:
        for st, c in zip(self.statics, cols):
            st[:m].copy_(c)
            st[m:].zero_()
        if self.graph is not None:
            self.graph.replay()
            return self.out[:m].clone()
        out = self.program(*self.statics, *self.consts)
        if self.device.type == "cuda" and not self.ran:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, capture_error_mode="thread_local"):
                self.out = self.program(*self.statics, *self.consts)
            self.graph = g
        self.ran = True
        return out[:m]


# ---------------------------------------------------------------------------
# the scorer
# ---------------------------------------------------------------------------

class AotScorer:
    """One loaded artifact: its arrays on the device and one exported
    program per row bucket, loaded and captured at first use."""

    def __init__(self, art_dir: str, device: str = "cuda",
                 pin_float32: bool = True):
        self.dir = str(art_dir)
        self.device = _resolve_device(device)
        if pin_float32:
            # full float32 matmuls: a GLM's TF32 product would drift ~1e-3
            # (the package's loader scores inside its own full_float32)
            torch.set_float32_matmul_precision("highest")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        m = _read_manifest(self.dir)
        self.manifest = m
        self.model_type = str(m.get("model_type") or "forest")
        if self.model_type not in ("forest", "glm", "pipeline"):
            raise ArtifactError(f"this runner scores forest, glm and "
                                f"pipeline artifacts, not "
                                f"{self.model_type!r}")
        # a pipeline's programs take the raw (n, R) matrix; its inner
        # model's arrays are the program inputs after it
        inner = self.model_type
        if inner == "pipeline":
            p = m.get("pipeline")
            if not isinstance(p, dict) or "pipeline" not in m["files"]:
                raise ArtifactError("pipeline artifact manifest missing its "
                                    "'pipeline' block or payload")
            _read_payload(self.dir, m["files"]["pipeline"])
            inner = str(p.get("inner"))
            if inner not in ("forest", "glm"):
                raise ArtifactError(f"pipeline artifact wraps unsupported "
                                    f"inner model {inner!r}")
        self.names: List[str] = list(m["names"])
        self.category = str(m["model_category"])
        self.response_domain: List[str] = list(m.get("response_domain")
                                               or [])
        self.default_threshold = float(m.get("default_threshold", 0.5))
        self.post: Dict[str, Any] = dict(m["post"])
        self.buckets: List[int] = sorted(int(b) for b in m["buckets"])
        self.nclasses = int(m["nclasses"])
        self.per_class = bool(m.get("per_class_trees"))
        self.domains: Dict[str, List[str]] = {
            k: list(v) for k, v in (m.get("domains") or {}).items()}
        payload = m["files"][inner]
        with np.load(io.BytesIO(_read_payload(self.dir, payload)),
                     allow_pickle=False) as z:
            a = {k: np.asarray(z[k]) for k in z.files}
        F = len(self.names)
        dev = self.device

        def t(x, dtype):
            return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

        if inner == "glm":
            g = m.get("glm")
            if not isinstance(g, dict) or (
                    self.model_type == "glm" and
                    int(g.get("n_cat", 0)) + int(g.get("n_num", 0)) != F):
                raise ArtifactError("glm layout disagrees with manifest "
                                    "names")
            self.n_cat = int(g["n_cat"])
            self.consts = (t(a["beta"], torch.float32),
                           t(a["cat_modes"], torch.long),
                           t(a["impute_values"], torch.float32),
                           t(a["num_means"], torch.float32),
                           t(a["num_sigmas"], torch.float32))
        else:
            if self.model_type == "forest" and \
                    int(a["spec_is_cat"].shape[0]) != F:
                raise ArtifactError("packed spec width disagrees with "
                                    "manifest names")
            init = (np.asarray(a["init_class"], np.float32)
                    if "init_class" in a else np.float32(m["init_f"]))
            self.consts = (
                t(_padded_edges(a["spec_edges_flat"], a["spec_edges_len"], F),
                  torch.float32),
                t(a["spec_is_cat"].astype(bool), torch.bool),
                t(init, torch.float32),
                t(a["feat"], torch.long), t(a["thresh_bin"], torch.long),
                t(a["na_left"].astype(bool), torch.bool),
                t(a["left"], torch.long), t(a["right"], torch.long),
                t(a["leaf_val"], torch.float32),
                t(a["cat_split"], torch.long),
                t(a["cat_table"].astype(bool), torch.bool),
                t(a["na_bins"], torch.long))
        self._buckets: Dict[int, _Bucket] = {}
        self._lock = threading.Lock()

    # -- programs -----------------------------------------------------------
    def _bucket(self, bucket: int) -> _Bucket:
        b = self._buckets.get(bucket)
        if b is not None:
            return b
        entry = next((e for e in self.manifest.get("programs", [])
                      if int(e.get("bucket", -1)) == bucket), None)
        if entry is None:
            raise ArtifactError(f"artifact has no program for bucket "
                                f"{bucket}")
        data = _read_payload(self.dir, entry)
        # programs are exported from CPU example inputs: their tensor-
        # metadata checks name the CPU until moved to this device
        ep = move_to_device_pass(torch.export.load(io.BytesIO(data)),
                                 self.device)
        program = ep.module()
        dev, F = self.device, len(self.names)
        if self.model_type == "glm":
            statics = ([torch.zeros(bucket, dtype=torch.int32, device=dev)
                        for _ in range(self.n_cat)]
                       + [torch.zeros(bucket, dtype=torch.float32,
                                      device=dev)
                          for _ in range(F - self.n_cat)])
        else:
            statics = [torch.zeros((bucket, F), dtype=torch.float32,
                                   device=dev)]
        b = self._buckets[bucket] = _Bucket(program, statics, self.consts,
                                            dev)
        return b

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _columns(self, X: torch.Tensor) -> List[torch.Tensor]:
        """The program's per-request inputs: the (m, F) matrix for a
        forest or a pipeline; for a GLM int32 categorical codes (NaN ->
        -1) then float32 numerics."""
        if self.model_type != "glm":
            return [X]
        cols = [torch.where(torch.isnan(X[:, i]), -1.0, X[:, i])
                .to(torch.int32) for i in range(self.n_cat)]
        return cols + [X[:, j] for j in range(self.n_cat, X.shape[1])]

    def _run(self, X: torch.Tensor) -> torch.Tensor:
        """Program outputs of X's rows, chunked at the largest bucket."""
        maxb = self.buckets[-1]
        outs = []
        with self._lock:
            for pos in range(0, X.shape[0], maxb):
                chunk = X[pos: pos + maxb]
                m = chunk.shape[0]
                outs.append(self._bucket(self._bucket_for(m))
                            .run(self._columns(chunk), m))
        if not outs:
            K = self.nclasses if (self.nclasses > 2 or self.per_class) else 1
            return torch.zeros((0,) if K == 1 else (0, K),
                               dtype=torch.float32, device=self.device)
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    # -- feature packing ----------------------------------------------------
    def pack_features(self, cols: Dict[str, Any]) -> np.ndarray:
        """(n, F) float32 matrix in training-column order: numerics as
        floats (missing or unparseable -> NaN), categoricals as training-
        domain codes (unseen or missing -> -1, the NA bin)."""
        n = 0
        for v in cols.values():
            n = max(n, len(np.asarray(v, dtype=object).reshape(-1)))
        X = np.empty((n, len(self.names)), np.float32)
        for i, name in enumerate(self.names):
            dom = self.domains.get(name)
            raw = cols.get(name)
            if raw is None:
                X[:, i] = -1.0 if dom is not None else np.nan
                continue
            vals = np.asarray(raw, dtype=object).reshape(-1)
            if dom is not None:
                lut = {str(lvl): k for k, lvl in enumerate(dom)}
                X[:, i] = [lut.get(str(v).strip(), -1)
                           if v is not None and str(v).strip() != ""
                           else -1 for v in vals]
            else:
                X[:, i] = [_as_float(v) for v in vals]
        return X

    # -- scoring --------------------------------------------------------------
    def margins(self, X: np.ndarray) -> np.ndarray:
        """(n,) or (n, K) float32 program outputs: a forest's margins, a
        GLM's response (its probabilities for a multinomial)."""
        Xd = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        return self._run(Xd).cpu().numpy()

    def _out_key(self) -> str:
        return "probs" if self.post.get("kind") in (
            "binomial", "multinomial", "glm_binomial",
            "glm_multinomial") else "value"

    def _post(self, f: torch.Tensor) -> torch.Tensor:
        """Margins -> probabilities or values, with the operations of
        SharedTreeModel._margin_to_raw (the GLM program already applied
        its inverse link)."""
        kind = self.post.get("kind")
        if kind in ("binomial", "glm_binomial"):
            p = 1.0 / (1.0 + torch.exp(-f)) if kind == "binomial" else f
            return torch.stack([1 - p, p], dim=-1)
        if kind == "multinomial":
            e = torch.exp(f - torch.amax(f, dim=-1, keepdim=True))
            return e / torch.sum(e, dim=-1, keepdim=True)
        if kind == "regression" and self.post.get("linkinv") == "exp":
            return torch.exp(f)
        return f

    def raw_predict(self, X: np.ndarray) -> Dict[str, np.ndarray]:
        """Program and post-processing on the device, one host fetch."""
        Xd = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        return {self._out_key(): self._post(self._run(Xd)).cpu().numpy()}

    def raw_from_margins(self, margins: np.ndarray) -> Dict[str, np.ndarray]:
        f = torch.as_tensor(margins, device=self.device)
        return {self._out_key(): self._post(f).cpu().numpy()}

    def score(self, cols: Dict[str, Any],
              raw: Optional[Dict[str, np.ndarray]] = None
              ) -> Dict[str, np.ndarray]:
        """Raw columns -> the predict frame's columns (predict, then one
        probability column per class). `raw` labels a result already
        computed by raw_predict or raw_from_margins."""
        if raw is None:
            raw = self.raw_predict(self.pack_features(cols))
        out: Dict[str, np.ndarray] = {}
        if "probs" in raw:
            probs = np.asarray(raw["probs"])
            dom = self.response_domain or [str(i)
                                           for i in range(probs.shape[1])]
            if self.category == "Binomial":
                label = (probs[:, 1] >= self.default_threshold).astype(int)
            else:
                label = probs.argmax(axis=-1)
            out["predict"] = np.asarray([dom[i] for i in label], object)
            for k, lvl in enumerate(dom):
                out[str(lvl)] = probs[:, k]
        else:
            out["predict"] = np.asarray(raw["value"])
        return out


def _as_float(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


def load_artifact(art_dir: str, device: str = "cuda") -> AotScorer:
    """Load an artifact directory into a standalone scorer."""
    return AotScorer(art_dir, device)


def read_csv_columns(path: str, sep: str = ",") -> Dict[str, List[str]]:
    """A headered CSV as {column: [string values]} (blank -> None)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter=sep))
    if not rows:
        return {}
    header = [h.strip() for h in rows[0]]
    cols: Dict[str, List[Any]] = {h: [] for h in header}
    for r in rows[1:]:
        for i, h in enumerate(header):
            v = r[i].strip() if i < len(r) else ""
            cols[h].append(v if v != "" else None)
    return cols


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Score a CSV with an h2o3 scoring artifact.")
    ap.add_argument("--artifact", required=True,
                    help="artifact directory (manifest.json + payloads)")
    ap.add_argument("--input", required=True, help="input CSV (headered)")
    ap.add_argument("--output", help="output CSV (default: stdout)")
    ap.add_argument("--separator", default=",", help="field separator")
    ap.add_argument("--raw-npz",
                    help="also write the margins and probabilities here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    scorer = load_artifact(args.artifact, args.device)
    cols = read_csv_columns(args.input, args.separator)
    margins = scorer.margins(scorer.pack_features(cols))
    raw = scorer.raw_from_margins(margins)
    if args.raw_npz:
        np.savez(args.raw_npz, margins=margins, **raw)
    out = scorer.score(cols, raw=raw)
    names = list(out)
    mats = [np.asarray(out[nm]).reshape(-1) for nm in names]
    sink = open(args.output, "w", newline="") if args.output else sys.stdout
    try:
        w = csv.writer(sink)
        w.writerow(names)
        for i in range(len(mats[0]) if mats else 0):
            w.writerow([col[i] for col in mats])
    finally:
        if args.output:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
