"""Packed-constant codecs: forest and BinSpec arrays <-> ``forest.npz``
(counterpart of h2o3_tpu/artifact/packer.py; the npz layout and
`model_checksum` are the reference's byte for byte, so a forest carried
across packs to the same bytes and the same checksum in both packages).

The exporter packs a trained forest and its BinSpec into one
``forest.npz`` (``allow_pickle=False`` end to end: arrays are the whole
payload). `pack_tree_chunk`/`unpack_tree_chunk` (reference :132, :150)
carry a tree loop's durable progress (parallel/ckpt.py): a run of
per-tree tables stacked into one npz. The reference rounds the leaf
values and leaf (w, w·y) sums to float32; the port keeps each array's
own dtype, so a resumed forest is the uninterrupted one bit for bit
whatever the tables hold.
"""

from __future__ import annotations

import hashlib
import io
import json
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# forest + spec <-> npz
# ---------------------------------------------------------------------------

def pack_forest(forest, spec) -> Dict[str, np.ndarray]:
    """Dense arrays for a CompressedForest + BinSpec (the MOJO payload
    layout, field-compatible with models/mojo.py)."""
    arrays = {
        "feat": np.asarray(forest.feat, np.int32),
        "thresh_bin": np.asarray(forest.thresh_bin, np.int32),
        "na_left": np.asarray(forest.na_left).astype(np.int8),
        "left": np.asarray(forest.left, np.int32),
        "right": np.asarray(forest.right, np.int32),
        "leaf_val": np.asarray(forest.leaf_val, np.float32),
        "cat_split": np.asarray(forest.cat_split, np.int32),
        "cat_table": np.asarray(forest.cat_table).astype(np.int8),
        "tree_class": np.asarray(forest.tree_class, np.int32),
        "na_bins": np.asarray(forest.na_bins, np.int32),
        "spec_nbins": np.asarray(spec.nbins, np.int64),
        "spec_is_cat": np.asarray(spec.is_cat).astype(np.int8),
        "spec_cards": np.asarray(spec.cards, np.int64),
        "spec_edges_flat": (np.concatenate(
            [np.asarray(e, np.float64) for e in spec.edges])
            if spec.edges else np.zeros(0)),
        "spec_edges_len": np.asarray([len(e) for e in spec.edges], np.int64),
    }
    if forest.init_class is not None:
        arrays["init_class"] = np.asarray(forest.init_class, np.float32)
    return arrays


def forest_meta(forest, spec) -> Dict[str, Any]:
    return {"max_depth": int(forest.max_depth),
            "init_f": float(forest.init_f),
            "nclasses": int(forest.nclasses),
            "per_class_trees": bool(forest.per_class_trees),
            "n_trees": int(forest.n_trees),
            "spec_names": list(spec.names)}


def dump_npz(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def load_npz(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: np.asarray(z[k]) for k in z.files}


def model_checksum(forest, spec) -> str:
    """Content hash of everything that shapes the fused scoring program:
    the packed arrays plus the scalar forest meta. The persistent compile
    cache and the artifact manifest both key on it, so a retrained model
    under the same DKV key can never be served a stale executable."""
    h = hashlib.sha256()
    arrays = pack_forest(forest, spec)
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(json.dumps(forest_meta(forest, spec), sort_keys=True).encode())
    return h.hexdigest()


def padded_edges(edges_flat: np.ndarray, edges_len: np.ndarray,
                 F: int) -> np.ndarray:
    """(F, emax) float32 +inf-padded edge matrix, as BinSpec.padded_edges
    builds it for in-process scoring."""
    lens = [int(v) for v in np.asarray(edges_len).reshape(-1)]
    emax = max(lens, default=0) or 1
    ep = np.full((F, emax), np.inf, np.float32)
    pos = 0
    for i, ln in enumerate(lens):
        ep[i, :ln] = np.asarray(edges_flat[pos: pos + ln], np.float32)
        pos += ln
    return ep


# ---------------------------------------------------------------------------
# tree-progress chunks (append-only job-progress files)
# ---------------------------------------------------------------------------

def pack_tree_chunk(packs: Sequence[np.ndarray],
                    leaf_vals: Sequence[np.ndarray],
                    leaf_wys: Sequence[np.ndarray]) -> bytes:
    """A contiguous run of trees' tables, stacked (every tree of a run
    has the same shapes) and npz-encoded, with their count `n`."""
    n = len(packs)
    if not (n == len(leaf_vals) == len(leaf_wys)):
        raise ValueError("tree chunk lists disagree in length")
    return dump_npz({"n": np.asarray([n], np.int64),
                     "packs": np.stack([np.asarray(p) for p in packs]),
                     "leaf_vals": np.stack([np.asarray(v)
                                            for v in leaf_vals]),
                     "leaf_wys": np.stack([np.asarray(w)
                                           for w in leaf_wys])})


def unpack_tree_chunk(data: bytes) -> Tuple[List[np.ndarray],
                                            List[np.ndarray],
                                            List[np.ndarray]]:
    arrays = load_npz(data)
    n = int(arrays["n"][0])
    if any(arrays[k].shape[0] != n for k in ("packs", "leaf_vals",
                                             "leaf_wys")):
        raise ValueError("torn tree chunk: stack lengths disagree with n")
    return ([arrays["packs"][i] for i in range(n)],
            [arrays["leaf_vals"][i] for i in range(n)],
            [arrays["leaf_wys"][i] for i in range(n)])
