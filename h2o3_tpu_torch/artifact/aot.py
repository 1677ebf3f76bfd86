"""Exported scoring programs (counterpart of h2o3_tpu/artifact/aot.py,
redesigned for torch).

The reference ships an XLA executable per row bucket plus its StableHLO
text. The port ships, per bucket, a ``torch.export`` ExportedProgram of
the walk core (``program_b{N}.pt2``): compressed.score_core for a
forest, the DataInfo expansion and glm_predict for a GLM. The forest's
arrays and tables, and a GLM's coefficients and moments, are program
inputs read from the artifact's npz, never buffers, and the example
inputs are dropped before saving, so a ``.pt2`` carries no tensor (its
state dict and constants are empty, and loading it unpickles nothing).
Only the
shape-defining scalars are baked in: max depth, the tree -> class map,
the class count, a GLM's layout and link. Programs are exported from
CPU example inputs and create tensors only with ``*_like`` factories,
so one file runs on the CPU and on the card. A CUDA graph cannot be
saved: a loader captures its own per bucket. Nothing is compiled;
``torch.compile`` and Inductor are not used.
"""

from __future__ import annotations

import io
from typing import Any, Dict

import numpy as np
import torch

from h2o3_tpu_torch import compat
from h2o3_tpu_torch.artifact import packer


def backend_fingerprint(device=None) -> str:
    """The torch version, the CUDA version, the device name and its
    compute capability (the booted device by default). Compile-cache
    keys carry it; a mismatch means 'export again here'."""
    if device is None:
        from h2o3_tpu_torch.core.runtime import cluster

        device = cluster().device
    dev = torch.device(device)
    parts = ["torch=" + torch.__version__, f"cuda={torch.version.cuda}"]
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        parts += ["device=" + torch.cuda.get_device_name(dev),
                  f"cc={major}.{minor}"]
    else:
        parts += ["device=cpu", "cc=none"]
    return ";".join(parts)


# -- forests -----------------------------------------------------------------

def forest_inputs(arrays: Dict[str, np.ndarray], init_f: float,
                  device="cpu") -> tuple:
    """score_core's tensor arguments after X, from the packed npz
    arrays: padded edges, the categorical mask, the init margin (the
    (K,) init_class or a 0-dim init_f), then the forest arrays (integer
    arrays as int64), as CompressedForest.arrays and ResidentForest
    build them."""
    F = int(arrays["spec_is_cat"].shape[0])
    edges = packer.padded_edges(arrays["spec_edges_flat"],
                                arrays["spec_edges_len"], F)
    init = (np.asarray(arrays["init_class"], np.float32)
            if "init_class" in arrays else np.float32(init_f))

    def t(a, dtype=None):
        x = torch.as_tensor(np.asarray(a), device=device)
        return x if dtype is None else x.to(dtype)

    return (t(edges), t(arrays["spec_is_cat"].astype(bool)), t(init),
            t(arrays["feat"], torch.long), t(arrays["thresh_bin"], torch.long),
            t(arrays["na_left"].astype(bool)), t(arrays["left"], torch.long),
            t(arrays["right"], torch.long),
            t(arrays["leaf_val"].astype(np.float32)),
            t(arrays["cat_split"], torch.long),
            t(arrays["cat_table"].astype(bool)),
            t(arrays["na_bins"], torch.long))


class ForestProgram(torch.nn.Module):
    """score_core with its shape-defining scalars fixed."""

    def __init__(self, max_depth: int, tree_class: tuple, K: int):
        super().__init__()
        self.max_depth = int(max_depth)
        self.tree_class = tuple(int(c) for c in tree_class)
        self.K = int(K)

    def forward(self, X, *inputs):
        from h2o3_tpu_torch.models.tree.compressed import score_core

        return score_core(X, *inputs, max_depth=self.max_depth,
                          tree_class=self.tree_class, K=self.K)


def n_margins(meta: Dict[str, Any]) -> int:
    """K of the (N, K) margins, or 1."""
    return (int(meta["nclasses"]) if int(meta["nclasses"]) > 2
            or bool(meta["per_class_trees"]) else 1)


def export_forest_bucket(bucket: int, meta: Dict[str, Any],
                         arrays: Dict[str, np.ndarray]) -> bytes:
    """The serialized ExportedProgram of one row bucket's scoring."""
    inputs = forest_inputs(arrays, float(meta["init_f"]))
    F = int(arrays["spec_is_cat"].shape[0])
    mod = ForestProgram(int(meta["max_depth"]),
                        tuple(np.asarray(arrays["tree_class"]).tolist()),
                        n_margins(meta))
    X = torch.zeros((int(bucket), F), dtype=torch.float32)
    return _save(compat.torch_export().export(mod, (X,) + inputs,
                                              strict=False))


# -- GLMs --------------------------------------------------------------------

def glm_inputs(arrays: Dict[str, np.ndarray], device="cpu") -> tuple:
    """The GLM program's inputs after the columns: beta, the categorical
    modes (int64), the NA fills, the means and the sigmas."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    return (t(arrays["beta"], torch.float32),
            t(arrays["cat_modes"], torch.long),
            t(arrays["impute_values"], torch.float32),
            t(arrays["num_means"], torch.float32),
            t(arrays["num_sigmas"], torch.float32))


class GLMProgram(torch.nn.Module):
    """DataInfo's expansion and glm_predict over per-column inputs
    (int32 categorical codes, NA negative; float32 numerics, NA NaN),
    with the layout and link fixed."""

    def __init__(self, meta: Dict[str, Any]):
        super().__init__()
        self.n_cat = int(meta["n_cat"])
        self.cards = tuple(int(c) for c in meta["cards"])
        self.use_all = bool(meta["use_all_factor_levels"])
        self.standardize = bool(meta["standardize"])
        self.linkname = str(meta["linkname"])
        self.link_power = float(meta["link_power"])
        K = int(meta["nclasses"])
        self.K = K if K > 2 else 1

    def forward(self, *args):
        from h2o3_tpu_torch.models.data_info import expand_columns
        from h2o3_tpu_torch.models.glm import glm_predict

        cols, (beta, modes, fill, means, sigmas) = args[:-5], args[-5:]
        X = expand_columns(cols, modes, fill, means, sigmas,
                           cards=self.cards,
                           use_all_factor_levels=self.use_all,
                           standardize=self.standardize, n_cat=self.n_cat)
        return glm_predict(X, beta, 0.0, linkname=self.linkname,
                           link_power=self.link_power, nclasses=self.K)


def glm_columns(meta: Dict[str, Any], bucket: int) -> tuple:
    n_cat, n_num = int(meta["n_cat"]), int(meta["n_num"])
    return (tuple(torch.zeros(int(bucket), dtype=torch.int32)
                  for _ in range(n_cat))
            + tuple(torch.zeros(int(bucket), dtype=torch.float32)
                    for _ in range(n_num)))


def export_glm_bucket(bucket: int, meta: Dict[str, Any],
                      arrays: Dict[str, np.ndarray]) -> bytes:
    """The serialized ExportedProgram of one row bucket's GLM scoring."""
    args = glm_columns(meta, bucket) + glm_inputs(arrays)
    return _save(compat.torch_export().export(GLMProgram(meta), args,
                                              strict=False))


# -- (de)serialization ---------------------------------------------------------

def _save(ep) -> bytes:
    # the example inputs would be saved too, a pickled copy of the
    # forest's arrays that the loader would unpickle: drop them
    ep.example_inputs = None
    buf = io.BytesIO()
    compat.torch_export().save(ep, buf)
    return buf.getvalue()


def load_program(data: bytes) -> torch.nn.Module:
    """Bytes of a saved ExportedProgram -> its callable module. A
    program saved by `_save` holds no tensors, so loading it unpickles
    nothing; callers still pass only bytes whose digest they checked."""
    return compat.torch_export().load(io.BytesIO(data)).module()
