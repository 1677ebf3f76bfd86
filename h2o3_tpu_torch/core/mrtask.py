"""MRTask: map over a rank's rows, reduce across the ranks (counterpart of
h2o3_tpu/core/mrtask.py: `map_reduce` :62, `map_chunks` :99,
`new_column` :107, `LocalMR` :115).

Reference design: fork/join map/reduce over chunks with a binary-tree
RPC fan-out (water/MRTask.java), which the JAX package turns into a
``shard_map`` body and a ``psum``. Here the map is `fn` on this rank's
block of each column's rows, on its device, and the reduce is a SUM
all-reduce of its partials across the row mesh (parallel/mesh.py). In
one process the partials are the result.

- `map_reduce(fn, cols)`: fn(*shard_tensors) -> a tensor, or a dict,
  list or tuple of tensors, of partials; returns them summed over the
  ranks (each partial all-reduced in its own dtype: sum float64
  partials for results that must not depend on the split into ranks).
- `map_chunks(fn, cols)`: fn(*shard_tensors) -> row-aligned output(s) of
  this rank's rows; `new_column` wraps one as a Column.

Under ``H2O_TPU_PROFILE=1`` each `map_reduce` emits its map, reduce and
sync times to the TimeLine (the reference's MRTask profile); the
``mrtask.map_reduce`` fault point fires on every call.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Sequence

import torch

from h2o3_tpu_torch.core.frame import Column


def profiling() -> bool:
    """``H2O_TPU_PROFILE=1``: map_reduce records its phase times."""
    return os.environ.get("H2O_TPU_PROFILE", "0") == "1"


def _mesh(cols, mesh):
    if mesh is not None:
        return mesh
    from h2o3_tpu_torch.core.sharded_frame import mesh_of

    return mesh_of(cols[0]) if cols else None


def _reduce(tree, mesh):
    if mesh is None:
        return tree
    if isinstance(tree, torch.Tensor):
        return mesh.all_reduce(tree.contiguous(), "sum")
    if isinstance(tree, dict):
        return {k: _reduce(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_reduce(v, mesh) for v in tree)
    raise TypeError(f"map_reduce partials must be tensors, not "
                    f"{type(tree).__name__}")


def map_reduce(fn: Callable, cols: Sequence[Column], mesh=None):
    """fn over this rank's rows of `cols`, its partials summed over the
    row mesh (`mesh`, default: the one the columns are sharded over)."""
    from h2o3_tpu_torch.core.failure import faultpoint
    from h2o3_tpu_torch.utils import timeline

    faultpoint("mrtask.map_reduce")
    m = _mesh(cols, mesh)
    arrays = tuple(c.data for c in cols)
    if not profiling():
        return _reduce(fn(*arrays), m)
    t0 = time.perf_counter()
    part = fn(*arrays)
    t1 = time.perf_counter()
    out = _reduce(part, m)
    t2 = time.perf_counter()
    if arrays and arrays[0] is not None and arrays[0].device.type == "cuda":
        torch.cuda.synchronize(arrays[0].device)
    t3 = time.perf_counter()
    timeline.record("mrtask", getattr(fn, "__name__", "map_reduce"),
                    ms=(t3 - t0) * 1000, map_ms=(t1 - t0) * 1000,
                    reduce_ms=(t2 - t1) * 1000, sync_ms=(t3 - t2) * 1000,
                    ranks=m.size if m is not None else 1)
    return out


def map_chunks(fn: Callable, cols: Sequence[Column], n_out: int = 1):
    """fn over this rank's rows of `cols` -> row-aligned output(s) of
    those rows (the NewChunk path, water/MRTask.java:224-249)."""
    out = fn(*(c.data for c in cols))
    if n_out > 1 and len(out) != n_out:
        raise ValueError(f"map_chunks expected {n_out} outputs, got "
                         f"{len(out)}")
    return out


def new_column(fn: Callable, cols: Sequence[Column],
               ctype: Optional[str] = None) -> Column:
    """One output Column from input columns via a shard-local fn."""
    out = map_chunks(fn, cols, n_out=1)
    c0 = cols[0]
    return Column.from_device(out, ctype or c0.ctype, c0.nrows)


class LocalMR:
    """Node-local parallel loop (water/LocalMR.java): fn over the leading
    axis of `xs` (torch.vmap)."""

    @staticmethod
    def run(fn: Callable, xs):
        return torch.vmap(fn)(xs)
