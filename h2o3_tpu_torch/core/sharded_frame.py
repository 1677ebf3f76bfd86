"""The sharded data plane: a frame's rows held rank by rank, and the
packers that build task inputs from a rank's own rows (counterpart of
h2o3_tpu/core/sharded_frame.py: `ROW_AXIS`, the counters :54-94,
`shard_geometry` :104, `ShardedFrame` :277, `pack_features` :339,
`pack_binned` :368).

On a row-sharded cloud (parallel/mesh.py) rank r holds the contiguous
block `mesh.row_block(n, r, N)` of every column (core/frame.py). The
reference's chunk-locality rule holds here as it does there: no rank
pulls another's rows to build a task's input. `ShardedFrame.pack_binned`
bins a rank's rows for tree training and `pack_features` packs a
window of them for scoring, each on the rank's device.

Per-process counters make the no-gather property observable
(``GET /3/ScoringMetrics`` -> ``data_plane``, ``/3/Metrics``):
``packed_rows`` counts rows packed shard-locally, ``gathered_rows`` the
rows of sharded columns fetched to this process (`gather_column`, the
path of ``Column.to_numpy``), ``device_sorted_rows`` the rows a device
sort ordered (ops/sort.py).

Work that would need another rank's rows and is not ported yet
(ROADMAP A14.6b: the sample sort, merge, group-by, window, filters,
``take_rows``, CV folds, DeepLearning, XGBoost, the isolation forests
and the other builders, Rapids reductions, AutoML) calls `refuse`,
which raises an error naming that item instead of gathering rows.
"""

from __future__ import annotations

import pickle
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

ROW_AXIS = "rows"

# -- per-process data-plane counters ----------------------------------------

_LOCK = threading.Lock()
_PACKED = 0
_GATHERED = 0
_SORTED = 0


def note_packed(n: int) -> None:
    """Record `n` rows whose task input was built from this rank's own
    rows in place."""
    global _PACKED
    with _LOCK:
        _PACKED += int(n)


def note_gathered(n: int) -> None:
    """Record `n` rows of sharded columns fetched to this process."""
    global _GATHERED
    with _LOCK:
        _GATHERED += int(n)


def note_sorted(n: int) -> None:
    """Record `n` rows ordered by a device sort whose permutation never
    crossed to the host."""
    global _SORTED
    with _LOCK:
        _SORTED += int(n)


def counters() -> dict:
    with _LOCK:
        return {"packed_rows": _PACKED, "gathered_rows": _GATHERED,
                "device_sorted_rows": _SORTED}


def reset_counters() -> None:
    global _PACKED, _GATHERED, _SORTED
    with _LOCK:
        _PACKED = _GATHERED = _SORTED = 0


# -- geometry -----------------------------------------------------------------

def shard_geometry(n: int, mesh=None):
    """(shard_rows, {this rank's shard index}) for n rows, the reference's
    `shard_geometry` without its padding: shard i holds rows
    [i*shard_rows, min((i+1)*shard_rows, n)). One shard of n rows
    without a mesh."""
    from h2o3_tpu_torch.parallel import mesh as M

    m = mesh if mesh is not None else M.current()
    if m is None:
        return int(n), {0}
    return (-(-int(n) // m.size) if n else 0), {m.rank}


def mesh_of(frame_or_col):
    """The row mesh a frame's (or column's) rows are sharded over, else
    None (a one-process frame, or one replicated on every rank)."""
    from h2o3_tpu_torch.parallel import mesh as M

    sh = frame_or_col.shard
    return M.current() if sh is not None else None


def refuse(frame, what: str, item: str = "A14.6b") -> None:
    """Raise when `frame` is row-sharded: `what` needs other ranks' rows
    and is not ported to the row mesh yet (ROADMAP `item`)."""
    m = (mesh_of(frame) if getattr(frame, "shard", None) is not None
         else None)
    if m is not None and m.size > 1:
        raise NotImplementedError(
            f"{what} on a row-sharded frame is ROADMAP {item}: it needs "
            "other ranks' rows, and the port does not gather them")


def global_row_slice(frame_or_col):
    """(lo, hi, n): this process's rows of the frame and its row count."""
    sh = frame_or_col.shard
    n = int(frame_or_col.nrows)
    return (0, n, n) if sh is None else (sh[0], sh[1], n)


# -- gathers --------------------------------------------------------------------

def gather_column(col) -> np.ndarray:
    """Every rank's rows of a sharded column, in row order, on the host
    (``Column.to_numpy``); counts them in ``gathered_rows``. A collective:
    every rank calls it for the same column."""
    from h2o3_tpu_torch.core.frame import widen

    m = mesh_of(col)
    if m is None:
        raise RuntimeError(f"column holds rows {col.shard} of {col.nrows} "
                           "but no row mesh is current to gather them")
    if col.data is None:
        parts = all_gather_object(m, list(col.host_data[: col.local_rows]))
        out = np.empty(col.nrows, dtype=object)
        out[:] = [v for p in parts for v in p]
        note_gathered(col.nrows)
        return out
    got = m.all_gather(widen(col.data))
    note_gathered(col.nrows)
    return got.cpu().numpy()


def all_gather_object(m, obj) -> List:
    """Every rank's picklable `obj`, in rank order (small host objects:
    domains, string blocks)."""
    raw = np.frombuffer(pickle.dumps(obj, protocol=4), dtype=np.uint8)
    lens = m.all_gather(torch.tensor([len(raw)], dtype=torch.int64))
    blob = m.all_gather(torch.from_numpy(raw.copy())).numpy()
    out, at = [], 0
    from h2o3_tpu_torch.utils.unpickle import restricted_loads

    for n in lens.tolist():
        out.append(restricted_loads(blob[at:at + n].tobytes(),
                                    what="mesh object"))
        at += n
    return out


# -- the view ------------------------------------------------------------------

class ShardedFrame:
    """A frame's device columns as one rank's block of rows. Build with
    :meth:`of` (None when a named column is host-only)."""

    __slots__ = ("frame", "names", "_datas", "mesh")

    def __init__(self, frame, names: List[str], datas: list, mesh):
        self.frame = frame
        self.names = names
        self._datas = datas
        self.mesh = mesh

    @classmethod
    def of(cls, frame, names: Optional[Sequence[str]] = None
           ) -> Optional["ShardedFrame"]:
        use = list(names) if names is not None else list(frame.names)
        datas = []
        for nm in use:
            c = frame.col(nm)
            if c.ctype not in ("real", "int", "enum", "time"):
                return None
            d = c.data
            if d is None:
                return None
            datas.append(d)
        return cls(frame, use, datas, mesh_of(frame))

    @property
    def row_axis(self) -> str:
        return ROW_AXIS

    @property
    def local_rows(self) -> int:
        return int(self._datas[0].shape[0]) if self._datas else 0

    def pack_features(self, pos: int, n: int, bucket: int) -> torch.Tensor:
        """(bucket, F) float32 matrix of this rank's rows [pos, min(pos +
        bucket, n)) (numerics as they are, codes as floats), zero
        elsewhere, built on the rank's device."""
        dev = self._datas[0].device
        out = torch.zeros(bucket, len(self._datas), dtype=torch.float32,
                          device=dev)
        m = max(min(pos + bucket, n, self.local_rows) - pos, 0)
        for j, d in enumerate(self._datas):
            out[:m, j] = d[pos:pos + m].float()
        note_packed(m)
        return out

    def pack_binned(self, spec) -> torch.Tensor:
        """(local rows, F) integer bin matrix of this rank's rows for tree
        training (the training BinSpec's edges, the same on every rank),
        in the narrowest dtype that holds every bin."""
        from h2o3_tpu_torch.core.frame import widen

        max_bins = int(spec.nbins.max()) if len(spec.nbins) else 1
        dtype = (torch.uint8 if max_bins <= 256
                 else torch.int16 if max_bins <= 32767 else torch.int32)
        parts = []
        for i, d in enumerate(self._datas):
            na_bin = int(spec.nbins[i]) - 1
            if spec.is_cat[i]:
                codes = d.int()
                b = torch.where((codes < 0) | (codes >= na_bin), na_bin,
                                codes)
            else:
                x = widen(d)    # float32 edges: bf16 widens exactly
                e = torch.as_tensor(spec.edges[i], device=x.device)
                b = torch.searchsorted(e, x, side="left")
                b = torch.where(torch.isnan(x), na_bin, b)
            parts.append(b.to(dtype))
        note_packed(self.local_rows)
        if not parts:
            return torch.zeros(self.local_rows, 0, dtype=dtype)
        return torch.stack(parts, dim=-1).contiguous()

    def __repr__(self) -> str:
        return (f"<ShardedFrame {getattr(self.frame, 'key', '?')} "
                f"{self.local_rows}x{len(self.names)} axis={ROW_AXIS}>")
