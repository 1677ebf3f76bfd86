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

Rows move between ranks only through the row exchange: a `Route` is
one plan (each row's destination rank, one ``all_to_all`` a column,
`mesh.all_to_all`); `take_global_rows` fetches the rows of an output
block from the ranks that hold them (an exchange of the ids, then one
of each column's values), and `place_rows`/`place_frame` send rows to
the rank whose block holds their output positions. The munging ops
(ops/filters, sort, merge), the CV folds and the holdout predictions
(models/model_builder.py) build on them, so every output lands in
`mesh.row_block`s and no rank gathers a column.

Per-process counters make the no-gather property observable
(``GET /3/ScoringMetrics`` -> ``data_plane``, ``/3/Metrics``):
``packed_rows`` counts rows packed shard-locally, ``gathered_rows`` the
rows of sharded columns fetched to this process (`gather_column`, the
path of ``Column.to_numpy``), ``device_sorted_rows`` the rows a sort
ordered (ops/sort.py), ``exchanged_rows`` and ``exchanged_bytes`` what
this process sent to other ranks through the row exchange, and
``dl_batch_rows`` the DeepLearning batch rows it fetched from them.

Every Rapids prim and frame operation runs on a row-sharded frame
(reshapes, user lambdas and string keys since ROADMAP A14.6c part 1b:
rapids/prims_sharded.py, ops/sort.keyed_sort). Work not ported to the
row mesh yet (A14.6c part 4: the isolation forests, KMeans and the
other builders without a sharded path, the DeepLearning autoencoder,
AutoML's target-encoding stage) calls `refuse`, which raises an error
naming that item instead of gathering rows.
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
_EXCHANGED_ROWS = 0
_EXCHANGED_BYTES = 0
_DL_BATCH_ROWS = 0


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


def note_exchanged(rows: int, nbytes: int) -> None:
    """Record `rows` rows (`nbytes` bytes) this process sent to other
    ranks through the row exchange (`Route`)."""
    global _EXCHANGED_ROWS, _EXCHANGED_BYTES
    with _LOCK:
        _EXCHANGED_ROWS += int(rows)
        _EXCHANGED_BYTES += int(nbytes)


def note_dl_batch_rows(n: int) -> None:
    """Record `n` DeepLearning batch rows this rank received from other
    ranks (models/deeplearning.py's synchronous path)."""
    global _DL_BATCH_ROWS
    with _LOCK:
        _DL_BATCH_ROWS += int(n)


def counters() -> dict:
    with _LOCK:
        return {"packed_rows": _PACKED, "gathered_rows": _GATHERED,
                "device_sorted_rows": _SORTED,
                "exchanged_rows": _EXCHANGED_ROWS,
                "exchanged_bytes": _EXCHANGED_BYTES,
                "dl_batch_rows": _DL_BATCH_ROWS}


def reset_counters() -> None:
    global _PACKED, _GATHERED, _SORTED, _EXCHANGED_ROWS, _EXCHANGED_BYTES
    global _DL_BATCH_ROWS
    with _LOCK:
        _PACKED = _GATHERED = _SORTED = 0
        _EXCHANGED_ROWS = _EXCHANGED_BYTES = _DL_BATCH_ROWS = 0


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


def refuse(frame, what: str, item: str = "A14.6c") -> None:
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


def agreed_int(m, value: int) -> int:
    """Rank 0's `value` on every rank of mesh `m` (a fresh seed every
    rank must draw with)."""
    t = torch.tensor([int(value) if m.rank == 0 else 0], dtype=torch.int64)
    return int(m.all_reduce(t, "sum")[0])


def all_gather_counts(m, k: int) -> List[int]:
    """Every rank's count `k`, in rank order."""
    return [int(x) for x in m.all_gather(
        torch.tensor([int(k)], dtype=torch.int64)).tolist()]


def sharded_mesh(frame_or_col):
    """The row mesh of more than one rank that a frame's (or column's)
    rows are sharded over, else None."""
    return mesh_of(frame_or_col) if _is_sharded(frame_or_col) else None


def replicated(col):
    """`col`, which holds every row, marked as held whole on every rank:
    a small result (a histogram table, a correlation matrix) that no
    rank's block test (`core/frame._shard_of`) may read as a block."""
    col._shard = None
    return col


def block_column(arr, nrows: int, ctype=None, domain=None, device=None):
    """`Column.from_numpy` of this process's rows `arr` of an `nrows`-row
    column: on a row-sharded cloud they are this rank's block (a
    row-local result: a prediction, a leaf, a contribution), stored as
    one process stores the whole array."""
    from h2o3_tpu_torch.core.frame import Column
    from h2o3_tpu_torch.parallel import mesh as M

    if M.current() is None:
        return Column.from_numpy(arr, ctype=ctype, domain=domain,
                                 device=device)
    with M.alone():
        c = Column.from_numpy(arr, ctype=ctype, domain=domain, device=device)
    return Column(c.data, c.ctype, nrows, domain=c.domain,
                  host_data=c.host_data)


def carry(m, local: Sequence[float]) -> np.ndarray:
    """Every rank's few float64 values `local`, (ranks, k) in rank order
    on the host: what a scan across the ranks carries into each of them
    (a running total, a last valid row, a boundary key)."""
    return m.all_gather(torch.tensor([list(local)], dtype=torch.float64)
                        ).numpy()


# -- the row exchange -----------------------------------------------------------

def owner_of(ids: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """The rank whose `mesh.row_block` of n rows holds each global row
    id."""
    block = max(-(-int(n) // size), 1)
    return torch.clamp(ids // block, max=size - 1)


class Route:
    """One plan of the row exchange: this rank's rows, each bound for
    the rank `dest` names, moved by `send` (any number of columns, one
    ``all_to_all`` each) and answered by `back`, which returns rows sent
    to this rank's senders in the order of their requests. The rows a
    rank receives come in source-rank order, each source's in its own
    order. A collective: every rank of the mesh builds its plan and
    calls `send`/`back` the same number of times."""

    def __init__(self, m, dest: torch.Tensor):
        self.mesh = m
        dest = dest.long()
        self.order = torch.argsort(dest, stable=True)
        self.send_counts = torch.bincount(
            dest, minlength=m.size).tolist() if len(dest) else [0] * m.size
        self.recv_counts: Optional[List[int]] = None

    def _count(self, counts: List[int], nbytes_row: int) -> None:
        off = sum(c for i, c in enumerate(counts) if i != self.mesh.rank)
        note_exchanged(off, off * nbytes_row)

    def send(self, x: torch.Tensor) -> torch.Tensor:
        """Rows of `x` (this rank's, in its order) to their ranks; the
        rows this rank receives."""
        xs = x.index_select(0, self.order.to(x.device))
        got, rc = self.mesh.all_to_all(xs, self.send_counts,
                                       self.recv_counts)
        self.recv_counts = rc
        self._count(self.send_counts, _row_bytes(x))
        return got

    def back(self, y: torch.Tensor) -> torch.Tensor:
        """Rows answering what this rank received (in that order) to the
        ranks that sent it; the answers to this rank's own rows, in its
        order."""
        got, _ = self.mesh.all_to_all(y, self.recv_counts, self.send_counts)
        self._count(self.recv_counts, _row_bytes(y))
        out = torch.empty_like(got)
        out[self.order.to(got.device)] = got
        return out

    def _objects(self, arr: np.ndarray, counts: List[int],
                 recv: List[int]) -> np.ndarray:
        parts, at = [], 0
        for c in counts:
            parts.append(np.frombuffer(pickle.dumps(arr[at:at + c],
                                                    protocol=4), np.uint8))
            at += c
        sizes = [len(p) for p in parts]
        raw = torch.from_numpy(np.concatenate(parts) if parts else
                               np.zeros(0, np.uint8))
        blob, got = self.mesh.all_to_all(raw, sizes)
        from h2o3_tpu_torch.utils.unpickle import restricted_loads

        blob, out, at = blob.numpy(), [], 0
        for k in got:
            out.append(restricted_loads(blob[at:at + k].tobytes(),
                                        what="exchanged rows"))
            at += k
        off = sum(s for i, s in enumerate(sizes) if i != self.mesh.rank)
        note_exchanged(sum(c for i, c in enumerate(counts)
                           if i != self.mesh.rank), off)
        res = np.concatenate(out) if out else arr[:0]
        if len(res) != sum(recv):
            raise RuntimeError("the row exchange lost host rows")
        return res

    def send_host(self, arr: np.ndarray) -> np.ndarray:
        """`send` for a host array (strings, exact times)."""
        if self.recv_counts is None:
            raise RuntimeError("send a tensor through the route first")
        return self._objects(np.asarray(arr)[self.order.cpu().numpy()],
                             self.send_counts, self.recv_counts)

    def back_host(self, arr: np.ndarray) -> np.ndarray:
        """`back` for a host array."""
        got = self._objects(np.asarray(arr), self.recv_counts,
                            self.send_counts)
        out = np.empty_like(got)
        out[self.order.cpu().numpy()] = got
        return out


def _row_bytes(x: torch.Tensor) -> int:
    return int(x[0].numel() * x.element_size()) if len(x) else 0


def _is_sharded(frame) -> bool:
    m = mesh_of(frame) if getattr(frame, "shard", None) is not None else None
    return m is not None and m.size > 1


def take_global_rows(frame, src: torch.Tensor, total: int,
                     key: Optional[str] = None):
    """The rows of `frame` at the global row ids `src`, as this rank's
    block of a `total`-row frame: each rank passes the ids of its own
    output block (`mesh.row_block(total, r, N)`), in order. One
    exchange sends the ids to the ranks that hold those rows and one a
    column returns the values; enum columns keep their codes and
    domains, host-only columns move as host arrays. A frame replicated
    on every rank is indexed in place. A collective."""
    from h2o3_tpu_torch.core.frame import Column, Frame
    from h2o3_tpu_torch.parallel import mesh as M

    m = M.current()
    src = src.long()
    out = Frame(key=key)
    if frame.shard is None:
        for name in frame.names:
            c = frame.col(name)
            host = (c.host_data[src.cpu().numpy()]
                    if c.host_data is not None else None)
            data = (c.data.index_select(0, src.to(c.data.device))
                    if c.data is not None else None)
            out.add(name, Column(data, c.ctype, total, domain=c.domain,
                                 host_data=host))
        return out
    lo, hi = frame.shard
    route = Route(m, owner_of(src, frame.nrows, m.size))
    local = route.send(src) - lo
    for name in frame.names:
        c = frame.col(name)
        data = host = None
        if c.data is not None:
            data = route.back(c.data.index_select(0, local.to(c.data.device)))
        if c.host_data is not None:
            host = route.back_host(c.host_data[local.cpu().numpy()])
        out.add(name, Column(data, c.ctype, total, domain=c.domain,
                             host_data=host))
    return out


def place_rows(m, positions: torch.Tensor, total: int, tensors=(),
               hosts=()):
    """This rank's rows, each bound for the global position
    `positions[i]` of a `total`-row output, moved so that every rank ends
    up with its block (`mesh.row_block(total, r, N)`) in position order:
    -> (the block's tensors, its host arrays). The positions of all
    ranks together must be each of 0..total-1 once. A collective."""
    positions = positions.long()
    lo, hi = m.rows(total)
    route = Route(m, owner_of(positions, total, m.size))
    slot = route.send(positions) - lo
    if len(slot) != hi - lo or (len(slot) and (
            int(slot.min()) < 0 or int(slot.max()) >= hi - lo)):
        raise RuntimeError(f"place_rows: rank {m.rank} received "
                           f"{len(slot)} rows for its block [{lo}, {hi})")
    outs = []
    for t in tensors:
        got = route.send(t)
        res = torch.empty_like(got)
        res[slot.to(got.device)] = got
        outs.append(res)
    hs = []
    for a in hosts:
        got = route.send_host(a)
        res = np.empty_like(got)
        res[slot.cpu().numpy()] = got
        hs.append(res)
    return outs, hs


def place_frame(frame, idx: torch.Tensor, positions: torch.Tensor,
                total: int, key: Optional[str] = None):
    """The rows `idx` of this rank's block of `frame` (local indices),
    placed at the global `positions` of a `total`-row frame
    (`place_rows`): this rank's block of it."""
    from h2o3_tpu_torch.core.frame import Column, Frame
    from h2o3_tpu_torch.parallel import mesh as M

    m = M.current()
    cols = [(nm, frame.col(nm)) for nm in frame.names]
    tens = [c.data.index_select(0, idx.to(c.data.device))
            for _nm, c in cols if c.data is not None]
    hosts = [c.host_data[idx.cpu().numpy()] for _nm, c in cols
             if c.host_data is not None]
    got_t, got_h = place_rows(m, positions, total, tens, hosts)
    out = Frame(key=key)
    it, ih = iter(got_t), iter(got_h)
    for nm, c in cols:
        data = next(it) if c.data is not None else None
        host = next(ih) if c.host_data is not None else None
        out.add(nm, Column(data, c.ctype, total, domain=c.domain,
                           host_data=host))
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
