"""The row mesh: ranks, their row blocks and the collectives between
them (counterpart of h2o3_tpu/parallel/mesh.py: `make_mesh` is
`RowMesh`, `row_spec` is `row_block`, and `shard_rows` is
``Column.from_numpy`` keeping a rank's block, core/frame.py).

The reference lays every column out as a ``NamedSharding(mesh,
P("rows"))`` array over its processes' devices and reduces across them
with ``psum``. Here a cloud of N processes is N ranks of a
``torch.distributed`` process group: rank r keeps the contiguous block
of rows `row_block(n, r, N)` on its own device, and reductions cross
ranks through the group's all-reduce and all-gather; rows move between
ranks through `all_to_all` with split sizes (the counterpart of
``jax.lax.all_to_all``; core/sharded_frame.py's row exchange), its bytes
and seconds counted in `stats()`.

- **Backend.** NCCL when every rank has a card of its own (rank r on
  ``cuda:r``, as many cards as ranks, or one rank on a card); gloo
  otherwise, which covers ranks sharing one card and the CPU. It is
  chosen once, when the mesh is built, printed and reported by
  ``/3/Cloud``; it never changes silently. gloo reduces host tensors:
  a CUDA buffer is copied to the host, reduced there and copied back,
  and those copies are counted (`stats()["staged_bytes"]`). Only the
  reduction buffers move; the rows stay on their card.
- **Generations.** The group is built at the first collective, over a
  ``PrefixStore`` of the cloud's store keyed by the mesh generation
  recorded in that store (``h2o3/mesh/generation``). A collective that
  fails (a peer died: gloo ends it when the peer's sockets close, or at
  the mesh's timeout, ``H2O_TPU_MESH_TIMEOUT_S``) raises
  :class:`~h2o3_tpu_torch.core.failure.CloudUnhealthyError`, never
  hangs, and moves the recorded generation on: a group with a dead peer
  cannot be reused, so every live rank (and a rejoined one) builds
  generation g+1 at its next collective.
- **Current mesh.** `current()` is this thread's mesh (`use`, for
  ranks run as threads in tests), else the process's (`install`, which
  ``distributed.initialize`` calls for a multi-process cloud). Columns
  built while a mesh is current hold their rank's rows
  (core/frame.py).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
import time
from typing import List, Optional, Tuple

import torch

_GEN_KEY = "h2o3/mesh/generation"
_ABSENT = b"\x00h2o3-absent\x00"

_PROCESS_MESH: Optional["RowMesh"] = None
# seconds a rank trusts its group's generation before it reads the
# recorded one again
_GEN_CHECK_S = 2.0
_TLS = threading.local()


def row_block(n: int, rank: int, size: int) -> Tuple[int, int]:
    """Rows [lo, hi) of rank `rank` of `size` over n rows: contiguous
    blocks of ceil(n/size) rows, the last one shorter (possibly empty).
    No padding: the kernel masks its own ragged block."""
    n, size = int(n), max(int(size), 1)
    block = -(-n // size) if n else 0
    lo = min(rank * block, n)
    return lo, min(lo + block, n)


def mesh_timeout_s() -> float:
    """Seconds a collective may wait for its peers before it fails
    (``H2O_TPU_MESH_TIMEOUT_S``, default 300)."""
    return float(os.environ.get("H2O_TPU_MESH_TIMEOUT_S", "300"))


def choose_backend(device: torch.device, rank: int, size: int
                   ) -> Tuple[str, str]:
    """(backend, reason): NCCL when every rank has a card of its own,
    gloo otherwise."""
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    if size == 1:
        return "nccl", "one rank on its own card"
    if torch.cuda.device_count() >= size and (device.index or 0) == rank:
        return "nccl", f"rank r on cuda:r, {size} cards"
    return "gloo", (f"{size} ranks share {torch.cuda.device_count()} "
                    "card(s): NCCL refuses two ranks on one device")


class RowMesh:
    """One rank's view of the row mesh: `rank`, `size`, `device`,
    `backend`, `generation`, `timeout_s` and the process group (built at
    the first collective). `store` is the cloud's store (a TCPStore, or
    a HashStore when ranks run as threads)."""

    def __init__(self, rank: int, size: int, device, store,
                 timeout_s: Optional[float] = None):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a mesh of {size}")
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.store = store
        self.backend, self.backend_reason = choose_backend(self.device, rank,
                                                           size)
        self.timeout_s = float(timeout_s if timeout_s is not None
                               else mesh_timeout_s())
        self.generation = -1
        self._group = None
        self._gen_checked = 0.0
        self._lock = threading.RLock()
        self._stats = {"collectives": 0, "bytes": 0, "staged_bytes": 0,
                       "seconds": 0.0, "failures": 0, "groups_built": 0,
                       "exchanges": 0, "exchange_bytes": 0,
                       "exchange_seconds": 0.0}

    # -- geometry -----------------------------------------------------------
    def rows(self, n: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of an n-row frame."""
        return row_block(n, self.rank, self.size)

    def describe(self) -> dict:
        return {"rank": self.rank, "size": self.size,
                "device": str(self.device), "backend": self.backend,
                "backend_reason": self.backend_reason,
                "generation": self.generation, "timeout_s": self.timeout_s}

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    # -- the group ----------------------------------------------------------
    def _recorded_generation(self) -> int:
        got = self.store.compare_set(_GEN_KEY, _ABSENT, _ABSENT)
        return 0 if got == _ABSENT else int(got.decode())

    def _group_now(self):
        # the recorded generation is one store round trip: read it when
        # this rank has no group, and at most every `_GEN_CHECK_S` while
        # it has one (a rank whose peer died finds out at its next
        # collective, which fails and drops the group)
        now = time.monotonic()
        if self._group is not None and now - self._gen_checked < _GEN_CHECK_S:
            return self._group
        gen = self._recorded_generation()
        self._gen_checked = now
        if self._group is not None and gen == self.generation:
            return self._group
        import torch.distributed as dist

        prefix = dist.PrefixStore(f"h2o3/mesh/{gen}/", self.store)
        timeout = datetime.timedelta(seconds=self.timeout_s)
        try:
            if self.backend == "nccl":
                opts = dist.ProcessGroupNCCL.Options()
                opts._timeout = timeout
                torch.cuda.set_device(self.device)
                grp = dist.ProcessGroupNCCL(prefix, self.rank, self.size,
                                            opts)
            else:
                grp = dist.ProcessGroupGloo(prefix, self.rank, self.size,
                                            timeout)
        except Exception as e:   # noqa: BLE001 — a peer never came
            self._fail(e, f"building generation {gen}")
        self._group, self.generation = grp, gen
        self._stats["groups_built"] += 1
        from h2o3_tpu_torch.utils import timeline

        timeline.record("mesh", "group", rank=self.rank, size=self.size,
                        generation=gen, backend=self.backend)
        return grp

    def advance_generation(self, seen: Optional[int] = None) -> None:
        """Move the recorded generation from `seen` (default: this rank's
        group's, else the record's) to the next, first writer wins, and
        drop this rank's group."""
        gen = seen if seen is not None else (
            self.generation if self.generation >= 0
            else self._recorded_generation())
        try:
            cur = self.store.compare_set(_GEN_KEY, _ABSENT, _ABSENT)
            if (0 if cur == _ABSENT else int(cur.decode())) == gen:
                self.store.compare_set(_GEN_KEY,
                                       b"" if cur == _ABSENT else cur,
                                       str(gen + 1).encode())
        except Exception:   # noqa: BLE001 — the store itself may be gone
            pass
        with self._lock:
            self._group = None

    def _fail(self, e: BaseException, what: str):
        """A collective (or a group build) failed: move the recorded
        generation past this one, drop the group, raise."""
        gen = self.generation if self.generation >= 0 else \
            self._recorded_generation()
        self.advance_generation(gen)
        self._group = None
        self._stats["failures"] += 1
        from h2o3_tpu_torch.core.failure import CloudUnhealthyError
        from h2o3_tpu_torch.parallel import oplog

        msg = (f"row mesh rank {self.rank}/{self.size} (generation {gen}, "
               f"{self.backend}): {what} failed ({type(e).__name__}: "
               f"{str(e).splitlines()[0] if str(e) else ''}); a peer was "
               f"lost or did not answer within {self.timeout_s:.0f} s")
        oplog.note_collective_failure(msg)
        err = CloudUnhealthyError(msg)
        err.collective = True
        raise err from e

    def shutdown(self) -> None:
        with self._lock:
            self._group = None

    # -- collectives --------------------------------------------------------
    def _run(self, what: str, tensors: List[torch.Tensor], call):
        """Run one collective on `tensors` (reduced in place); gloo gets
        host copies of CUDA tensors and the results are copied back."""
        from h2o3_tpu_torch.parallel import oplog

        if oplog.unmirrored_collective_risk():
            raise RuntimeError(
                f"a {what} across the row mesh from a REST handler outside "
                "an oplog op: the followers replay ops only, so they would "
                "never join it")
        if oplog.solo_replay():
            from h2o3_tpu_torch.core.failure import CloudUnhealthyError

            err = CloudUnhealthyError(
                f"a {what} across the row mesh while this rank replays a "
                "rejoin's suffix alone: its peers already ran that op, so "
                "they will not join it")
            err.solo = True      # the rejoin replays such an op jointly
            raise err
        with self._lock:
            t0 = time.perf_counter()
            # gloo reduces host tensors, NCCL device ones
            stage = self.backend == "gloo" and any(
                t.device.type == "cuda" for t in tensors)
            lift = self.backend == "nccl" and any(
                t.device.type == "cpu" for t in tensors)
            work = [t.cpu() if stage else t.to(self.device) if lift else t
                    for t in tensors]
            try:
                grp = self._group_now()
                call(grp, work).wait()
            except Exception as e:   # noqa: BLE001 — typed below
                from h2o3_tpu_torch.core.failure import CloudUnhealthyError

                if isinstance(e, CloudUnhealthyError):
                    raise
                self._fail(e, what)
            if stage or lift:
                for t, h in zip(tensors, work):
                    t.copy_(h)
            if stage:
                self._stats["staged_bytes"] += 2 * sum(
                    t.numel() * t.element_size() for t in tensors)
            self._stats["collectives"] += 1
            self._stats["bytes"] += sum(t.numel() * t.element_size()
                                        for t in tensors)
            self._stats["seconds"] += time.perf_counter() - t0
        return tensors

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce `t` in place across the ranks (op: sum, max, min) and
        return it. `t` must be contiguous."""
        import torch.distributed as dist

        if not t.is_contiguous():
            raise ValueError("all_reduce needs a contiguous tensor")
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]

        def call(grp, work):
            opts = dist.AllreduceOptions()
            opts.reduceOp = red
            return grp.allreduce(work, opts)

        self._run(f"all_reduce({op})", [t], call)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` concatenated along dim 0 in rank order; the
        ranks' lengths may differ."""
        import torch.distributed as dist

        t = t.contiguous()
        ldev = torch.device("cpu") if self.backend == "gloo" else self.device
        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=ldev)
        lens = [torch.zeros(1, dtype=torch.int64, device=ldev)
                for _ in range(self.size)]

        def call_n(grp, work):
            return grp.allgather([lens], work)

        self._run("all_gather(lengths)", [n], call_n)
        sizes = [int(x) for x in lens]
        m = max(sizes) if sizes else 0
        pad = torch.zeros((m,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        pad[: t.shape[0]] = t
        stage = self.backend == "gloo" and t.device.type == "cuda"
        dev = (torch.device("cpu") if self.backend == "gloo"
               else self.device)
        outs = [torch.empty_like(pad, device=dev) for _ in range(self.size)]

        def call(grp, work):
            return grp.allgather([outs], work)

        self._run("all_gather", [pad], call)
        if stage:
            with self._lock:
                self._stats["staged_bytes"] += sum(
                    o.numel() * o.element_size() for o in outs)
        return torch.cat([o[:s] for o, s in zip(outs, sizes)]).to(t.device)

    def all_to_all(self, t: torch.Tensor, send_counts: List[int],
                   recv_counts: Optional[List[int]] = None
                   ) -> Tuple[torch.Tensor, List[int]]:
        """The rows of `t` (dim 0) in rank order of destination, the first
        ``send_counts[0]`` to rank 0 and so on, exchanged with every rank:
        -> (the rows this rank received, in source rank order, on `t`'s
        device; how many came from each rank). The counterpart of
        ``jax.lax.all_to_all`` with split sizes: one exchange of the
        counts (skipped when the caller knows `recv_counts`, as a plan
        moving several columns the same way does), then one of the rows
        as bytes (any dtype; gloo gets host buffers, NCCL device ones)."""
        import torch.distributed as dist

        if len(send_counts) != self.size or sum(send_counts) != t.shape[0]:
            raise ValueError(f"all_to_all: {len(send_counts)} counts "
                             f"summing to {sum(send_counts)} for "
                             f"{t.shape[0]} rows on {self.size} ranks")
        t0 = time.perf_counter()
        if recv_counts is None:
            ldev = (torch.device("cpu") if self.backend == "gloo"
                    else self.device)
            ones = [1] * self.size
            sent = torch.tensor(list(send_counts), dtype=torch.int64,
                                device=ldev)
            got = torch.empty(self.size, dtype=torch.int64, device=ldev)

            def call_n(grp, work):
                return grp.alltoall_base(work[1], work[0], ones, ones,
                                         dist.AllToAllOptions())

            self._run("all_to_all(counts)", [sent, got], call_n)
            recv_counts = [int(x) for x in got.tolist()]
        row_shape = tuple(t.shape[1:])
        width = 1
        for d in row_shape:
            width *= int(d)
        src = t.contiguous().reshape(t.shape[0], width)
        row_bytes = src.shape[1] * src.element_size()
        raw = src.view(torch.uint8).reshape(-1)
        out = torch.empty(sum(recv_counts) * row_bytes, dtype=torch.uint8,
                          device=t.device)

        def call(grp, work):
            return grp.alltoall_base(
                work[1], work[0], [c * row_bytes for c in recv_counts],
                [c * row_bytes for c in send_counts],
                dist.AllToAllOptions())

        self._run("all_to_all", [raw, out], call)
        moved = sum(c for i, c in enumerate(send_counts) if i != self.rank)
        with self._lock:
            self._stats["exchanges"] += 1
            self._stats["exchange_bytes"] += moved * row_bytes
            self._stats["exchange_seconds"] += time.perf_counter() - t0
        return (out.view(src.dtype).reshape((sum(recv_counts),) + row_shape),
                recv_counts)

    def barrier(self) -> None:
        """Every rank reaches this point (a one-element all-reduce)."""
        self.all_reduce(torch.zeros(1, dtype=torch.int64))


# ---------------------------------------------------------------------------
# the current mesh
# ---------------------------------------------------------------------------

def current() -> Optional[RowMesh]:
    """This thread's mesh (`use`), else the process's (`install`); None
    inside `alone`."""
    m = getattr(_TLS, "mesh", None)
    if m is not None:
        return m
    return None if getattr(_TLS, "alone", False) else _PROCESS_MESH


@contextlib.contextmanager
def alone():
    """No mesh for this thread in the block, even where the process has
    one: one process's work on rows this rank holds whole (a group's
    rows that a user function reads, one row of a per-row lambda)."""
    prev = (getattr(_TLS, "mesh", None), getattr(_TLS, "alone", False))
    _TLS.mesh, _TLS.alone = None, True
    try:
        yield
    finally:
        _TLS.mesh, _TLS.alone = prev


@contextlib.contextmanager
def use(mesh: Optional[RowMesh]):
    """Make `mesh` this thread's current mesh for the block."""
    prev = getattr(_TLS, "mesh", None)
    _TLS.mesh = mesh
    try:
        yield mesh
    finally:
        _TLS.mesh = prev


def install(mesh: Optional[RowMesh]) -> Optional[RowMesh]:
    """Set (or with None, drop) the process's mesh; returns the old
    one."""
    global _PROCESS_MESH
    old, _PROCESS_MESH = _PROCESS_MESH, mesh
    if mesh is not None:
        from h2o3_tpu_torch.utils.log import get_logger

        get_logger().info("row mesh: rank %d of %d on %s, backend %s (%s)",
                          mesh.rank, mesh.size, mesh.device, mesh.backend,
                          mesh.backend_reason)
    if old is not None and old is not mesh:
        old.shutdown()
    return old
