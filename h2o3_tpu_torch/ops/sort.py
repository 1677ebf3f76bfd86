"""Frame sort (counterpart of h2o3_tpu/ops/sort.py `sort_frame` :199).

The permutation is built on the frame's device by stable argsorts
composed last key first (the lexicographic order), then applied to every
column without a host round trip. Keys follow the reference: an enum key
sorts by code with NA as NaN; a descending key is negated; NaN becomes
+inf, so NA rows and real +inf rows keep their row order among
themselves and come last. -0 is read as +0 so that every device's sort
sees one zero. On one device the reference takes this global argsort
too.

On a row-sharded cloud the frame is sorted by the reference's sample
sort (h2o3_tpu/ops/sort.py:50-196, `sample_sort_order`): every rank
sorts its rows by (keys, global row id), a total order that is the
stable sort's; all-gathers a stride sample of them; takes N-1 splitters
from the sorted sample (`splitters`, which the sort-merge join shares);
sends each row's keys and id to the rank of its bucket (`bucket_of`,
one ``all_to_all``); sorts its bucket; checks that the buckets
follow one another (the reference repairs a broken bucket on the host;
here it raises); and the sorted ids, rebalanced to `mesh.row_block`
(`place_rows`), take the frame's rows (`take_global_rows`). All of it
runs on the frame's device; only the sample and the buckets' ends go
through the host. The sorted frame is one process's bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.ops.filters import take_order_rows


def sort_key(key: torch.Tensor) -> torch.Tensor:
    """NaN -> +inf and -0 -> +0 (adding +0 does that and nothing else)."""
    return torch.where(torch.isnan(key), torch.inf, key) + 0.0


def stable_argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.argsort(key, stable=True)


def sort_keys(frame: Frame, names: Sequence[str],
              ascending: Sequence[bool]) -> List[torch.Tensor]:
    """The float32 sort key of each key column (of this rank's rows)."""
    keys = []
    for name, asc in zip(names, ascending):
        c = frame.col(name)
        if c.is_categorical:
            key = torch.where(c.data < 0, torch.nan, c.data.float())
        else:
            key = c.data.float()
        if not asc:
            key = -key
        keys.append(sort_key(key))
    return keys


def lex_order(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The stable permutation sorting rows by `keys` lexicographically
    (stable argsorts composed last key first)."""
    order = None
    for key in reversed(list(keys)):
        if order is None:
            order = stable_argsort(key)
        else:
            order = order[stable_argsort(key[order])]
    return order


def sort_order(frame: Frame, names: Sequence[str],
               ascending: Sequence[bool]) -> torch.Tensor:
    """The device permutation sorting `frame` by `names` (one process's
    frame: a row-sharded one is sorted by `sort_frame`)."""
    from h2o3_tpu_torch.core.sharded_frame import refuse

    refuse(frame, "a global sort permutation")
    return lex_order(sort_keys(frame, names, ascending))


def _lex_less(cols: Sequence[torch.Tensor], split: Sequence[float]
              ) -> torch.Tensor:
    """Rows (one tensor per key, the row id last) < the tuple `split`."""
    lt = torch.zeros(len(cols[0]), dtype=torch.bool, device=cols[0].device)
    eq = torch.ones_like(lt)
    for c, v in zip(cols, split):
        lt |= eq & (c < v)
        eq &= c == v
    return lt


SAMPLES_PER_RANK = 64


def splitters(mesh, cols: Sequence[torch.Tensor]) -> list:
    """The N-1 splitter tuples of the sample sort, the same on every
    rank: from a stride sample of this rank's rows (`cols`, one float64
    tensor a field, sorted lexicographically), all-gathered and sorted."""
    n_loc, size = len(cols[0]), mesh.size
    m = min(n_loc, SAMPLES_PER_RANK * size)
    pick = (torch.arange(m, device=cols[0].device) * n_loc) // max(m, 1)
    every = mesh.all_gather(torch.stack([c[pick] for c in cols], 1)
                            ).cpu().numpy()
    if not len(every):
        return []
    every = every[np.lexsort(every.T[::-1])]
    return [every[(j + 1) * len(every) // size] for j in range(size - 1)]


def bucket_of(cols: Sequence[torch.Tensor], splits) -> torch.Tensor:
    """The bucket (destination rank) of each row: how many splitters it
    does not precede."""
    b = torch.zeros(len(cols[0]), dtype=torch.long, device=cols[0].device)
    for sp in splits:
        b += (~_lex_less(cols, sp)).long()
    return b


def sample_sort_rows(mesh, cols: Sequence[torch.Tensor]) -> tuple:
    """The sample sort over the row mesh of this rank's rows `cols` (one
    float64 tensor a field, on one device; the last field the global row
    id, ascending here, so that ties keep their row order): -> (this
    rank's bucket of the rows sorted lexicographically, a (k, fields)
    float64 tensor; the bucket's offset in the sorted order)."""
    from h2o3_tpu_torch.core.sharded_frame import Route, all_gather_counts

    dev = cols[0].device
    order = lex_order(cols[:-1])
    cols = [c[order] for c in cols]
    route = Route(mesh, bucket_of(cols, splitters(mesh, cols)))
    got = route.send(torch.stack(cols, 1))
    if len(got):
        got = got[lex_order([got[:, j] for j in range(got.shape[1])])]
    # the bucket invariant: rank r's last tuple precedes rank r+1's first
    width = got.shape[1]
    ends = torch.zeros(1, 1 + 2 * width, dtype=torch.float64, device=dev)
    if len(got):
        ends[0, 0] = len(got)
        ends[0, 1:] = torch.cat([got[0], got[-1]])
    prev = None
    for r, row in enumerate(mesh.all_gather(ends).tolist()):
        if row[0] == 0:
            continue
        first, last = row[1:1 + width], row[1 + width:]
        if prev is not None and not tuple(prev) < tuple(first):
            raise RuntimeError(
                f"sample sort: bucket {r} starts at {first}, before the "
                f"end {prev} of the bucket before it")
        prev = last
    sizes = all_gather_counts(mesh, len(got))
    return got, sum(sizes[: mesh.rank])


def sample_sort_ids(frame: Frame, names: Sequence[str],
                    ascending: Sequence[bool], mesh) -> tuple:
    """The sample sort of `frame` by `names`, on the frame's device: ->
    (this rank's bucket of the sorted global row ids, the bucket's
    offset in the sorted order)."""
    lo, _hi = frame.shard
    keys = sort_keys(frame, names, ascending)
    gid = torch.arange(lo, lo + frame.local_rows, device=keys[0].device)
    got, off = sample_sort_rows(mesh, [k.double() for k in keys]
                                + [gid.double()])
    return got[:, -1].long(), off


def sort_frame(frame: Frame, by: Union[str, int, Sequence], ascending=True,
               rows: Optional[tuple] = None) -> Frame:
    """`frame` sorted by the key columns `by`; `rows=(lo, hi)` gathers
    only that window of the sorted rows."""
    if isinstance(by, (str, int)):
        by = [by]
    names = [frame.names[b] if isinstance(b, int) else b for b in by]
    asc = (list(ascending) if isinstance(ascending, (list, tuple))
           else [ascending] * len(names))
    n = frame.nrows
    lo, hi = (0, n) if rows is None else (max(0, min(int(rows[0]), n)),
                                          max(0, min(int(rows[1]), n)))
    hi = max(lo, hi)
    from h2o3_tpu_torch.core import sharded_frame as SF

    if SF._is_sharded(frame):
        mesh = SF.mesh_of(frame)
        ids, off = sample_sort_ids(frame, names, asc, mesh)
        pos = off + torch.arange(len(ids), device=ids.device)
        keep = (pos >= lo) & (pos < hi)
        (src,), _ = SF.place_rows(mesh, pos[keep] - lo, hi - lo,
                                  [ids[keep]])
        SF.note_sorted(len(ids))
        return SF.take_global_rows(frame, src, hi - lo)
    order = lex_order(sort_keys(frame, names, asc))
    SF.note_sorted(n)          # the permutation stays on the device
    return take_order_rows(frame, order, hi - lo, offset=lo)
