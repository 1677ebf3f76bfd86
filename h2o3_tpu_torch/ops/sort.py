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

`keyed_sort` is the sample sort for work that needs every row of a key
on one rank (dropdup, ranks within string groups, segments, string-key
merges, pivot, ddply, grouped_permute, tf-idf, spearman's midranks).
Its splitters are drawn from the keys alone, so equal keys land in one
bucket and the buckets come in key order; each bucket is then sorted by
(keys, further levels, global row id). A key may be a host column of
strings (None sorting last, as `_pivot` sorts it): each rank ranks its
distinct key tuples (`host_codes`), places each among splitter tuples
drawn from an all-gathered sample by `bisect`, and moves the strings by
`Route.send_host`. A string is never routed by Python's salted
`hash()`, which two processes would not agree on.
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
    """The device permutation sorting `frame` by `names`: the row at each
    sorted position. On a row-sharded frame, the global ids of the rows
    at this rank's block of the sorted positions (the sample sort)."""
    from h2o3_tpu_torch.core import sharded_frame as SF

    mesh = SF.sharded_mesh(frame)
    if mesh is None:
        return lex_order(sort_keys(frame, names, ascending))
    ids, off = sample_sort_ids(frame, names, ascending, mesh)
    (src,), _ = SF.place_rows(mesh, off + torch.arange(len(ids),
                                                       device=ids.device),
                              frame.nrows, [ids])
    return src


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


def host_level(v) -> tuple:
    """The sort key of one host value: None last, then the value."""
    return (v is None, "" if v is None else v)


def host_codes(vals: np.ndarray):
    """-> (each host value's rank among the distinct values of `vals`,
    the distinct values in `host_level` order): an integer key that sorts
    and compares as the values do, None last."""
    none = np.asarray(vals == None, bool)          # noqa: E711
    v = vals[~none]
    if not len(v):
        u, inv = [], np.zeros(0, np.int64)
    elif set(map(type, v)) == {str} and np.array_equal(
            np.char.str_len(sv := v.astype(str)),
            np.fromiter(map(len, v), np.int64, len(v))):
        # numpy's fixed-width strings sort by code point as str does (a
        # trailing NUL, which they drop, takes the objects' path)
        u, inv = np.unique(sv, return_inverse=True)
        u = u.tolist()
    else:
        u, inv = np.unique(v, return_inverse=True)
        u = list(u)
    codes = np.full(len(vals), len(u), np.int64)
    codes[~none] = inv.reshape(-1)
    return codes, u + [None] * bool(none.any())


def run_starts(levels: Sequence[torch.Tensor], k: int, dev) -> torch.Tensor:
    """Rows (of k sorted rows) where `levels` differ from the row before."""
    start = torch.ones(k, dtype=torch.bool, device=dev)
    if k:
        start[1:] = False
        for v in levels:
            start[1:] |= v[1:] != v[:-1]
    return start


def host_splitters(mesh, rows: list) -> list:
    """The N-1 splitter tuples of the sample sort of host key tuples
    `rows` (this rank's, unsorted), the same on every rank: a stride
    sample of them, all-gathered and sorted."""
    from h2o3_tpu_torch.core.sharded_frame import all_gather_object

    n_loc, size = len(rows), mesh.size
    m = min(n_loc, SAMPLES_PER_RANK * size)
    pick = [rows[(i * n_loc) // m] for i in range(m)]
    every = sorted(t for part in all_gather_object(mesh, pick)
                   for t in part)
    if not every:
        return []
    return [every[(j + 1) * len(every) // size] for j in range(size - 1)]


def _host_dest(mesh, keys: Sequence) -> torch.Tensor:
    """Each row's bucket when a key is a host column: the rows' distinct
    key tuples (per key its distinct values, `host_codes`), each placed
    among splitters drawn from a sample of the rows' tuples by
    `bisect`."""
    import bisect

    fields = [host_codes(k) if isinstance(k, np.ndarray) else
              _float_codes(k.cpu().numpy()) for k in keys]
    # each row's rank among the distinct key tuples, one key at a time
    inv = np.zeros(len(fields[0][0]), np.int64)
    for c, u in fields:
        _r, inv = np.unique(inv * (len(u) + 1) + c, return_inverse=True)
        inv = inv.reshape(-1)
    _r, rep = np.unique(inv, return_index=True)
    tup = [tuple(host_level(u[c[i]]) if isinstance(k, np.ndarray) else u[c[i]]
                 for (c, u), k in zip(fields, keys)) for i in rep.tolist()]
    splits = host_splitters(mesh, [tup[i] for i in inv])
    at = np.asarray([bisect.bisect_right(splits, t) for t in tup] or [0],
                    np.int64)
    return torch.from_numpy(at[inv])


def _float_codes(x: np.ndarray):
    u, inv = np.unique(x, return_inverse=True)
    return inv.reshape(-1), u.tolist()


class Bucket:
    """This rank's bucket of a `keyed_sort`, its rows in sorted order:
    `keys` (tensors and host arrays as given), `then`, `gid`, the
    payload `tensors` and `hosts`, `offset` (the bucket's first position
    in the sorted order of every rank's rows) and `start` (where a run
    of equal keys begins). `home` sends one answer a row back to the
    rank and position the row came from."""

    def __init__(self, route, order, keys, then, gid, tensors, hosts,
                 offset, start):
        self.route, self._order = route, order
        self.keys, self.then, self.gid = keys, then, gid
        self.tensors, self.hosts = tensors, hosts
        self.offset, self.start = offset, start

    def __len__(self) -> int:
        return len(self.gid)

    def home(self, t: torch.Tensor) -> torch.Tensor:
        """Answers (in bucket order) to the rows' own ranks: -> the
        answers to this rank's rows, in its row order."""
        back = torch.empty_like(t)
        back[self._order.to(t.device)] = t
        return self.route.back(back)


def keyed_sort(mesh, keys: Sequence, gid: torch.Tensor, then=(),
               tensors=(), hosts=()) -> Bucket:
    """The sample sort over the row mesh in which equal `keys` land on
    one rank. `keys` are float64 tensors or host object arrays (strings
    and None) of this rank's rows, `then` float64 tensors sorted on
    after them but not routed by, `gid` the rows' global ids (ties keep
    their order by them); `tensors` and `hosts` travel with the rows.
    The splitters are drawn from the keys alone (`splitters` on the
    device, `host_splitters` when a key is a host column). A
    collective."""
    from h2o3_tpu_torch.core.sharded_frame import Route, all_gather_counts

    dev = gid.device
    gid = gid.long()
    if any(isinstance(k, np.ndarray) for k in keys):
        dest = _host_dest(mesh, keys)
    else:
        order = lex_order(keys)
        dest = bucket_of(keys, splitters(mesh, [k[order] for k in keys]))
    route = Route(mesh, dest.to(dev))
    dev_keys = [k for k in keys if not isinstance(k, np.ndarray)]
    num = route.send(torch.stack(dev_keys + list(then) + [gid.double()], 1)
                     if dev_keys or then else gid.double()[:, None])
    got_gid = num[:, -1].long()
    it = iter(num[:, j] for j in range(num.shape[1] - 1))
    got_keys = [route.send_host(k) if isinstance(k, np.ndarray) else next(it)
                for k in keys]
    got_then = [next(it) for _ in then]
    got_t = [route.send(t) for t in tensors]
    got_h = [route.send_host(h) for h in hosts]
    lv = [torch.from_numpy(host_codes(k)[0]).to(dev).double()
          if isinstance(k, np.ndarray) else k for k in got_keys]
    order = lex_order(lv + got_then + [got_gid.double()]) if len(got_gid) \
        else torch.zeros(0, dtype=torch.long, device=dev)
    o_np = order.cpu().numpy()
    lv = [v[order] for v in lv]
    offset = sum(all_gather_counts(mesh, len(order))[: mesh.rank])
    return Bucket(route, order,
                  [k[o_np] if isinstance(k, np.ndarray) else k[order]
                   for k in got_keys],
                  [v[order] for v in got_then], got_gid[order],
                  [t[order.to(t.device)] for t in got_t],
                  [h[o_np] for h in got_h], offset,
                  run_starts(lv, len(order), dev))


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
