"""Window functions on the device (counterpart of h2o3_tpu/ops/window.py).

`rank_within_groupby_device`: a stable lexsort composed of stable
argsorts (group keys senior, then the sort keys, each NaN-able level as a
NaN flag then the value, so NaN sorts last at its level as in
np.lexsort), then a segmented scan: group starts where the raw group
values change (NaN != NaN, so every NaN group row is its own group; enum
NA codes group together), a running count of rows whose sort keys are all
present, and the segment base propagated by a cumulative max. Rows with
an NA sort key get an NA rank. `difflag1_device` is the exact float32
one-lag difference. Columns without a tensor (strings) return None and
the caller takes the reference's host walk.

On a row-sharded frame both run on each rank's rows with a carry from
the ranks before it: `difflag1_device` takes the previous rank's last
row, and the rank runs on the sample sort (ops/sort.sample_sort_rows)
by the same levels and the row id, each bucket's segmented count
continuing the group that runs in from the buckets before it, the ranks
then routed home to their rows. Both are one process's bit for bit.
String group keys take `rank_keyed`, whose sample sort puts each group
on one rank (ops/sort.keyed_sort).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT, T_INT, T_NUM, \
    T_TIME
from h2o3_tpu_torch.ops.sort import stable_argsort

_DEV_CTYPES = (T_NUM, T_INT, T_CAT, T_TIME)


def _levels(g, s, asc):
    """The lexicographic levels of the rank order: per group key its NaN
    flag then its value, per sort key its NaN flag then its value (or
    its negation, descending), -0 read as +0."""
    levels = []
    for v in g:
        levels.append(torch.isnan(v).to(torch.int8))
        levels.append(torch.where(torch.isnan(v), 0.0, v) + 0.0)
    for v, a in zip(s, asc):
        levels.append(torch.isnan(v).to(torch.int8))
        levels.append(torch.where(torch.isnan(v), 0.0, v if a else -v) + 0.0)
    return levels


def rank_order(g, s, asc):
    """The stable lexicographic order of rows by group keys `g` then sort
    keys `s` (float32 tensors; `asc` per sort key)."""
    order = None
    for k in reversed(_levels(g, s, asc)):
        order = (stable_argsort(k) if order is None
                 else order[stable_argsort(k[order])])
    return order


def _starts(flags, vals) -> torch.Tensor:
    """Rows (in rank order) that start a group: a group key differs from
    the row before's, NaN differing from everything."""
    start = torch.zeros(len(vals), dtype=torch.bool, device=vals.device)
    if len(vals):
        start[0] = True
        start[1:] = ((flags[1:] > 0) | (flags[:-1] > 0)
                     | (vals[1:] != vals[:-1])).any(1)
    return start


def rank_within_groupby_device(fr: Frame, gidx: Sequence[int],
                               sidx: Sequence[int],
                               asc: Sequence[bool]) -> Optional[Column]:
    from h2o3_tpu_torch.core.sharded_frame import sharded_mesh

    cols = []
    for i in list(gidx) + list(sidx):
        c = fr.col(int(i))
        if c.ctype not in _DEV_CTYPES or c.data is None:
            return None
        cols.append(c.data.float())
    g, s = cols[:len(gidx)], cols[len(gidx):]
    mesh = sharded_mesh(fr)
    if mesh is not None:
        return _rank_sharded(fr, g, s, asc, mesh)
    n = fr.nrows
    order = rank_order(g, s, asc)
    start = torch.zeros(n, dtype=torch.bool, device=order.device)
    if n:
        start[0] = True
    for v in g:
        vs = v[order]
        start[1:] |= vs[1:] != vs[:-1]
    valid = torch.ones(n, dtype=torch.bool, device=order.device)
    for v in s:
        valid &= ~torch.isnan(v)
    vs_ = valid[order].long()
    c = torch.cumsum(vs_, 0)
    base = torch.cummax(torch.where(start, c - vs_, 0), 0).values
    rank_s = torch.where(valid[order], (c - base).float(), torch.nan)
    rank = torch.empty(n, dtype=torch.float32, device=order.device)
    rank[order] = rank_s
    return Column.from_device(rank, T_NUM, n)


def _rank_sharded(fr: Frame, g, s, asc, mesh) -> Column:
    """rank_within_groupby across the row mesh: the sample sort by the
    rank order's levels and the row id; each rank's segmented count of
    its bucket, the group that runs in from earlier buckets carrying its
    count (one all-gather of each bucket's boundary keys and counts);
    the ranks sent home to their rows' ranks. One process's bitwise."""
    from h2o3_tpu_torch.core import sharded_frame as SF
    from h2o3_tpu_torch.ops.sort import sample_sort_rows

    lo = fr.shard[0]
    dev = g[0].device if g else s[0].device
    gid = torch.arange(lo, lo + fr.local_rows, device=dev).double()
    got, _off = sample_sort_rows(mesh, [v.double() for v in
                                        _levels(g, s, asc)] + [gid])
    G = got[:, : 2 * len(g)]
    flags, vals = G[:, 0::2], G[:, 1::2]
    valid = (got[:, 2 * len(g):-1][:, 0::2] == 0).all(1)
    k = len(got)
    start = _starts(flags, vals)
    v = valid.long()
    c = torch.cumsum(v, 0)
    base = torch.cummax(torch.where(start, c - v, 0), 0).values
    inner = bool(start[1:].any()) if k else False
    last = int(c[-1] - base[-1]) if k else 0
    mine = ([k, float(inner), int(c[-1]) if k else 0, last]
            + (G[0].tolist() + G[-1].tolist() if k else [0.0] * 4 * len(g)))
    rows = SF.carry(mesh, mine)
    w = 2 * len(g)

    def opens(prev, first) -> bool:
        f = torch.as_tensor(np.stack([prev, first]))
        return bool(_starts(f[:, 0::2], f[:, 1::2])[1])

    run = None                     # (last group key, its count so far)
    for row in rows[: mesh.rank]:
        if row[0] == 0:
            continue
        first, lastkey = row[4:4 + w], row[4 + w:]
        cont = run is not None and not opens(run[0], first)
        count = run[1] + row[2] if cont and not row[1] else row[3]
        run = (lastkey, count)
    if k and run is not None and not opens(run[0], G[0].cpu().numpy()):
        # the first group runs in from earlier buckets: count on from it
        start[0] = False
        c = c + int(run[1])
        base = torch.cummax(torch.where(start, c - v, 0), 0).values
    rank_s = torch.where(valid, (c - base).double(), torch.nan)
    ids = got[:, -1].long()
    home = SF.Route(mesh, SF.owner_of(ids, fr.nrows, mesh.size))
    back = home.send(torch.stack([ids.double(), rank_s], 1))
    rank = torch.empty(fr.local_rows, dtype=torch.float32, device=dev)
    rank[(back[:, 0].long() - lo).to(dev)] = back[:, 1].float().to(dev)
    return Column.from_device(rank, T_NUM, fr.nrows)


def difflag1_device(col: Column) -> Optional[Column]:
    """One-lag difference on the device (row 0 is NA). On a row-sharded
    column the last row of the nearest rank before with rows is carried
    in (one all-gather)."""
    from h2o3_tpu_torch.core import sharded_frame as SF

    d = col.data
    if d is None:
        return None
    x = d.float()
    prev = torch.full((1,), torch.nan, device=x.device)
    mesh = SF.sharded_mesh(col)
    if mesh is not None:
        got = SF.carry(mesh, [len(x), float(x[-1]) if len(x) else 0.0])
        got = got[: mesh.rank]
        got = got[got[:, 0] > 0]
        if len(got):
            prev = torch.tensor([got[-1, 1]], dtype=torch.float32,
                                device=x.device)
    out = torch.cat([x[:1] - prev, x[1:] - x[:-1]])
    return Column.from_device(out[:len(x)], T_NUM, col.nrows)


def rank_keyed(fr: Frame, gidx: Sequence[int], sidx: Sequence[int],
               asc: Sequence[bool], mesh) -> Column:
    """rank_within_groupby with string group keys across the row mesh:
    the rows sample-sorted with equal group keys on one rank
    (ops/sort.keyed_sort, strings compared by value), each bucket sorted
    by the sort keys' levels and the row id, ranks counted within each
    group and sent home. A numeric group key's NaN row is a group of its
    own (NaN equals nothing), as in one process's host walk; a None in a
    string group key raises as that walk's sort does. One process's
    bitwise."""
    from h2o3_tpu_torch.core import sharded_frame as SF
    from h2o3_tpu_torch.core.frame import numeric_host, store_numeric, widen
    from h2o3_tpu_torch.ops.sort import keyed_sort
    from h2o3_tpu_torch.rapids.prims_sharded import device_of, row_ids

    dev = device_of(fr)
    n = fr.local_rows
    gid = row_ids(fr, dev)
    keys, none = [], False
    for i in gidx:
        c = fr.col(int(i))
        if c.data is None:
            h = np.asarray(c.host_data[:n], object)
            none |= bool((h == None).any())              # noqa: E711
            keys.append(h)
        else:
            v = widen(c.data).double()
            nan = torch.isnan(v)
            keys += [nan.double(), torch.where(nan, gid.double(), v + 0.0)]
    flag = torch.tensor([none], dtype=torch.int64)
    mesh.all_reduce(flag, "max")
    if flag[0] and fr.nrows > 1:
        raise TypeError("'<' not supported between instances of "
                        "'NoneType' and 'str'")
    s = [widen(fr.col(int(i)).data).float() for i in sidx]
    then = [v.double() for v in _levels([], s, asc)]
    b = keyed_sort(mesh, keys, gid, then=then)
    valid = torch.ones(len(b), dtype=torch.bool, device=dev)
    for f in b.then[0::2]:
        valid &= f == 0
    v = valid.long()
    c = torch.cumsum(v, 0)
    base = torch.cummax(torch.where(b.start, c - v, 0), 0).values \
        if len(b) else c
    rank = b.home(torch.where(valid, (c - base).double(), torch.nan))
    return Column(store_numeric(numeric_host(rank.cpu().numpy(), T_NUM),
                                T_NUM), T_NUM, fr.nrows)
