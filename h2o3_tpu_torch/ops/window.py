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
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT, T_INT, T_NUM, \
    T_TIME
from h2o3_tpu_torch.ops.sort import stable_argsort

_DEV_CTYPES = (T_NUM, T_INT, T_CAT, T_TIME)


def rank_order(g, s, asc):
    """The stable lexicographic order of rows by group keys `g` then sort
    keys `s` (float32 tensors; `asc` per sort key)."""
    levels = []
    for v in g:
        levels.append(torch.isnan(v).to(torch.int8))
        levels.append(torch.where(torch.isnan(v), 0.0, v) + 0.0)
    for v, a in zip(s, asc):
        levels.append(torch.isnan(v).to(torch.int8))
        levels.append(torch.where(torch.isnan(v), 0.0, v if a else -v) + 0.0)
    order = None
    for k in reversed(levels):
        order = (stable_argsort(k) if order is None
                 else order[stable_argsort(k[order])])
    return order


def rank_within_groupby_device(fr: Frame, gidx: Sequence[int],
                               sidx: Sequence[int],
                               asc: Sequence[bool]) -> Optional[Column]:
    from h2o3_tpu_torch.core.sharded_frame import refuse

    refuse(fr, "a window function")
    cols = []
    for i in list(gidx) + list(sidx):
        c = fr.col(int(i))
        if c.ctype not in _DEV_CTYPES or c.data is None:
            return None
        cols.append(c.data.float())
    n = fr.nrows
    g, s = cols[:len(gidx)], cols[len(gidx):]
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


def difflag1_device(col: Column) -> Optional[Column]:
    """One-lag difference on the device (row 0 is NA)."""
    from h2o3_tpu_torch.core.sharded_frame import refuse

    refuse(col, "a window function")
    d = col.data
    if d is None:
        return None
    x = d.float()
    out = torch.cat([torch.full((1,), torch.nan, device=x.device),
                     x[1:] - x[:-1]])
    return Column.from_device(out[:col.nrows], T_NUM, col.nrows)
