"""Frame sort (counterpart of h2o3_tpu/ops/sort.py `sort_frame` :199).

The permutation is built on the frame's device by stable argsorts
composed last key first (the lexicographic order), then applied to every
column without a host round trip. Keys follow the reference: an enum key
sorts by code with NA as NaN; a descending key is negated; NaN becomes
+inf, so NA rows and real +inf rows keep their row order among
themselves and come last. -0 is read as +0 so that every device's sort
sees one zero. On one device the reference takes this global argsort
too; its sample sort (:154) is for a multi-device mesh (ROADMAP A14.6b).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.ops.filters import take_order_rows


def sort_key(key: torch.Tensor) -> torch.Tensor:
    """NaN -> +inf and -0 -> +0 (adding +0 does that and nothing else)."""
    return torch.where(torch.isnan(key), torch.inf, key) + 0.0


def stable_argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.argsort(key, stable=True)


def sort_order(frame: Frame, names: Sequence[str],
               ascending: Sequence[bool]) -> torch.Tensor:
    """The device permutation sorting `frame` by `names`."""
    from h2o3_tpu_torch.core.sharded_frame import refuse

    refuse(frame, "a sort")
    order = None
    for name, asc in reversed(list(zip(names, ascending))):
        c = frame.col(name)
        if c.is_categorical:
            key = torch.where(c.data < 0, torch.nan, c.data.float())
        else:
            key = c.data.float()
        if not asc:
            key = -key
        key = sort_key(key)
        if order is None:
            order = stable_argsort(key)
        else:
            order = order[stable_argsort(key[order])]
    return order


def sort_frame(frame: Frame, by: Union[str, int, Sequence], ascending=True,
               rows: Optional[tuple] = None) -> Frame:
    """`frame` sorted by the key columns `by`; `rows=(lo, hi)` gathers
    only that window of the sorted rows."""
    from h2o3_tpu_torch.core.sharded_frame import refuse

    refuse(frame, "a sort")
    if isinstance(by, (str, int)):
        by = [by]
    names = [frame.names[b] if isinstance(b, int) else b for b in by]
    asc = (list(ascending) if isinstance(ascending, (list, tuple))
           else [ascending] * len(names))
    n = frame.nrows
    lo, hi = (0, n) if rows is None else (max(0, min(int(rows[0]), n)),
                                          max(0, min(int(rows[1]), n)))
    hi = max(lo, hi)
    order = sort_order(frame, names, asc)
    from h2o3_tpu_torch.core.sharded_frame import note_sorted

    note_sorted(n)          # the permutation stays on the device
    return take_order_rows(frame, order, hi - lo, offset=lo)
