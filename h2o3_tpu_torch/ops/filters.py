"""Row selection (counterpart of h2o3_tpu/ops/filters.py `take_rows`
:104; the rest of the module, masks, slices and the device-order
gathers, is still to port with the Rapids ops, ROADMAP A11).

`take_rows` is what cross-validation needs: one gather per device
column with the row indices on the column's device, host columns
indexed on the host. Domains carry over unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame


def take_rows(frame: Frame, rows: np.ndarray,
              key: Optional[str] = None) -> Frame:
    """A new frame of `frame`'s rows at the host indices `rows`, in that
    order."""
    rows = np.asarray(rows, np.int64)
    k = len(rows)
    idx = {}
    out = Frame(key=key)
    for name in frame.names:
        c = frame.col(name)
        if c.data is None:
            out.add(name, Column(None, c.ctype, k,
                                 host_data=c.host_data[rows]))
            continue
        dev = c.data.device
        if dev not in idx:
            idx[dev] = torch.from_numpy(rows).to(dev)
        host = c.host_data[rows] if c.host_data is not None else None
        out.add(name, Column(c.data.index_select(0, idx[dev]), c.ctype, k,
                             domain=c.domain, host_data=host))
    return out
