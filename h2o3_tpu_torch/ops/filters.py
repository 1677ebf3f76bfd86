"""Row selection, binding and splitting (counterpart of
h2o3_tpu/ops/filters.py).

A selection is one device index tensor applied to every column (the
analog of H2O's row-aligned vector groups): `filter_rows` keeps the rows
whose mask is nonzero and not NA, in row order; `slice_rows` a range;
`take_rows` host indices; `take_order_rows` a device order such as a
sort's or a join's, which never goes to the host. Host-only (string)
columns are indexed on the host. Domains carry over unchanged. The
reference pads its gathers to its mesh; here nothing is padded.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import (Column, Frame, NA_CAT, T_CAT,
                                       torch_code_dtype)


def _gather(frame: Frame, idx: torch.Tensor, key: Optional[str] = None
            ) -> Frame:
    """A new frame of `frame`'s rows at the device indices `idx`."""
    k = int(idx.shape[0])
    host_idx = None
    moved = {}
    out = Frame(key=key)
    for name in frame.names:
        c = frame.col(name)
        if c.data is None or c.host_data is not None:
            if host_idx is None:
                host_idx = idx.cpu().numpy()
        if c.data is None:
            out.add(name, Column(None, c.ctype, k,
                                 host_data=c.host_data[host_idx]))
            continue
        dev = c.data.device
        if dev not in moved:
            moved[dev] = idx.to(dev)
        host = c.host_data[host_idx] if c.host_data is not None else None
        out.add(name, Column(c.data.index_select(0, moved[dev]), c.ctype, k,
                             domain=c.domain, host_data=host))
    return out


def take_rows(frame: Frame, rows, key: Optional[str] = None) -> Frame:
    """A new frame of `frame`'s rows at the host indices `rows`, in that
    order."""
    rows = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
    return _gather(frame, rows, key=key)


def take_order_rows(frame: Frame, order: torch.Tensor, k: int,
                    offset: int = 0, key: Optional[str] = None) -> Frame:
    """The `k` rows at a device order's positions [offset, offset + k)."""
    return _gather(frame, order[offset:offset + k].long(), key=key)


def filter_rows(frame: Frame, mask_col: Column,
                key: Optional[str] = None) -> Frame:
    """fr[mask, :]: the rows where the mask is nonzero; NA mask rows are
    dropped, as in H2O."""
    m = mask_col.data
    keep = torch.where(torch.isnan(m), False, m != 0)
    return _gather(frame, torch.nonzero(keep).squeeze(1), key=key)


def slice_rows(frame: Frame, start: int, stop: int,
               key: Optional[str] = None) -> Frame:
    n = frame.nrows
    start = max(0, min(start, n))
    stop = max(start, min(stop, n))
    return _gather(frame, torch.arange(start, stop), key=key)


def rbind(frames: Sequence[Frame], key: Optional[str] = None) -> Frame:
    """Stack frames by rows (AstRBind); enum domains are unioned and
    sorted, codes remapped."""
    total = sum(f.nrows for f in frames)
    out = Frame(key=key)
    f0 = frames[0]
    for ci, name in enumerate(f0.names):
        cols = [f.col(ci) for f in frames]
        ctype = cols[0].ctype
        if ctype == T_CAT:
            dom = sorted(set().union(*[set(c.domain or []) for c in cols]))
            lut = {v: i for i, v in enumerate(dom)}
            parts = []
            for c in cols:
                remap = torch.tensor([lut[v] for v in (c.domain or [])]
                                     or [NA_CAT], dtype=torch.long,
                                     device=c.data.device)
                codes = c.data.long()
                parts.append(torch.where(
                    codes >= 0, remap[codes.clamp_min(0)], NA_CAT))
            data = torch.cat([p.to(parts[0].device) for p in parts])
            out.add(name, Column(data.to(torch_code_dtype(len(dom))),
                                 T_CAT, total, domain=dom))
        elif cols[0].data is None:
            host = np.concatenate([c.host_data[: c.nrows] for c in cols])
            out.add(name, Column(None, ctype, total, host_data=host))
        else:
            dev = cols[0].data.device
            data = torch.cat([c.data.float().to(dev) for c in cols])
            out.add(name, Column(data, ctype, total))
    return out


def split_frame(frame: Frame, ratios: Sequence[float],
                seed: Optional[int] = None,
                destination_frames: Optional[Sequence[str]] = None
                ) -> List[Frame]:
    """Random row split (hex/SplitFrame.java): a uniform draw per row
    (numpy's default_rng, as the reference draws it), thresholded by the
    cumulative ratios."""
    rng = np.random.default_rng(seed)
    u = rng.random(frame.nrows)
    cuts = np.cumsum(list(ratios))
    if len(cuts) == 0 or cuts[-1] < 1.0:
        cuts = np.append(cuts, 1.0)
    assign = np.searchsorted(cuts, u, side="right")
    out = []
    for i in range(len(cuts)):
        k = destination_frames[i] if destination_frames else None
        out.append(take_rows(frame, np.nonzero(assign == i)[0], key=k))
    return out
