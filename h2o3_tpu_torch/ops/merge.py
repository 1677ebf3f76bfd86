"""Frame joins (counterpart of h2o3_tpu/ops/merge.py).

The keys of both frames are ranked jointly on the device: per key
column the float32 values (enum codes remapped onto a union domain, NA
as NaN) get order-preserving dense ranks, and the ranks of a multi-column
key fold into one (the rank of the pair, re-densified). NA keys get a
rank that matches nothing. The right side is argsorted once (stably);
each left row's matches are the run [lo, hi) of its rank in it. The
inner join emits the left rows in order, each followed by its matches in
the right side's sorted order; left, right and full joins then append
the unmatched left rows (right side NA) and the unmatched right rows
(left side NA), as the reference does. Keys compare as float32, as in
the reference, so integer keys above 2**24 that round to the same
float32 match (ROADMAP C15). String and mixed-type keys take the host
hash join, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT
from h2o3_tpu_torch.ops.filters import take_order_rows, take_rows
from h2o3_tpu_torch.ops.sort import sort_key, stable_argsort


def _key_arrays(left: Frame, right: Frame, bx: Sequence[str],
                by: Sequence[str]):
    """Per key column (left, right) float32 tensors with NA as NaN, enum
    codes on a shared domain; None when a key needs the host join."""
    pairs = []
    for ln, rn in zip(bx, by):
        lc, rc = left.col(ln), right.col(rn)
        if lc.is_string or rc.is_string:
            return None
        if lc.is_categorical or rc.is_categorical:
            if not (lc.is_categorical and rc.is_categorical):
                return None
            pos = {v: i for i, v in enumerate(lc.domain or [])}
            rmap = []
            for v in rc.domain or []:
                rmap.append(pos.setdefault(v, len(pos)))
            rmap_t = torch.tensor(rmap or [0], dtype=torch.float32,
                                  device=rc.data.device)
            la = torch.where(lc.data >= 0, lc.data.float(), torch.nan)
            rcodes = rc.data.long()
            ra = torch.where(rcodes >= 0, rmap_t[rcodes.clamp_min(0)],
                             torch.nan)
        else:
            la, ra = lc.data.float(), rc.data.float()
        pairs.append((la, ra.to(la.device)))
    return pairs


def _dense_rank(v: torch.Tensor) -> torch.Tensor:
    return torch.unique(v, sorted=True, return_inverse=True)[1]


def matched_pairs(pairs, nl: int, nr: int):
    """-> (lo, cnt, order_r, r_matched): per left row the start of its
    matches in the sorted right side and their count, the right side's
    stable sort order, and which right rows have a partner."""
    n = nl + nr
    combined = None
    na = None
    for la, ra in pairs:
        v = torch.cat([la, ra])
        isna = torch.isnan(v)
        na = isna if na is None else na | isna
        rank = _dense_rank(sort_key(v))
        if combined is None:
            combined = rank
        else:
            combined = _dense_rank(combined * (int(rank.max()) + 1) + rank)
    lk = torch.where(na[:nl], n + 1, combined[:nl])
    rk = torch.where(na[nl:], n + 3, combined[nl:])
    order_r = stable_argsort(rk)
    rs = rk[order_r]
    lo = torch.searchsorted(rs, lk, side="left")
    cnt = torch.searchsorted(rs, lk, side="right") - lo
    ls = torch.sort(lk).values
    r_matched = (torch.searchsorted(ls, rk, side="right")
                 - torch.searchsorted(ls, rk, side="left")) > 0
    return lo, cnt, order_r, r_matched


def emit_pairs(lo, cnt, order_r, total: int):
    """(left row, right row) of the `total` matched pairs: left rows in
    order, each followed by its matches in the right side's sort order."""
    nl = cnt.shape[0]
    src = torch.repeat_interleave(torch.arange(nl, device=cnt.device), cnt,
                                  output_size=total)
    start = torch.cumsum(cnt, 0) - cnt
    within = torch.arange(total, device=cnt.device) - start[src]
    return src, order_r[lo[src] + within]


def _device_pairs(pairs, nl: int, nr: int, all_x: bool, all_y: bool):
    lo, cnt, order_r, r_matched = matched_pairs(pairs, nl, nr)
    total = int(cnt.sum())
    l_idx, r_idx = emit_pairs(lo, cnt, order_r, total)
    parts_l = [l_idx.cpu().numpy()]
    parts_r = [r_idx.cpu().numpy()]
    if all_x:
        miss = np.nonzero(cnt.cpu().numpy() == 0)[0]
        parts_l.append(miss)
        parts_r.append(np.full(len(miss), -1, np.int64))
    if all_y:
        missr = np.nonzero(~r_matched.cpu().numpy())[0]
        parts_l.append(np.full(len(missr), -1, np.int64))
        parts_r.append(missr)
    return (np.concatenate(parts_l).astype(np.int64),
            np.concatenate(parts_r).astype(np.int64))


def _host_pairs(left: Frame, right: Frame, bx, by, all_x, all_y):
    """Hash join over host key tuples (string or mixed-type keys); NA
    keys (None or NaN parts) match nothing, as on the device."""

    def tuples(frame, names):
        cols = []
        for n in names:
            c = frame.col(n)
            v = (c.values() if c.is_categorical or c.is_string
                 else c.to_numpy())
            cols.append(np.asarray(v, dtype=object))
        return list(zip(*cols)) if cols else []

    def has_na(kk):
        return any(v is None or (isinstance(v, float) and v != v)
                   for v in kk)

    lk = tuples(left, bx)
    rk = tuples(right, by)
    rindex: dict = {}
    for i, kk in enumerate(rk):
        if not has_na(kk):
            rindex.setdefault(kk, []).append(i)
    lrows, rrows = [], []
    matched_r = set()
    for i, kk in enumerate(lk):
        hits = None if has_na(kk) else rindex.get(kk)
        if hits:
            for j in hits:
                lrows.append(i)
                rrows.append(j)
                matched_r.add(j)
        elif all_x:
            lrows.append(i)
            rrows.append(-1)
    if all_y:
        for j in range(len(rk)):
            if j not in matched_r:
                lrows.append(-1)
                rrows.append(j)
    return np.asarray(lrows, np.int64), np.asarray(rrows, np.int64)


def merge(left: Frame, right: Frame, all_x=False, all_y=False,
          by_x: Optional[Sequence[str]] = None,
          by_y: Optional[Sequence[str]] = None) -> Frame:
    common = [n for n in left.names if n in right.names]
    bx = list(by_x) if by_x else common
    by = list(by_y) if by_y else common
    if not bx:
        raise ValueError("no join columns")

    pairs = _key_arrays(left, right, bx, by)
    lrows = rrows = None
    if pairs is not None and not all_x and not all_y:
        # inner join: the pair indices stay on the device
        lo, cnt, order_r, _ = matched_pairs(pairs, left.nrows, right.nrows)
        total = int(cnt.sum())
        l_idx, r_idx = emit_pairs(lo, cnt, order_r, total)
        lpart = take_order_rows(left, l_idx, total)
        rpart = take_order_rows(right, r_idx, total)
    else:
        if pairs is not None:
            lrows, rrows = _device_pairs(pairs, left.nrows, right.nrows,
                                         all_x, all_y)
        else:
            lrows, rrows = _host_pairs(left, right, bx, by, all_x, all_y)
        lpart = take_rows(left, np.maximum(lrows, 0))
        rpart = take_rows(right, np.maximum(rrows, 0))

    lneg = lrows is not None and (lrows < 0).any()
    rneg = rrows is not None and (rrows < 0).any()
    out = Frame()
    for n in left.names:
        col = lpart.col(n)
        if lneg:
            if n in bx and (rrows >= 0).any():
                # key columns of right-only rows come from the right side
                col = _patch_keys(col, right.col(by[bx.index(n)]),
                                  lrows, rrows)
            else:
                col = _mask_rows(col, lrows < 0)
        out.add(n, col)
    for n in right.names:
        if n in by:
            continue
        nm = n if n not in out else n + "_y"
        col = rpart.col(n)
        if rneg:
            col = _mask_rows(col, rrows < 0)
        out.add(nm, col)
    return out


def _host_vals(c: Column) -> np.ndarray:
    if c.is_string:
        return np.asarray([None if v is None else str(v)
                           for v in c.host_data[: c.nrows]], object)
    return np.asarray(c.values(), object)


def _patch_keys(lcol: Column, rcol: Column, lrows: np.ndarray,
                rrows: np.ndarray) -> Column:
    """Full/right joins: the key values of right-only rows (lrow -1)."""
    dev = lcol.device
    vals = _host_vals(lcol)
    fill = lrows < 0
    vals[fill] = _host_vals(rcol)[np.maximum(rrows[fill], 0)]
    if lcol.is_categorical:
        return Column.from_numpy(vals, ctype=T_CAT, device=dev)
    if lcol.is_string:
        return Column._from_strings(vals)
    return Column.from_numpy(np.asarray(
        [np.nan if v is None else float(v) for v in vals], np.float64),
        device=dev)


def _mask_rows(col: Column, na_mask: np.ndarray) -> Column:
    """The column with the rows of `na_mask` set to NA (numeric columns
    become real, as in the reference)."""
    if col.is_string:
        vals = _host_vals(col)
        vals[na_mask] = None
        return Column._from_strings(vals)
    dev = col.data.device
    mask = torch.from_numpy(na_mask).to(dev)
    if col.is_categorical:
        return Column(torch.where(mask, -1, col.data.int()).to(
            col.data.dtype), T_CAT, col.nrows, domain=col.domain)
    return Column.from_device(torch.where(mask, torch.nan, col.data.float()),
                              "real", col.nrows)
