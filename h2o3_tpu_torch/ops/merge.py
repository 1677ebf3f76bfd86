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

On a row-sharded cloud (a sharded left frame with a sharded or a
replicated right frame) the join is a sort-merge join over the row
mesh: every rank's non-NA keys of both sides are range-partitioned by
splitters drawn from an all-gathered sample of them (equal keys land
on one rank), sent there with their global row ids (one ``all_to_all``
a side), and joined there as above. The matched pairs go back to the
rank of their left row, which orders them as one process does (left
row, then right row) and finds its unmatched left rows; unmatched
right rows go back to their own rank. All-gathered counts give every
piece its offset in the one-process order, and the pairs of global row
ids, placed at those offsets (`place_rows`), take both sides' rows
(`take_global_rows`). All of it runs on the rank's device; only the
splitters' sample goes through the host (`ops/sort.splitters`, shared
with the sample sort). String and mixed-type keys take the host join's
form of it: both sides' keys (strings and numbers told apart, as the
host join's dict tells them apart) are sample-sorted together with
equal keys on one rank (`ops/sort.keyed_sort`), the owner pairs each
key's left rows with its right rows, and the pairs, with the unmatched
left rows in their place among them (as `_host_pairs` emits them), go
home to be ordered as one process orders them. The output is one
process's, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT, T_STR
from h2o3_tpu_torch.ops.filters import take_order_rows, take_rows
from h2o3_tpu_torch.ops.sort import (bucket_of, lex_order, sort_key,
                                     splitters, stable_argsort)


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
    from h2o3_tpu_torch.core import sharded_frame as SF

    if SF._is_sharded(left) or SF._is_sharded(right):
        return _merge_sharded(left, right, all_x, all_y, bx, by)

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


def _mask_rows(col: Column, na_mask) -> Column:
    """The column with the rows of `na_mask` (a host array or a tensor)
    set to NA (numeric columns become real, as in the reference)."""
    if col.is_string:
        vals = _host_vals(col)
        vals[np.asarray(torch.as_tensor(na_mask).cpu())] = None
        return Column(None, T_STR, col.nrows, host_data=vals)
    dev = col.data.device
    mask = torch.as_tensor(na_mask).to(dev)
    if col.is_categorical:
        return Column(torch.where(mask, -1, col.data.int()).to(
            col.data.dtype), T_CAT, col.nrows, domain=col.domain)
    return Column.from_device(torch.where(mask, torch.nan, col.data.float()),
                              "real", col.nrows)


# -- the sort-merge join over the row mesh --------------------------------------

def _local_rows(frame: Frame, mesh):
    """(lo, hi, local slice) of the rows this rank joins: its block of a
    sharded frame, the same block of a replicated one."""
    if frame.shard is not None:
        lo, hi = frame.shard
        return lo, hi, slice(0, hi - lo)
    lo, hi = mesh.rows(frame.nrows)
    return lo, hi, slice(lo, hi)


def _merge_sharded(left: Frame, right: Frame, all_x: bool, all_y: bool,
                   bx, by) -> Frame:
    from h2o3_tpu_torch.core import sharded_frame as SF

    mesh = SF.mesh_of(left if SF._is_sharded(left) else right)
    pairs = _key_arrays(left, right, bx, by)
    parts = (_device_join(left, right, all_x, all_y, pairs, mesh)
             if pairs is not None else
             _host_join(left, right, all_x, all_y, bx, by, mesh))
    return _assemble(left, right, all_x, all_y, bx, by, mesh, *parts)


def _device_join(left: Frame, right: Frame, all_x: bool, all_y: bool,
                 pairs, mesh):
    """The sort-merge join of device keys: -> (left ids, right ids,
    output positions, total) of this rank's pieces."""
    from h2o3_tpu_torch.core import sharded_frame as SF

    N = mesh.size
    dev = pairs[0][0].device
    llo, lhi, lsl = _local_rows(left, mesh)
    rlo, rhi, rsl = _local_rows(right, mesh)
    lkeys = [sort_key(la[lsl]).double() for la, _ra in pairs]
    rkeys = [sort_key(ra[rsl]).double() for _la, ra in pairs]
    lna = torch.zeros(lhi - llo, dtype=torch.bool, device=dev)
    rna = torch.zeros(rhi - rlo, dtype=torch.bool, device=dev)
    for (la, ra) in pairs:
        lna |= torch.isnan(la[lsl])
        rna |= torch.isnan(ra[rsl])
    lgid = torch.arange(llo, lhi, dtype=torch.float64, device=dev)
    rgid = torch.arange(rlo, rhi, dtype=torch.float64, device=dev)
    # splitters on the keys alone, from both sides' non-NA keys: equal
    # keys land on one rank
    both = [torch.cat([lk[~lna], rk[~rna]]) for lk, rk in zip(lkeys, rkeys)]
    order = lex_order(both)
    splits = splitters(mesh, [b[order] for b in both])

    def ship(keys, gid, na):
        keys = [k[~na] for k in keys]
        route = SF.Route(mesh, bucket_of(keys, splits))
        return route.send(torch.stack(keys + [gid[~na]], 1))

    lgot = ship(lkeys, lgid, lna)
    rgot = ship(rkeys, rgid, rna)
    # the join of this rank's bucket: rows arrive in global row order
    nk = len(pairs)
    cat = [torch.cat([lgot[:, j], rgot[:, j]]) for j in range(nk)]
    nl = len(lgot)
    dense = torch.zeros(nl + len(rgot), dtype=torch.long, device=dev)
    if len(dense):
        rank = lex_order(cat)
        sk = torch.stack(cat, 1)[rank]
        newk = torch.ones(len(rank), dtype=torch.bool, device=dev)
        newk[1:] = (sk[1:] != sk[:-1]).any(1)
        dense[rank] = torch.cumsum(newk.long(), 0) - 1
    lk, rk = dense[:nl], dense[nl:]
    order_r = stable_argsort(rk)
    rs = rk[order_r]
    lo = torch.searchsorted(rs, lk, side="left")
    cnt = torch.searchsorted(rs, lk, side="right") - lo
    total_b = int(cnt.sum())
    li, ri = emit_pairs(lo, cnt, order_r, total_b)
    pl = lgot[:, -1].long()[li]
    pr = rgot[:, -1].long()[ri]
    # the pairs go to their left row's rank, in (left, right) order
    route = SF.Route(mesh, SF.owner_of(pl, left.nrows, N))
    got = route.send(torch.stack([pl, pr], 1))
    if len(got):
        got = got[lex_order([got[:, 0], got[:, 1]])]
    mine_l, mine_r = got[:, 0], got[:, 1]
    matched = SF.all_gather_counts(mesh, len(got))
    M = sum(matched)
    parts_l, parts_r, parts_p = [mine_l], [mine_r], \
        [sum(matched[: mesh.rank]) + torch.arange(len(got), device=dev)]
    at = M
    if all_x:
        # pairs went to the rank that joins their left row's block
        seen = torch.zeros(lhi - llo, dtype=torch.bool, device=dev)
        seen[mine_l - llo] = True
        miss = torch.arange(llo, lhi, device=dev)[~seen]
        ul = SF.all_gather_counts(mesh, len(miss))
        parts_l.append(miss)
        parts_r.append(torch.full((len(miss),), -1, dtype=torch.long,
                                  device=dev))
        parts_p.append(at + sum(ul[: mesh.rank])
                       + torch.arange(len(miss), device=dev))
        at += sum(ul)
    if all_y:
        rm = torch.zeros(len(rgot), dtype=torch.bool, device=dev)
        rm[ri] = True
        miss = rgot[:, -1].long()[~rm]
        um = SF.Route(mesh, SF.owner_of(miss, right.nrows, N)).send(miss)
        # NA-keyed right rows never left their rank
        um = torch.sort(torch.cat([um, rgid.long()[rna]])).values
        ur = SF.all_gather_counts(mesh, len(um))
        parts_l.append(torch.full((len(um),), -1, dtype=torch.long,
                                  device=dev))
        parts_r.append(um)
        parts_p.append(at + sum(ur[: mesh.rank])
                       + torch.arange(len(um), device=dev))
        at += sum(ur)
    return parts_l, parts_r, parts_p, at


def _join_keys(left: Frame, right: Frame, bx, by, lsl, rsl):
    """Per key column both sides' values of this rank's rows, left's then
    right's, as the host join compares them: strings (enum labels) as
    host strings, numbers as float64 tensors, a string beside a number
    tagged apart (they never match); -> (keys, left NA, right NA)."""
    from h2o3_tpu_torch.core.frame import widen

    keys, nas = [], []
    for ln, rn in zip(bx, by):
        lc, rc = left.col(ln), right.col(rn)
        texts = [c.is_string or c.is_categorical for c in (lc, rc)]
        if not any(texts):
            v = torch.cat([widen(lc.data[lsl]).double(),
                           widen(rc.data[rsl]).double().to(lc.data.device)])
            keys.append(v)
            nas.append(torch.isnan(v).cpu().numpy())
            continue
        v = np.concatenate([_local_vals(lc, lsl), _local_vals(rc, rsl)])
        na = np.fromiter((x is None or (isinstance(x, float) and x != x)
                          for x in v), bool, len(v))
        if not all(texts):
            t = np.empty(len(v), object)
            t[:] = [None if a else (0, x) if isinstance(x, str)
                    else (1, float(x)) for x, a in zip(v, na)]
            v = t
        keys.append(v)
        nas.append(na)
    na = np.logical_or.reduce(nas)
    nl = lsl.stop - lsl.start
    return keys, na[:nl], na[nl:]


def _host_join(left: Frame, right: Frame, all_x: bool, all_y: bool, bx,
               by, mesh):
    """The host join (`_host_pairs`) over the row mesh: both sides' rows
    sample-sorted together with equal keys on one rank
    (`ops/sort.keyed_sort`; a right row's id offset past every left
    row's, so each key's left rows come first), each key's left rows
    paired with its right rows there. -> (left ids, right ids, output
    positions, total) of this rank's pieces."""
    from h2o3_tpu_torch.core import sharded_frame as SF
    from h2o3_tpu_torch.ops.sort import keyed_sort

    dev = _dev_of(left, right)
    llo, lhi, lsl = _local_rows(left, mesh)
    rlo, rhi, rsl = _local_rows(right, mesh)
    keys, lna, rna = _join_keys(left, right, bx, by, lsl, rsl)
    ok = np.concatenate([~lna, ~rna])
    okt = torch.from_numpy(ok).to(dev)
    nL = left.nrows
    gid = torch.cat([torch.arange(llo, lhi, device=dev),
                     nL + torch.arange(rlo, rhi, device=dev)])
    b = keyed_sort(mesh, [k[ok] if isinstance(k, np.ndarray) else
                          k[okt.to(k.device)] for k in keys], gid[okt])
    rid = torch.cumsum(b.start.long(), 0) - 1
    is_r = b.gid >= nL
    lk, rk = rid[~is_r], rid[is_r]
    lo = torch.searchsorted(rk, lk, side="left")
    cnt = torch.searchsorted(rk, lk, side="right") - lo
    li, ri = emit_pairs(lo, cnt, torch.arange(len(rk), device=dev),
                        int(cnt.sum()))
    pl, pr = b.gid[~is_r][li], b.gid[is_r][ri] - nL
    route = SF.Route(mesh, SF.owner_of(pl, left.nrows, mesh.size))
    got = route.send(torch.stack([pl, pr], 1))
    mine_l, mine_r = got[:, 0], got[:, 1]
    if all_x:
        # unmatched left rows take their place among the pairs
        seen = torch.zeros(lhi - llo, dtype=torch.bool, device=dev)
        seen[mine_l - llo] = True
        miss = torch.arange(llo, lhi, device=dev)[~seen]
        mine_l = torch.cat([mine_l, miss])
        mine_r = torch.cat([mine_r, torch.full_like(miss, -1)])
    o = _lex(mine_l, mine_r)
    mine_l, mine_r = mine_l[o], mine_r[o]
    cnt = SF.all_gather_counts(mesh, len(mine_l))
    parts_l, parts_r = [mine_l], [mine_r]
    parts_p = [sum(cnt[: mesh.rank]) + torch.arange(len(mine_l), device=dev)]
    at = sum(cnt)
    if all_y:
        lcount = torch.bincount(lk, minlength=int(b.start.sum()))
        um = b.gid[is_r][lcount[rk] == 0] - nL
        um = SF.Route(mesh, SF.owner_of(um, right.nrows, mesh.size)).send(um)
        na = rlo + torch.from_numpy(np.nonzero(rna)[0]).to(dev)
        um = torch.sort(torch.cat([um, na])).values
        ur = SF.all_gather_counts(mesh, len(um))
        parts_l.append(torch.full_like(um, -1))
        parts_r.append(um)
        parts_p.append(at + sum(ur[: mesh.rank])
                       + torch.arange(len(um), device=dev))
        at += sum(ur)
    return parts_l, parts_r, parts_p, at


def _lex(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return lex_order([a, b]) if len(a) else \
        torch.zeros(0, dtype=torch.long, device=a.device)


def _dev_of(*frames):
    for fr in frames:
        for c in fr.columns:
            if c.data is not None:
                return c.data.device
    return torch.device("cpu")


def _local_vals(c: Column, sl) -> np.ndarray:
    """`_host_vals` of this rank's rows `sl` of `c`: labels for an enum
    (None for NA), strings, or the numbers as floats."""
    if c.is_string:
        return np.asarray([None if v is None else str(v)
                           for v in c.host_data[sl]], object)
    from h2o3_tpu_torch.core.frame import widen

    d = widen(c.data[sl]).cpu().numpy()
    if c.is_categorical:
        dom = np.asarray(list(c.domain or []) + [None], object)
        return dom[np.where(d < 0, len(dom) - 1, d)]
    return d.astype(object)


def _assemble(left: Frame, right: Frame, all_x: bool, all_y: bool, bx, by,
              mesh, parts_l, parts_r, parts_p, total: int) -> Frame:
    """The joined frame from every rank's (left id, right id, position)
    pieces: this rank's block of it."""
    from h2o3_tpu_torch.core import sharded_frame as SF

    (l_ids, r_ids), _ = SF.place_rows(mesh, torch.cat(parts_p), total,
                                      [torch.cat(parts_l),
                                       torch.cat(parts_r)])
    lpart = SF.take_global_rows(left, l_ids.clamp_min(0), total)
    rpart = SF.take_global_rows(right, r_ids.clamp_min(0), total)
    inner = not all_x and not all_y
    flags = torch.stack([(l_ids < 0).any(), (r_ids < 0).any(),
                         (r_ids >= 0).any()]).long()
    mesh.all_reduce(flags, "max")
    lneg, rneg, any_r = (not inner and bool(flags[0]),
                         not inner and bool(flags[1]), bool(flags[2]))
    out = Frame()
    for n in left.names:
        col = lpart.col(n)
        if lneg:
            if n in bx and any_r:
                col = _patch_keys_sharded(col, rpart.col(by[bx.index(n)]),
                                          l_ids < 0, mesh)
            else:
                col = _mask_rows(col, l_ids < 0)
        out.add(n, col)
    for n in right.names:
        if n in by:
            continue
        nm = n if n not in out else n + "_y"
        col = rpart.col(n)
        if rneg:
            col = _mask_rows(col, r_ids < 0)
        out.add(nm, col)
    return out


def _patch_keys_sharded(lcol: Column, rcol: Column, fill: torch.Tensor,
                        mesh) -> Column:
    """`_patch_keys` on this rank's rows: an enum key's domain is the
    labels present in the cloud's rows (all-gathered), as one process
    re-interns them; a numeric key becomes real. The codes stay on the
    device; only the domains' labels go through the host."""
    from h2o3_tpu_torch.core import sharded_frame as SF
    from h2o3_tpu_torch.core.frame import NA_CAT, torch_code_dtype, widen

    dev = lcol.device
    f = fill.to(dev)
    if lcol.is_string or rcol.is_string:
        return _patch_keys_host(lcol, rcol, fill, mesh)
    if not lcol.is_categorical:
        v = torch.where(f, widen(rcol.data).float().to(dev),
                        widen(lcol.data).float())
        return Column(v, "real", lcol.nrows)
    ldom, rdom = list(lcol.domain or []), list(rcol.domain or [])
    lc, rc = widen(lcol.data).long(), widen(rcol.data).long().to(dev)
    use_r, use_l = f & (rc >= 0), ~f & (lc >= 0)
    present = {rdom[i] for i in torch.unique(rc[use_r]).tolist()}
    present |= {ldom[i] for i in torch.unique(lc[use_l]).tolist()}
    present.discard("")
    dom = sorted(set().union(*SF.all_gather_object(mesh, sorted(present))))
    lut = {v: i for i, v in enumerate(dom)}

    def table(d):
        return torch.tensor([lut.get(v, NA_CAT) for v in d] or [NA_CAT],
                            dtype=torch.long, device=dev)

    codes = torch.full_like(lc, NA_CAT)
    codes = torch.where(use_r, table(rdom)[rc.clamp_min(0)], codes)
    codes = torch.where(use_l, table(ldom)[lc.clamp_min(0)], codes)
    return Column(codes.to(torch_code_dtype(len(dom))), T_CAT, lcol.nrows,
                  domain=dom)


def _patch_keys_host(lcol: Column, rcol: Column, fill: torch.Tensor,
                     mesh) -> Column:
    """`_patch_keys` on this rank's rows where a key is a string column:
    the values as the host join reads them; an enum key's domain is the
    labels present in the cloud's rows (all-gathered)."""
    from h2o3_tpu_torch.core import sharded_frame as SF
    from h2o3_tpu_torch.core.frame import (NA_CAT, numeric_host,
                                           store_numeric, torch_code_dtype)

    sl = slice(0, lcol.local_rows)
    vals = _local_vals(lcol, sl)
    f = fill.cpu().numpy()
    vals[f] = _local_vals(rcol, sl)[f]
    if lcol.is_string:
        return Column(None, T_STR, lcol.nrows, host_data=vals)
    if not lcol.is_categorical:
        return Column(store_numeric(numeric_host(np.asarray(
            [np.nan if v is None else float(v) for v in vals], np.float64),
            "real"), "real", lcol.device), "real", lcol.nrows)
    labels = [None if v is None or (isinstance(v, float) and v != v)
              or v == "" else str(v) for v in vals]
    present = sorted({v for v in labels if v is not None})
    dom = sorted(set().union(*SF.all_gather_object(mesh, present)))
    lut = {v: i for i, v in enumerate(dom)}
    codes = torch.tensor([NA_CAT if v is None else lut[v] for v in labels],
                         dtype=torch.long)
    return Column(codes.to(torch_code_dtype(len(dom))).to(lcol.device),
                  T_CAT, lcol.nrows, domain=dom)
