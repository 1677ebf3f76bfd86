"""Row selection, binding and splitting (counterpart of
h2o3_tpu/ops/filters.py).

A selection is one device index tensor applied to every column (the
analog of H2O's row-aligned vector groups): `filter_rows` keeps the rows
whose mask is nonzero and not NA, in row order; `slice_rows` a range;
`take_rows` host indices; `take_order_rows` a device order such as a
sort's or a join's, which never goes to the host. Host-only (string)
columns are indexed on the host. Domains carry over unchanged. The
reference pads its gathers to its mesh; here nothing is padded.

On a row-sharded cloud each of these moves rows between ranks through
the row exchange (core/sharded_frame.py) so that every rank ends up
with its `mesh.row_block` of the output, and no rank gathers a column:
`filter_rows` all-gathers the ranks' kept counts for the output offsets
and places its kept rows (`place_frame`); `take_rows` (every rank
passes the same global indices), `slice_rows` and `take_order_rows` (a
global order held by every rank) each take their output block's rows
(`take_global_rows`); `rbind` places every frame's blocks at their
offsets, and `split_frame` draws its uniforms over all n rows on every
rank (the seed agreed first), so its parts are one process's bit for
bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import (Column, Frame, NA_CAT, T_CAT,
                                       torch_code_dtype)
from h2o3_tpu_torch.core.sharded_frame import sharded_mesh


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


def _take_block(frame: Frame, ids: torch.Tensor, key: Optional[str]):
    """Sharded: every rank holds the same `ids` (all of the output's
    global source rows); it takes its own block of them."""
    from h2o3_tpu_torch.core.sharded_frame import take_global_rows

    m = sharded_mesh(frame)
    lo, hi = m.rows(len(ids))
    return take_global_rows(frame, ids[lo:hi], len(ids), key=key)


def take_rows(frame: Frame, rows, key: Optional[str] = None) -> Frame:
    """A new frame of `frame`'s rows at the host indices `rows`, in that
    order (on a row-sharded cloud every rank passes the same indices)."""
    rows = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
    if sharded_mesh(frame) is not None:
        return _take_block(frame, rows, key)
    return _gather(frame, rows, key=key)


def take_order_rows(frame: Frame, order: torch.Tensor, k: int,
                    offset: int = 0, key: Optional[str] = None) -> Frame:
    """The `k` rows at a device order's positions [offset, offset + k)."""
    if sharded_mesh(frame) is not None:
        return _take_block(frame, order[offset:offset + k].long(), key)
    return _gather(frame, order[offset:offset + k].long(), key=key)


def filter_rows(frame: Frame, mask_col: Column,
                key: Optional[str] = None) -> Frame:
    """fr[mask, :]: the rows where the mask is nonzero; NA mask rows are
    dropped, as in H2O."""
    m = mask_col.data
    keep = torch.where(torch.isnan(m), False, m != 0)
    return keep_rows(frame, torch.nonzero(keep).squeeze(1), key=key)


def keep_rows(frame: Frame, idx: torch.Tensor, key: Optional[str] = None,
              with_ids: bool = False):
    """The rows `idx` (indices into this process's rows, ascending) of
    `frame`, in row order. On a row-sharded cloud every rank passes its
    own rows' indices: an all-gather of the kept counts gives each rank
    its output offset, and its kept rows are placed (`place_frame`).
    With `with_ids` -> (the frame, the global row ids of its rows here)."""
    mesh = sharded_mesh(frame)
    if mesh is None:
        out = _gather(frame, idx, key=key)
        return (out, idx) if with_ids else out
    from h2o3_tpu_torch.core.sharded_frame import (all_gather_counts,
                                                   place_frame, place_rows)

    counts = all_gather_counts(mesh, len(idx))
    pos = sum(counts[: mesh.rank]) + torch.arange(len(idx))
    out = place_frame(frame, idx, pos, sum(counts), key=key)
    if not with_ids:
        return out
    (ids,), _ = place_rows(mesh, pos, sum(counts), [frame.shard[0] + idx])
    return out, ids


def slice_rows(frame: Frame, start: int, stop: int,
               key: Optional[str] = None) -> Frame:
    n = frame.nrows
    start = max(0, min(start, n))
    stop = max(start, min(stop, n))
    mesh = sharded_mesh(frame)
    if mesh is not None:
        from h2o3_tpu_torch.core.sharded_frame import take_global_rows

        lo, hi = mesh.rows(stop - start)
        return take_global_rows(frame, torch.arange(start + lo, start + hi),
                                stop - start, key=key)
    return _gather(frame, torch.arange(start, stop), key=key)


def rbind(frames: Sequence[Frame], key: Optional[str] = None) -> Frame:
    """Stack frames by rows (AstRBind); enum domains are unioned and
    sorted, codes remapped."""
    if any(sharded_mesh(f) is not None for f in frames):
        return _rbind_sharded(frames, key)
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


def _rbind_sharded(frames: Sequence[Frame], key: Optional[str]) -> Frame:
    """rbind on a row-sharded cloud: each frame's codes remapped onto the
    union domain (domains are the same on every rank) on its own rows,
    then every frame's block placed at its offset in the output."""
    from h2o3_tpu_torch.core import sharded_frame as SF
    from h2o3_tpu_torch.core.frame import widen

    mesh = next(sharded_mesh(f) for f in frames
                if sharded_mesh(f) is not None)
    total = sum(f.nrows for f in frames)
    f0 = frames[0]
    cols = {}
    for ci, name in enumerate(f0.names):
        srcs = [f.col(ci) for f in frames]
        ctype = srcs[0].ctype
        parts, hosts = [], []
        if ctype == T_CAT:
            dom = sorted(set().union(*[set(c.domain or []) for c in srcs]))
            lut = {v: i for i, v in enumerate(dom)}
        for f, c in zip(frames, srcs):
            lo, hi = f.shard or mesh.rows(f.nrows)
            sl = slice(0, hi - lo) if f.shard is not None else slice(lo, hi)
            if ctype == T_CAT:
                remap = torch.tensor([lut[v] for v in (c.domain or [])]
                                     or [NA_CAT], dtype=torch.long,
                                     device=c.data.device)
                codes = c.data[sl].long()
                parts.append(torch.where(codes >= 0,
                                         remap[codes.clamp_min(0)], NA_CAT))
            elif c.data is None:
                hosts.append(c.host_data[sl])
            else:
                parts.append(widen(c.data[sl]).float())
        dev = parts[0].device if parts else None
        # this rank's rows of every frame, placed below
        if ctype == T_CAT:
            cols[name] = (ctype, dom, torch.cat([p.to(dev) for p in parts]
                                                ).to(torch_code_dtype(len(dom))))
        elif parts:
            cols[name] = (ctype, None, torch.cat([p.to(dev) for p in parts]))
        else:
            cols[name] = (ctype, None, np.concatenate(hosts))
    pos, at = [], 0
    for f in frames:
        lo, hi = f.shard or mesh.rows(f.nrows)
        pos.append(at + torch.arange(lo, hi))
        at += f.nrows
    positions = torch.cat(pos) if pos else torch.zeros(0, dtype=torch.long)
    tens = [v for _t, _d, v in cols.values() if isinstance(v, torch.Tensor)]
    hs = [v for _t, _d, v in cols.values() if isinstance(v, np.ndarray)]
    got_t, got_h = SF.place_rows(mesh, positions, total, tens, hs)
    out = Frame(key=key)
    it, ih = iter(got_t), iter(got_h)
    for name, (ctype, dom, v) in cols.items():
        if isinstance(v, torch.Tensor):
            out.add(name, Column(next(it), ctype, total, domain=dom))
        else:
            out.add(name, Column(None, ctype, total, host_data=next(ih)))
    return out


def split_frame(frame: Frame, ratios: Sequence[float],
                seed: Optional[int] = None,
                destination_frames: Optional[Sequence[str]] = None
                ) -> List[Frame]:
    """Random row split (hex/SplitFrame.java): a uniform draw per row
    (numpy's default_rng, as the reference draws it), thresholded by the
    cumulative ratios."""
    mesh = sharded_mesh(frame)
    if mesh is not None and seed is None:
        from h2o3_tpu_torch.core.sharded_frame import agreed_int

        seed = agreed_int(mesh, np.random.SeedSequence().entropy % 2 ** 62)
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


def stratified_fold_ids(y: np.ndarray, k: int, rng, n: int,
                        lo: int = 0, mesh=None) -> np.ndarray:
    """Stratified fold ids of the rows [lo, lo + len(y)) of an n-row
    column whose class values there are `y` (NaN or a negative code is
    NA): a uniform draw for every row, then per class (ascending) a
    round-robin over its rows shuffled, from a random start. The class
    shuffle is drawn as a permutation of the class's m rows (the draws of
    ``rng.shuffle`` on them), so on a row-sharded cloud each rank needs
    only every class's counts on the ranks before it, never the rows:
    the ids are one process's bit for bit."""
    assign = rng.integers(0, k, n)[lo:lo + len(y)]
    valid = ~np.isnan(y) if y.dtype.kind == "f" else y >= 0
    classes = np.unique(y[valid])
    if mesh is None:
        before = np.zeros(len(classes), np.int64)
        total = np.array([int((y == c).sum()) for c in classes], np.int64)
    else:
        from h2o3_tpu_torch.core.sharded_frame import all_gather_object

        classes = np.array(sorted(set().union(*all_gather_object(
            mesh, classes.tolist()))), dtype=y.dtype)
        mine = torch.tensor([[int((y == c).sum()) for c in classes]],
                            dtype=torch.int64).reshape(1, len(classes))
        every = mesh.all_gather(mine).numpy()
        before, total = every[: mesh.rank].sum(0), every.sum(0)
    for ci, cls in enumerate(classes):
        rows = np.nonzero(y == cls)[0]
        perm = rng.permutation(int(total[ci]))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        start = rng.integers(k)
        assign[rows] = (inv[before[ci] + np.arange(len(rows))] + start) % k
    return assign
