"""The row-mesh forms of the Rapids prims that reshape a frame, run user
code or key rows by strings (ROADMAP A14.6c part 1b): each gives, at
every rank's `mesh.row_block`, one process's result on the same rows,
without gathering a row of its sharded input.

- Row-local: `isax` (the label domain is the union of each rank's
  labels), `apply` by rows (each rank loops over its own rows) and by
  columns (the lambda runs on the sharded column; its reductions are the
  sharded prims), and `h2o.random_stratified_split` (the class counts
  all-gathered; every rank draws the same permutation of each class's
  positions and reads its own rows' positions from the counts of the
  ranks before it).
- Placed through the row exchange (`sharded_frame.place_rows`): `melt`
  (each output row's position from all-gathered kept counts), `t` (one
  exchange of each rank's rows of every column to the owner of that
  column's output row) and `x` (row-local against a second frame held
  whole; against a row-sharded one either all-gathering it or sending
  each rank the columns of the first frame that match its rows of the
  second and all-reducing the partial products, whichever moves fewer
  bytes).
- Equal keys on one rank (`ops/sort.keyed_sort`): `pivot` (one row per
  distinct index), `ddply` (each group's rows evaluated by the lambda
  on its owner as one process's sub-frame), `grouped_permute` and
  `tf-idf` (the (word, doc) pairs routed by word), each result row
  placed at its global offset.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from h2o3_tpu_torch.core import sharded_frame as SF
from h2o3_tpu_torch.core.frame import (Column, Frame, NA_CAT, T_CAT, T_NUM,
                                       T_STR, numeric_host, store_numeric,
                                       torch_code_dtype, widen)
from h2o3_tpu_torch.parallel import mesh as M


def device_of(fr: Frame) -> torch.device:
    """The device of the frame's first device column, else the
    runtime's."""
    for c in fr.columns:
        if c.data is not None:
            return c.data.device
    from h2o3_tpu_torch.core.runtime import cluster

    return cluster().device


def row_ids(fr: Frame, dev) -> torch.Tensor:
    """The global row ids of this rank's rows of a row-sharded frame."""
    lo = fr.shard[0]
    return torch.arange(lo, lo + fr.local_rows, device=dev)


def num_col(vals, nrows: int) -> Column:
    """float64 values (host or tensor) as `Column.from_numpy` stores
    them: this rank's block of an `nrows`-row numeric column."""
    if isinstance(vals, torch.Tensor):
        vals = vals.cpu().numpy()
    return Column(store_numeric(numeric_host(vals, T_NUM), T_NUM), T_NUM,
                  nrows)


def enum_col(codes, domain: List[str], nrows: int) -> Column:
    """Codes into `domain` (-1 NA) as `Column.from_numpy` stores an
    enum: this rank's block of an `nrows`-row column."""
    t = torch.as_tensor(np.asarray(codes, np.int64) if not isinstance(
        codes, torch.Tensor) else codes).long()
    from h2o3_tpu_torch.core.frame import _device

    return Column(t.to(torch_code_dtype(len(domain))).to(_device(None)),
                  T_CAT, nrows, domain=list(domain))


def _local_matrix(fr: Frame) -> torch.Tensor:
    """This rank's (rows, F) float64 matrix, as `_num_matrix` reads one
    process's (enum codes as numbers)."""
    return torch.stack([widen(fr.col(n).data).double() for n in fr.names],
                       dim=1)


def _check_cells(fr: Frame) -> None:
    from h2o3_tpu_torch.rapids.prims_ext import _HOST_MATRIX_MAX_CELLS

    cells = fr.nrows * max(len(fr.names), 1)
    if cells > _HOST_MATRIX_MAX_CELLS:
        raise ValueError(
            f"this operation copies the whole frame to the host "
            f"({fr.nrows} rows × {len(fr.names)} cols = {cells} cells > "
            f"cap {_HOST_MATRIX_MAX_CELLS}); subset the frame first")


def _place(mesh, pos: torch.Tensor, total: int, mat: torch.Tensor,
           hosts=()):
    """Rows of `mat` (and host arrays) to their global positions: this
    rank's block of the (total, width) result."""
    width = mat.shape[1]
    if width == 0:
        mat = torch.zeros(len(mat), 1, dtype=mat.dtype, device=mat.device)
    (got,), hs = SF.place_rows(mesh, pos, total, [mat], hosts)
    return got[:, :width], hs


def first_value(res) -> float:
    """The first value of a lambda's result (a scalar or a frame), read
    where a row-sharded frame holds it."""
    from h2o3_tpu_torch.rapids.eval import _is_fr, _scalar

    if not _is_fr(res):
        return float(_scalar(res))
    c = res.col(0)
    mesh = SF.sharded_mesh(c)
    if mesh is None:
        return float(np.asarray(res.to_numpy()).ravel()[0])
    has = c.shard[0] == 0 and c.local_rows > 0
    v = float(widen(c.data[:1]).double()[0]) if has else 0.0
    rows = SF.carry(mesh, [float(has), v])
    return float(rows[rows[:, 0] > 0][0, 1])


# -- row-local -------------------------------------------------------------------

def strat_split(c: Column, frac: float, seed, mesh) -> Column:
    """`h2o.random_stratified_split` of this rank's rows: one process's
    split bit for bit, no row moved."""
    y = widen(c.data).double().cpu().numpy()
    vals = y[y >= 0] if c.is_categorical else y
    classes = np.unique(np.concatenate(
        [np.asarray(p, np.float64) for p in
         SF.all_gather_object(mesh, np.unique(vals).tolist())]))
    hit = [y == cls for cls in classes]
    counts = mesh.all_gather(torch.tensor(
        [[int(h.sum()) for h in hit]], dtype=torch.int64)).numpy()
    before = counts[: mesh.rank].sum(0)
    rng = np.random.default_rng(seed)
    out = np.zeros(len(y))
    for ci, h in enumerate(hit):
        n_c = int(counts[:, ci].sum())
        perm = np.arange(n_c)
        rng.shuffle(perm)
        test = np.zeros(n_c, bool)
        test[perm[: int(round(n_c * frac))]] = True
        mine = np.nonzero(h)[0]
        out[mine] = test[before[ci] + np.arange(len(mine))]
    return num_col(out, c.nrows)


def isax(fr: Frame, W: int, C: int, mesh) -> Frame:
    """iSAX of this rank's rows; the index's domain is the sorted union
    of every rank's labels."""
    from statistics import NormalDist

    from h2o3_tpu_torch.rapids import fusion

    _check_cells(fr)
    fusion.note_host_cells(fr.local_rows * max(len(fr.names), 1))
    X = _local_matrix(fr).cpu().numpy()
    T = X.shape[1]
    mu = np.nanmean(X, axis=1, keepdims=True)
    sd = np.nanstd(X, axis=1, keepdims=True)
    Z = (X - mu) / np.where(sd > 0, sd, 1.0)
    edges = np.linspace(0, T, W + 1).astype(int)
    paa = np.stack([np.nanmean(Z[:, edges[i]:max(edges[i + 1],
                                                   edges[i] + 1)], axis=1)
                    for i in range(W)], axis=1)
    nd = NormalDist()
    brk = np.asarray([nd.inv_cdf(q) for q in np.linspace(0, 1, C + 1)[1:-1]])
    sym = np.searchsorted(brk, paa)
    from h2o3_tpu_torch.rapids.prims_ext import _isax_index

    out = Frame()
    out.add("iSax_index", _isax_index(sym, C, fr.nrows, mesh))
    for i in range(W):
        out.add(f"c{i}", num_col(sym[:, i].astype(np.float64), fr.nrows))
    return out


def apply_rows(env, fr: Frame, fun) -> Frame:
    """`apply` by rows: each rank evaluates the lambda on each of its own
    rows, as one process does (a one-row frame a row)."""
    from h2o3_tpu_torch.rapids import fusion
    from h2o3_tpu_torch.rapids.eval import _colfr

    _check_cells(fr)
    fusion.note_host_cells(fr.local_rows * max(len(fr.names), 1))
    with M.alone():
        vals = row_lambdas(env, fun, fr.names,
                           _local_matrix(fr).cpu().numpy())
    return _colfr(num_col(vals, fr.nrows), "apply")


def row_lambdas(env, fun, names: List[str], X: np.ndarray) -> np.ndarray:
    """The lambda's first value on each row of the float64 matrix `X`, a
    one-row frame of `names` a row, stored as `Column.from_numpy` stores
    it (the matrix goes to the device once; each row's columns are views
    of it)."""
    from h2o3_tpu_torch.rapids.eval import _eval_lambda

    D = store_numeric(numeric_host(X, T_NUM), T_NUM).T.contiguous()
    vals = np.empty(X.shape[0])
    for i in range(X.shape[0]):
        rf = Frame()
        for j, n in enumerate(names):
            rf.add(n, Column(D[j, i: i + 1], T_NUM, 1))
        vals[i] = first_value(_eval_lambda(env, fun, [rf]))
    return vals


# -- placed through the row exchange ----------------------------------------------

def transpose(fr: Frame, mesh) -> Frame:
    """`t`: the result's row j is the frame's column j; rank r holds the
    rows `row_block(ncols, r)`. Each rank sends its rows' values of
    every column to the owner of that column's row (one exchange)."""
    _check_cells(fr)
    n, k, R = fr.nrows, fr.ncols, mesh.size
    dev = device_of(fr)
    w = max(-(-n // R), 1)
    pad = torch.zeros(k, w, dtype=torch.float64, device=dev)
    if k:
        pad[:, : fr.local_rows] = _local_matrix(fr).T
    route = SF.Route(mesh, SF.owner_of(torch.arange(k, device=dev), k, R))
    got = route.send(pad)
    lo, hi = mesh.rows(k)
    km = hi - lo
    T = torch.cat([got[s * km:(s + 1) * km, : b - a] for s, (a, b) in
                   enumerate(M.row_block(n, s, R) for s in range(R))], 1)
    Th = T.cpu().numpy()
    out = Frame()
    for j in range(n):
        out.add(f"C{j + 1}", num_col(Th[:, j], k))
    return out


def mmult(a: Frame, b: Frame, mesh) -> Frame:
    """`x` with a row-sharded second frame (k x m): all-gather it
    (counted in ``gathered_rows``) or send each rank the first frame's
    columns that match its rows of the second and all-reduce the
    partial products, whichever moves fewer bytes."""
    from h2o3_tpu_torch.rapids.prims_ext import _dev_matrix

    R = mesh.size
    k, m, na = b.nrows, b.ncols, a.nrows
    a_sh = SF.sharded_mesh(a) is not None
    A = _dev_matrix(a)
    if (R - 1) * k * m <= (na * k * (R - 1) // R if a_sh else 0) \
            + 2 * (R - 1) * na * m:
        B = mesh.all_gather(_dev_matrix(b))
        SF.note_gathered(k)
        Mx = A @ B
    else:
        blo, bhi = b.shard
        if a_sh:
            wmax = max(-(-k // R), 1)
            parts = []
            for r in range(R):
                s, e = M.row_block(k, r, R)
                p = torch.zeros(len(A), wmax, dtype=A.dtype, device=A.device)
                p[:, : e - s] = A[:, s:e]
                parts.append(p)
            dest = torch.arange(R, device=A.device).repeat_interleave(len(A))
            As = SF.Route(mesh, dest).send(torch.cat(parts))[:, : bhi - blo]
        else:
            As = A[:, blo:bhi]
        P = As.double() @ _dev_matrix(b).double()
        mesh.all_reduce(P, "sum")
        lo, hi = mesh.rows(na)
        Mx = P[lo:hi].float()
    out = Frame()
    for j in range(Mx.shape[1]):
        out.add(f"C{j + 1}", Column.from_device(Mx[:, j].contiguous(), T_NUM,
                                                na))
    return out


def melt(fr: Frame, ids: List[str], vals: List[str], vn: str, valn: str,
         skip: bool, mesh) -> Frame:
    """`melt`: one process emits the rows value variable by value
    variable, each in row order; a rank's kept row of variable v goes to
    base(v) + (kept rows of v on earlier ranks) + its index."""
    dev = device_of(fr)
    xs, keeps = [], []
    for v in vals:
        x = widen(fr.col(v).data).double()
        keep = ~torch.isnan(x) if skip else torch.ones_like(x, dtype=bool)
        xs.append(x)
        keeps.append(torch.nonzero(keep).squeeze(1))
    counts = mesh.all_gather(torch.tensor([[len(k) for k in keeps]],
                                          dtype=torch.int64)).numpy()
    tot = counts.sum(0)
    base = np.concatenate([[0], np.cumsum(tot)[:-1]]) + \
        counts[: mesh.rank].sum(0)
    pos = torch.cat([b + torch.arange(len(k), device=dev)
                     for b, k in zip(base.tolist(), keeps)]) if vals else \
        torch.zeros(0, dtype=torch.long, device=dev)
    src = torch.cat(keeps) if vals else pos
    var = torch.cat([torch.full((len(k),), i, dtype=torch.float64,
                                device=dev) for i, k in enumerate(keeps)]) \
        if vals else pos.double()
    value = torch.cat([x[k] for x, k in zip(xs, keeps)]) if vals else \
        pos.double()
    total = int(tot.sum())
    id_dev = [c for c in ids if fr.col(c).data is not None]
    id_host = [c for c in ids if fr.col(c).data is None]
    src_np = src.cpu().numpy()
    ts, hs = SF.place_rows(
        mesh, pos, total,
        [value, var] + [fr.col(c).data.index_select(0, src.to(
            fr.col(c).data.device)) for c in id_dev],
        [np.asarray(fr.col(c).host_data, object)[src_np] for c in id_host])
    got = dict(zip(id_dev, ts[2:]))
    got.update(zip(id_host, hs))
    out = Frame()
    from h2o3_tpu_torch.ops.groupby import enum_of_labels

    for c in ids:
        col = fr.col(c)
        if col.data is None:
            out.add(c, Column(None, T_STR, total, host_data=got[c]))
        elif col.is_categorical:
            out.add(c, enum_of_labels(widen(got[c]).long(),
                                      list(col.domain or []), total, mesh))
        else:
            # one process's `values()` of a numeric column, as objects
            host = widen(got[c]).float().cpu().numpy().astype(object)
            out.add(c, Column(None, T_STR, total, host_data=host))
    dom = sorted(v for v, t in zip(vals, tot) if t > 0)
    lut = torch.tensor([dom.index(v) if t > 0 else NA_CAT
                        for v, t in zip(vals, tot)] or [NA_CAT],
                       dtype=torch.long)
    out.add(vn, enum_col(lut[ts[1].long().cpu()], dom, total))
    out.add(valn, num_col(ts[0], total))
    return out


# -- equal keys on one rank ---------------------------------------------------------

def runs(start: torch.Tensor):
    """(run id of each sorted row, each run's first row, its end)."""
    k = len(start)
    rid = torch.cumsum(start.long(), 0) - 1
    first = torch.nonzero(start).squeeze(1)
    end = torch.cat([first[1:], torch.tensor([k], device=start.device)])
    return rid, first, end


def pivot(fr: Frame, iname: str, cname: str, vname: str, mesh) -> Frame:
    """`pivot`: the rows keyed by their index value, one result row per
    distinct index (sorted, None last) on the rank that holds its rows;
    a later row overwrites an earlier one in a cell. The result's
    columns are the sorted distinct labels of `column`."""
    from h2o3_tpu_torch.ops.merge import _local_vals
    from h2o3_tpu_torch.ops.sort import keyed_sort

    dev = device_of(fr)
    sl = slice(0, fr.local_rows)
    ic = fr.col(iname)
    iv = _local_vals(ic, sl)
    cv = _local_vals(fr.col(cname), sl)
    ucol = sorted(set().union(*SF.all_gather_object(
        mesh, sorted({v for v in cv if v is not None}))))
    pos_c = {v: i for i, v in enumerate(ucol)}
    code = torch.tensor([-1 if v is None else pos_c[v] for v in cv],
                        dtype=torch.float64, device=dev)
    val = widen(fr.col(vname).data).double()
    b = keyed_sort(mesh, [iv], row_ids(fr, dev), tensors=[code, val])
    rid, first, _end = runs(b.start)
    g, C = len(first), len(ucol)
    Mloc = np.full((g, C), np.nan)
    cc = b.tensors[0].long().cpu().numpy()
    vv = b.tensors[1].cpu().numpy()
    ok = np.nonzero(cc >= 0)[0]
    cell = rid.cpu().numpy()[ok] * max(C, 1) + cc[ok]
    # the last row of each cell in row order (the bucket is in row order)
    _u, at = np.unique(cell[::-1], return_index=True)
    last = ok[len(ok) - 1 - at]
    Mloc[rid.cpu().numpy()[last], cc[last]] = vv[last]
    counts = SF.all_gather_counts(mesh, g)
    total = sum(counts)
    pos = sum(counts[: mesh.rank]) + torch.arange(g, device=dev)
    keys = b.keys[0][first.cpu().numpy()]
    mat, (keys,) = _place(mesh, pos, total,
                          torch.from_numpy(Mloc).to(dev), [keys])
    out = Frame()
    if ic.is_categorical:
        from h2o3_tpu_torch.ops.groupby import enum_of_labels

        dom = list(ic.domain or [])
        lut = {v: i for i, v in enumerate(dom)}
        idx = torch.tensor([-1 if v is None else lut[v] for v in keys],
                           dtype=torch.long, device=dev)
        out.add(iname, enum_of_labels(idx, dom, total, mesh))
    else:
        out.add(iname, Column(None, T_STR, total,
                              host_data=np.asarray(keys, object)))
    for j, cn in enumerate(ucol):
        out.add(str(cn), num_col(mat[:, j], total))
    return out


def _group_levels(fr: Frame, idx, gid: torch.Tensor) -> list:
    """Per numeric group key its NaN flag, then its value; a NaN key's
    value is its row id, so that each NaN row is a group of its own
    (NaN equals nothing), after the others at its level."""
    levels = []
    for i in idx:
        c = fr.col(int(i))
        if c.data is None:
            raise TypeError(f"group column {fr.names[int(i)]!r} is not "
                            "numeric")
        v = widen(c.data).double()
        nan = torch.isnan(v)
        levels += [nan.double(), torch.where(nan, gid.double(), v + 0.0)]
    return levels


def _send_frame(fr: Frame):
    """Every column of `fr` as keyed_sort payload: (tensors, hosts)."""
    return ([fr.col(n).data for n in fr.names if fr.col(n).data is not None],
            [np.asarray(fr.col(n).host_data[: fr.local_rows], object)
             for n in fr.names if fr.col(n).data is None])


def _sub_frame(fr: Frame, ts, hs, s: int, e: int) -> Frame:
    """Rows [s, e) of a bucket's payload as one process's frame (no
    mesh current)."""
    it, ih = iter(ts), iter(hs)
    sub = Frame()
    for n in fr.names:
        c = fr.col(n)
        if c.data is not None:
            sub.add(n, Column(next(it)[s:e], c.ctype, e - s,
                              domain=c.domain))
        else:
            sub.add(n, Column(None, c.ctype, e - s,
                              host_data=next(ih)[s:e]))
    return sub


def ddply(env, fr: Frame, idx, fun, mesh) -> Frame:
    """`ddply`: each group's rows go to one rank in row order, where the
    lambda runs on one process's sub-frame of them; the result rows, in
    sorted key order (NaN last), are placed at their global offsets and
    the width is the largest over every group."""
    from h2o3_tpu_torch.ops.sort import keyed_sort
    from h2o3_tpu_torch.rapids.eval import _eval_lambda, _is_fr

    dev = device_of(fr)
    gid = row_ids(fr, dev)
    ts, hs = _send_frame(fr)
    b = keyed_sort(mesh, _group_levels(fr, idx, gid), gid, tensors=ts,
                   hosts=hs)
    _rid, first, end = runs(b.start)
    keyvals = [b.keys[2 * j + 1] for j in range(len(idx))]
    rows_out, width = [], 0
    with M.alone():
        for s, e in zip(first.tolist(), end.tolist()):
            sub = _sub_frame(fr, b.tensors, b.hosts, s, e)
            res = _eval_lambda(env, fun, [sub])
            if _is_fr(res):
                vs = [float(v) for v in np.asarray(res.to_numpy(),
                                                   np.float64).ravel()]
            elif isinstance(res, (list, tuple)):
                vs = [float(v) for v in res]
            else:
                vs = [float(res)]
            key = [float("nan") if b.keys[2 * j][s] else float(keyvals[j][s])
                   for j in range(len(idx))]
            rows_out.append(key + vs)
            width = max(width, len(vs))
            sub.delete()
    wt = torch.tensor([width], dtype=torch.int64)
    mesh.all_reduce(wt, "max")
    width = int(wt[0])
    ncols = len(idx) + width
    Mloc = np.full((len(rows_out), ncols), np.nan)
    for i, row in enumerate(rows_out):
        Mloc[i, : len(row)] = row
    counts = SF.all_gather_counts(mesh, len(rows_out))
    total = sum(counts)
    pos = sum(counts[: mesh.rank]) + torch.arange(len(rows_out), device=dev)
    mat, _ = _place(mesh, pos, total, torch.from_numpy(Mloc).to(dev))
    out = Frame()
    for j, i in enumerate(idx):
        out.add(fr.names[int(i)], num_col(mat[:, j], total))
    for j in range(width):
        out.add(f"ddply_C{j + 1}", num_col(mat[:, len(idx) + j], total))
    return out


def _like(vals, dom, total: int) -> Column:
    """float64 values as `Column.from_numpy(vals, ctype="enum" if dom
    else None, domain=dom)` stores them."""
    if not dom:
        return num_col(vals, total)
    v = vals.cpu().numpy() if isinstance(vals, torch.Tensor) else vals
    codes = np.where(np.isnan(v), NA_CAT, v).astype(np.int64)
    return enum_col(codes, dom, total)


def grouped_permute(fr: Frame, pc: int, kb: int, pb: int, gb: List[int],
                    mesh) -> Frame:
    """`grouped_permute`: rows routed by their group's joined key
    string; the owner pairs each group's 'D' rows with its others, in
    one process's order (group, then In row, then Out row)."""
    from h2o3_tpu_torch.ops.sort import keyed_sort

    dev = device_of(fr)
    n = fr.local_rows
    names = [fr.names[i] for i in gb]

    def local(name):
        c = fr.col(name)
        return (widen(c.data).cpu().numpy() if c.data is not None
                else np.asarray(c.host_data[:n], object))

    g_np = [local(nm) for nm in names]
    gkey = np.asarray(["\x1f".join(t) for t in
                       zip(*[g.astype(str) for g in g_np])], object) \
        if n else np.zeros(0, object)
    pbcol = fr.col(fr.names[pb])
    dom = list(pbcol.domain or [])
    lab = widen(pbcol.data).long().cpu().numpy()
    is_d = np.asarray([dom[v] == "D" if 0 <= v < len(dom) else False
                       for v in lab], bool)
    pay = torch.tensor(np.stack(
        [widen(fr.col(fr.names[pc]).data).double().cpu().numpy(),
         widen(fr.col(fr.names[kb]).data).double().cpu().numpy(),
         is_d.astype(np.float64)] + [np.asarray(g, np.float64)
                                     for g in g_np], 1).reshape(n, -1),
        dtype=torch.float64, device=dev)
    b = keyed_sort(mesh, [gkey], row_ids(fr, dev), tensors=[pay])
    P = b.tensors[0].cpu().numpy()
    _rid, first, end = runs(b.start)
    blocks = []
    for s, e in zip(first.tolist(), end.tolist()):
        d = s + np.nonzero(P[s:e, 2] > 0)[0]
        o = s + np.nonzero(P[s:e, 2] == 0)[0]
        i, j = np.repeat(d, len(o)), np.tile(o, len(d))
        blocks.append(np.column_stack([P[i, 3:], P[i, 0], P[j, 0],
                                       P[i, 1], P[j, 1]]))
    Mloc = (np.concatenate(blocks) if blocks
            else np.zeros((0, len(gb) + 4)))
    counts = SF.all_gather_counts(mesh, len(Mloc))
    total = sum(counts)
    pos = sum(counts[: mesh.rank]) + torch.arange(len(Mloc), device=dev)
    mat, _ = _place(mesh, pos, total, torch.from_numpy(Mloc).to(dev))
    pdom = list(fr.col(fr.names[pc]).domain or []) or None
    kdom = list(fr.col(fr.names[kb]).domain or []) or None
    out = Frame()
    for j, nm in enumerate(names):
        out.add(nm, _like(mat[:, j], list(fr.col(nm).domain or []) or None,
                          total))
    ng = len(names)
    for j, (nm, d) in enumerate((("In", pdom), ("Out", pdom),
                                 ("InAmnt", kdom), ("OutAmnt", kdom))):
        out.add(nm, _like(mat[:, ng + j], d, total))
    return out


def tfidf(fr: Frame, di: int, ti: int, pre: bool, cs: bool, mesh) -> Frame:
    """`tf-idf`: each rank tokenises its rows; the (word, doc) pairs are
    routed by word, so the owner counts each pair's TF and each word's
    document count; the corpus's document count is the distinct
    documents' (routed by doc). Rows sorted by (word, doc), placed at
    their offsets; the Word domain is the owners' distinct words in
    order."""
    from h2o3_tpu_torch.ops.sort import keyed_sort

    dev = device_of(fr)
    docs = widen(fr.col(fr.names[di]).data).double().cpu().numpy()
    tc = fr.col(fr.names[ti])
    n = fr.local_rows
    if tc.is_string:
        words = np.asarray(tc.host_data[:n], object)
    elif tc.is_categorical:
        d = np.asarray(list(tc.domain or []) + [None], object)
        codes = widen(tc.data).long().cpu().numpy()
        words = d[np.where(codes < 0, len(d) - 1, codes)]
    else:
        words = widen(tc.data).cpu().numpy().astype(str).astype(object)
    pd_, pw = [], []
    for d, txt in zip(docs.tolist(), words):
        if txt is None:
            continue
        for tk in (str(txt).split() if pre else [str(txt)]):
            pd_.append(d)
            pw.append(tk if cs else tk.lower())
    k = len(pw)
    at = sum(SF.all_gather_counts(mesh, k)[: mesh.rank])
    pid = at + torch.arange(k, device=dev)
    darr = torch.tensor(pd_, dtype=torch.float64, device=dev)
    warr = np.empty(k, object)
    warr[:] = pw
    # the corpus's documents: each distinct doc id counted on one rank
    ud = torch.unique(darr)
    ub = keyed_sort(mesh, [ud], at + torch.arange(len(ud), device=dev))
    nd = torch.tensor([int(ub.start.sum())], dtype=torch.int64)
    mesh.all_reduce(nd, "sum")
    n_docs = int(nd[0])
    if n_docs == 0:
        raise ValueError("tf-idf: empty corpus")
    b = keyed_sort(mesh, [warr], pid, then=[darr])
    dd = b.then[0]
    pair = b.start.clone()
    if len(pair):
        pair[1:] |= dd[1:] != dd[:-1]
    prid, pfirst, pend = runs(pair)
    tf = (pend - pfirst).double()
    word_of = (torch.cumsum(b.start.long(), 0) - 1)[pfirst]
    df = torch.bincount(word_of, minlength=int(b.start.sum())).double() \
        if len(word_of) else torch.zeros(0, dtype=torch.float64, device=dev)
    mine = [w for w in b.keys[0][b.start.cpu().numpy()]]
    # the Word domain: every owner's distinct words, in owner order
    per = SF.all_gather_object(mesh, [w for w in mine if w != ""])
    dom = [w for part in per for w in part]
    off = sum(len(p) for p in per[: mesh.rank])
    wcode = np.full(len(mine), NA_CAT, np.int64)
    nz = np.asarray([w != "" for w in mine], bool)
    wcode[nz] = off + np.arange(int(nz.sum()))
    idf = np.asarray([math.log((n_docs + 1.0) / (float(x) + 1.0))
                      for x in df.tolist()], np.float64)
    w_np = word_of.cpu().numpy()
    mat = np.column_stack([dd[pfirst].cpu().numpy(),
                           wcode[w_np].astype(np.float64),
                           tf.cpu().numpy(), idf[w_np],
                           tf.cpu().numpy() * idf[w_np]]) \
        if len(pfirst) else np.zeros((0, 5))
    counts = SF.all_gather_counts(mesh, len(mat))
    total = sum(counts)
    pos = sum(counts[: mesh.rank]) + torch.arange(len(mat), device=dev)
    got, _ = _place(mesh, pos, total, torch.from_numpy(mat).to(dev))
    out = Frame()
    out.add("DocID", num_col(got[:, 0], total))
    out.add("Word", enum_col(got[:, 1].long(), dom, total))
    out.add("TF", num_col(got[:, 2], total))
    out.add("IDF", num_col(got[:, 3], total))
    out.add("TF-IDF", num_col(got[:, 4], total))
    return out
