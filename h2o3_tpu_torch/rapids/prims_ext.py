"""Extended Rapids primitive suites: advmath, matrix, repeaters, search,
string, time, timeseries, mungers and the closing set of named prims
(counterpart of h2o3_tpu/rapids/prims_ext.py; the reference:
water/rapids/ast/prims/*).

Numeric work (cor, distance, moments, matrix products, arg-extremes,
fills, row sums) runs as PyTorch ops on the columns' device; the prims
whose output is host-shaped (transpose, per-row lambdas, iSAX) and the
string and time suites run on the host, as in the reference (strings
never reach the device; string transforms of enum columns work on the
domain). Prim names are the strings h2o-py's ExprNode emits.
"""

from __future__ import annotations

import math as _math
from typing import List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core import sharded_frame as SF
from h2o3_tpu_torch.core.frame import (Column, Frame, T_CAT, T_NUM, T_TIME,
                                       numeric_host, store_numeric, widen)
from h2o3_tpu_torch.ops.rollups import moments
from h2o3_tpu_torch.rapids import prims_sharded as PS
from h2o3_tpu_torch.rapids.eval import (NumList, StrLit, _colfr, agreed_seed,
                                        _eval_lambda, _idx_list, _is_fr,
                                        _one_col, _percol, _row_sum, _s,
                                        _scalar, prim)


# only the host-shaped prims (transpose, per-row lambda apply, iSAX) copy
# a frame to the host, and only up to this many cells (the reference's
# default cap)
_HOST_MATRIX_MAX_CELLS = 100_000_000


def _num_col(vals, nrows: int, replicate: bool = False) -> Column:
    """float64 host values as a numeric column, stored as
    `Column.from_numpy` stores them but holding exactly `vals`: a rank's
    block of an `nrows`-row column, or with `replicate` a small result
    (a table, a matrix) held whole on every rank."""
    col = Column(store_numeric(numeric_host(vals, T_NUM), T_NUM), T_NUM,
                 nrows)
    return SF.replicated(col) if replicate else col


def _num_matrix(fr: Frame) -> np.ndarray:
    cells = fr.nrows * max(len(fr.names), 1)
    if cells > _HOST_MATRIX_MAX_CELLS:
        raise ValueError(
            f"this operation copies the whole frame to the host "
            f"({fr.nrows} rows × {len(fr.names)} cols = {cells} cells > "
            f"cap {_HOST_MATRIX_MAX_CELLS}); subset the frame first")
    # the exceptional host path: its cost shows on the fusion counters
    from h2o3_tpu_torch.rapids import fusion

    fusion.note_host_cells(cells)
    return np.column_stack([np.asarray(fr.col(n).to_numpy(), np.float64)
                            for n in fr.names])


# ---------------------------------------------------------------------------
# advmath (ast/prims/advmath)
# ---------------------------------------------------------------------------

def _dev_matrix(fr: Frame) -> torch.Tensor:
    """The (nrows, F) float32 matrix of the frame's columns on their
    device: numeric NAs are NaN, enum columns give their codes (NA -1),
    as the reference reads them."""
    return torch.stack([fr.col(n).data.float() for n in fr.names], dim=1)


def _corr(X, Y, usemode: str, method: str, mesh=None):
    """Correlation matrix of X's and Y's columns: moments over the
    usable rows in float64 (complete.obs drops rows with an NA;
    everything lets NaN propagate), in two passes (the means, then the
    centred sums of squares and products), whose sums a row-sharded
    frame all-reduces (`mesh`); spearman ranks are midranks from sort
    and searchsorted with unusable rows pushed to +inf (across the
    ranks, `_ranks_sharded`)."""
    if usemode == "complete.obs":
        w = ~(torch.isnan(X).any(dim=1) | torch.isnan(Y).any(dim=1))
    else:
        w = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)

    if method == "spearman":
        def ranks(M):
            return (_ranks_sharded(M, w, mesh) if mesh is not None
                    else _midranks(M, w))
        X, Y = (ranks(X),) * 2 if Y is X else (ranks(X), ranks(Y))
    fx, fy = X.shape[1], Y.shape[1]
    Xd = torch.where(w[:, None], X.double(), 0.0)
    Yd = torch.where(w[:, None], Y.double(), 0.0)
    s1 = torch.cat([w.sum().double()[None], Xd.sum(0), Yd.sum(0)])
    if mesh is not None:
        mesh.all_reduce(s1, "sum")
    n_used = s1[0]
    nn = torch.clamp_min(n_used, 1.0)
    Xc = torch.where(w[:, None], Xd - s1[1:1 + fx] / nn, 0.0)
    Yc = torch.where(w[:, None], Yd - s1[1 + fx:] / nn, 0.0)
    s2 = torch.cat([(Xc ** 2).sum(0), (Yc ** 2).sum(0),
                    (Xc.T @ Yc).reshape(-1)])
    if mesh is not None:
        mesh.all_reduce(s2, "sum")
    denom = torch.sqrt(torch.outer(s2[:fx], s2[fx:fx + fy]))
    C = s2[fx + fy:].reshape(fx, fy) / torch.clamp_min(denom, 1e-30)
    return torch.where(n_used > 0, C, torch.nan)


def _midranks(M, w):
    """Spearman's midranks of each column of one process's `M` (float32),
    its unusable rows (~`w`) pushed to +inf: sort and searchsorted."""
    out = []
    for j in range(M.shape[1]):
        cv = torch.where(w, M[:, j], torch.inf)
        s = torch.sort(cv).values
        lo = torch.searchsorted(s, cv, side="left")
        hi = torch.searchsorted(s, cv, side="right")
        out.append((lo + hi + 1).float() / 2.0)
    return torch.stack(out, dim=1)


def _ranks_sharded(M, w, mesh):
    """Spearman's midranks of each column of this rank's rows `M` across
    the row mesh: the values (unusable rows +inf, NaN after everything)
    sample-sorted with equal values on one rank (`ops/sort.keyed_sort`),
    so a value's first and last positions in the sorted order are its
    bucket's offset plus its run's ends; the ranks go home through the
    route (float32, as one process's)."""
    from h2o3_tpu_torch.ops.sort import keyed_sort

    gid = torch.arange(len(M), device=M.device) + \
        sum(SF.all_gather_counts(mesh, len(M))[: mesh.rank])
    out = []
    for j in range(M.shape[1]):
        cv = torch.where(w, M[:, j], torch.inf).double()
        nan = torch.isnan(cv)
        b = keyed_sort(mesh, [nan.double(), torch.where(nan, 0.0, cv) + 0.0],
                       gid)
        rid, first, end = PS.runs(b.start)
        lo = b.offset + first[rid]
        hi = b.offset + end[rid]
        out.append(b.home(((lo + hi + 1).float() / 2.0).to(M.device)))
    return torch.stack(out, dim=1)


@prim("cor")
def _cor(env, fr, other, use, method="pearson"):
    """Correlation matrix or vector (AstCorrelation). use: everything |
    complete.obs | all.obs; method: pearson | spearman. On a row-sharded
    frame (`other` sharded alike, or held whole and read at this rank's
    block) the ranks come from the sample sort, the moments are
    all-reduced and the matrix is held whole on every rank."""
    method = _s(method).strip('"').lower()
    usemode = _s(use).strip('"')
    X = _dev_matrix(fr)
    same = not (_is_fr(other) and other is not fr)
    mesh = SF.sharded_mesh(fr)
    Y = X if same else _dev_matrix(other)
    if mesh is not None and not same and SF.sharded_mesh(other) is None:
        lo, hi = fr.shard
        Y = Y[lo:hi]            # a frame held whole: this rank's rows
    C = _corr(X, Y, usemode, method, mesh)
    if C.shape == (1, 1):
        return float(C[0, 0])
    C = C.cpu().numpy()
    out = Frame()
    for j, n in enumerate((other if _is_fr(other) else fr).names):
        out.add(n, _num_col(C[:, j], C.shape[0], replicate=True))
    return out


@prim("distance")
def _distance(env, fr, other, measure):
    """Pairwise distances (AstDistance): rows of fr x rows of other; up
    to 64 result columns stay on the device. A row-sharded `fr` gives
    each rank the distances of its rows; `other`, whose every row each
    output row needs, is held whole (all-gathered when row-sharded, its
    rows counted in ``gathered_rows``)."""
    measure = _s(measure).strip('"').lower()
    A = _dev_matrix(fr)
    B = _dev_matrix(other)
    om = SF.sharded_mesh(other)
    if om is not None:
        B = om.all_gather(B)
        SF.note_gathered(other.nrows)
    if measure in ("l2", "euclidean"):
        aa = torch.sum(A * A, dim=1)[:, None]
        bb = torch.sum(B * B, dim=1)[None, :]
        D = torch.sqrt(torch.clamp_min(aa + bb - 2 * A @ B.T, 0.0))
    elif measure == "l1":
        D = torch.abs(A[:, None, :] - B[None, :, :]).sum(-1)
    else:           # cosine / cosine_sq
        an = A / torch.clamp_min(torch.linalg.norm(A, dim=1, keepdim=True),
                                 1e-12)
        bn = B / torch.clamp_min(torch.linalg.norm(B, dim=1, keepdim=True),
                                 1e-12)
        D = an @ bn.T
        if measure == "cosine_sq":
            D = D * D
    out = Frame()
    m = other.nrows
    if m <= 64:
        for j in range(m):
            out.add(f"C{j + 1}", Column.from_device(D[:, j].contiguous(),
                                                    T_NUM, fr.nrows))
    else:
        Dh = D.cpu().numpy().astype(np.float64)
        for j in range(m):
            out.add(f"C{j + 1}", _num_col(Dh[:, j], fr.nrows))
    return out


def _bin_count(b: str, c: Column, d: torch.Tensor, n: int, lo: float,
               hi: float, mesh) -> int:
    """The bin count a `breaks` string names for the n values d (float64,
    no NaN) of `c`, between lo and hi: numpy's `histogram_bin_edges`
    estimators for doane, scott and fd (their widths from float64
    moments all-reduced across `mesh`, or from the quartiles)."""
    if b in ("sturges", "Sturges"):
        return int(np.ceil(np.log2(max(n, 2)) + 1))
    if b in ("rice", "Rice"):
        return int(np.ceil(2 * n ** (1 / 3)))
    if b in ("sqrt", "Sqrt"):
        return int(np.ceil(np.sqrt(n)))
    b = b.lower()
    if b not in ("doane", "scott", "fd"):
        return int(float(b))
    if not n:
        return 1            # no values: the breaks are [0, 1]
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError(f"autodetected range of [{lo}, {hi}] is not "
                         "finite")
    first, last = (lo - 0.5, hi + 0.5) if lo == hi else (lo, hi)
    if b == "fd":
        from h2o3_tpu_torch.ops.quantile import quantile_column

        q75, q25 = quantile_column(c, [0.75, 0.25])
        width = 2.0 * (q75 - q25) * n ** (-1.0 / 3.0)
    else:
        _n, _t, s2, s3 = moments(d, 3, mesh)
        sigma = np.sqrt(s2 / n)
        if b == "scott":
            width = ((24.0 * np.pi ** 0.5) / n) ** (1.0 / 3.0) * sigma
        elif n > 2 and sigma > 0.0:
            sg1 = np.sqrt(6.0 * (n - 2) / ((n + 1.0) * (n + 3)))
            g1 = s3 / n / sigma ** 3
            width = (hi - lo) / (1.0 + np.log2(n) + np.log2(
                1.0 + np.absolute(g1) / sg1))
        else:
            width = 0.0
    return max(int(np.ceil((last - first) / width)) if width else 1, 1)


@prim("hist")
def _hist(env, fr, breaks):
    """AstHist: histogram frame (breaks, counts, mids_true, mids, density),
    counted as `np.histogram` counts ([e_i, e_i+1), the last bin closed).
    On a row-sharded frame the count, min and max (and the moments a
    rule needs) are all-reduced, each rank counts its rows between the
    breaks and the counts are all-reduced as int64; the table is held
    whole on every rank."""
    c = _one_col(fr)
    mesh = SF.sharded_mesh(c)
    d = widen(c.data).double()
    d = d[~torch.isnan(d)]
    part = torch.tensor([len(d), float(d.min()) if len(d) else np.inf,
                         -float(d.max()) if len(d) else np.inf],
                        dtype=torch.float64)
    if mesh is not None:
        mesh.all_reduce(part[:1], "sum")
        mesh.all_reduce(part[1:], "min")
    n, lo, hi = int(part[0]), float(part[1]), -float(part[2])
    if isinstance(breaks, (NumList, list)):
        edges = np.asarray([float(b) for b in breaks])
    else:
        k = _bin_count(_s(breaks).strip('"'), c, d, n, lo, hi, mesh)
        edges = np.linspace(lo, hi, k + 1) if n else np.array([0.0, 1.0])
    np.histogram(np.zeros(0), bins=edges)        # its checks of the edges
    xs = torch.sort(d).values
    e = torch.as_tensor(edges, dtype=torch.float64, device=xs.device)
    cum = torch.cat([torch.searchsorted(xs, e[:-1], right=False),
                     torch.searchsorted(xs, e[-1:], right=True)])
    if mesh is not None:
        mesh.all_reduce(cum, "sum")
    counts = np.diff(cum.cpu().numpy())
    mids = 0.5 * (edges[:-1] + edges[1:])
    widths = np.diff(edges)
    dens = counts / np.maximum(counts.sum() * widths, 1e-300)
    out = Frame()
    for nm, v in (("breaks", edges[1:]),
                  ("counts", counts.astype(np.float64)),
                  ("mids_true", mids), ("mids", mids), ("density", dens)):
        out.add(nm, _num_col(v, len(v), replicate=True))
    return out


def _moment_stat(fr, power: int, na_rm) -> list:
    """Skewness (power 3) or kurtosis (4) of each numeric column in
    float64: on a row-sharded frame its moments are all-reduced."""
    mesh = SF.sharded_mesh(fr)
    out = []
    for n in fr.names:
        c = fr.col(n)
        if not c.is_numeric:
            out.append(float("nan"))
            continue
        nn, _t, s2, sk = moments(widen(c.data).double(), power, mesh)
        m2 = s2 / max(nn - 1, 1.0)
        mk = sk / max(nn, 1.0)
        out.append(float(mk / max(m2 ** (power / 2.0), 1e-300)))
    return out


@prim("skewness")
def _skewness(env, fr, na_rm=True):
    v = _moment_stat(fr, 3, na_rm)
    return v[0] if len(v) == 1 else v


@prim("kurtosis")
def _kurtosis(env, fr, na_rm=True):
    v = _moment_stat(fr, 4, na_rm)
    return v[0] if len(v) == 1 else v


@prim("mode")
def _mode(env, fr):
    from h2o3_tpu_torch.ops.impute import mode_of

    return mode_of(_one_col(fr))


@prim("kfold_column")
def _kfold(env, fr, nfolds, seed):
    n = fr.nrows
    rng = np.random.default_rng(agreed_seed(fr, float(_scalar(seed))))
    return _colfr(Column.from_numpy(
        rng.integers(0, int(_scalar(nfolds)), n).astype(np.float64)), "kfold")


@prim("modulo_kfold_column")
def _modulo_kfold(env, fr, nfolds):
    return _colfr(Column.from_numpy(
        (np.arange(fr.nrows) % int(_scalar(nfolds))).astype(np.float64)),
        "kfold")


@prim("stratified_kfold_column")
def _strat_kfold(env, fr, nfolds, seed):
    from h2o3_tpu_torch.core import sharded_frame as SF
    from h2o3_tpu_torch.ops.filters import stratified_fold_ids

    c = _one_col(fr)
    rng = np.random.default_rng(agreed_seed(fr, float(_scalar(seed))))
    if c.shard is None:
        assign = stratified_fold_ids(np.asarray(c.to_numpy()),
                                     int(_scalar(nfolds)), rng, c.nrows)
    else:
        # this rank's rows: the class counts cross ranks, the rows do not
        assign = stratified_fold_ids(
            widen(c.data).cpu().numpy(), int(_scalar(nfolds)), rng,
            c.nrows, c.shard[0], SF.mesh_of(c))
    # the rows this process holds, as `Column.from_numpy` stores them
    return _colfr(Column(store_numeric(numeric_host(
        assign.astype(np.float64), T_NUM), T_NUM, None), T_NUM, c.nrows),
        "kfold")


@prim("h2o.random_stratified_split")
def _strat_split(env, fr, test_frac, seed):
    c = _one_col(fr)
    frac = float(_scalar(test_frac))
    sd = agreed_seed(fr, int(_scalar(seed)))
    mesh = SF.sharded_mesh(c)
    if mesh is not None:
        return _colfr(PS.strat_split(c, frac, sd, mesh), "split")
    y = np.asarray(c.to_numpy())
    rng = np.random.default_rng(sd)
    out = np.zeros(len(y))
    for cls in np.unique(y[y >= 0] if c.is_categorical else y):
        idx = np.nonzero(y == cls)[0]
        rng.shuffle(idx)
        out[idx[: int(round(len(idx) * frac))]] = 1.0
    return _colfr(Column.from_numpy(out), "split")


# ---------------------------------------------------------------------------
# matrix (ast/prims/matrix)
# ---------------------------------------------------------------------------

@prim("t")
def _transpose(env, fr):
    mesh = SF.sharded_mesh(fr)
    if mesh is not None:
        return PS.transpose(fr, mesh)
    M = _num_matrix(fr).T
    out = Frame()
    for j in range(M.shape[1]):
        out.add(f"C{j + 1}", Column.from_numpy(M[:, j]))
    return out


@prim("x")
def _mmult(env, a, b):
    """AstMMult: A (n x k) @ B (k x m) on the device; the result columns
    stay there. A row-sharded A against a B held whole is row-local; a
    row-sharded B is `prims_sharded.mmult`."""
    if a.ncols != b.nrows:
        raise ValueError(f"x: non-conformable ({a.ncols} cols vs "
                         f"{b.nrows} rows)")
    mesh = SF.sharded_mesh(b)
    if mesh is not None:
        return PS.mmult(a, b, mesh)
    M = _dev_matrix(a) @ _dev_matrix(b)
    out = Frame()
    for j in range(M.shape[1]):
        out.add(f"C{j + 1}", Column.from_device(M[:, j].contiguous(), T_NUM,
                                                a.nrows))
    return out


# ---------------------------------------------------------------------------
# repeaters (ast/prims/repeaters)
# ---------------------------------------------------------------------------

@prim("rep_len")
def _rep_len(env, x, length):
    n = int(_scalar(length))
    if _is_fr(x):
        vals = np.asarray(_one_col(x).to_numpy(), np.float64)
    else:
        vals = np.asarray([float(x)])
    return _colfr(Column.from_numpy(np.resize(vals, n)), "rep_len")


@prim("seq")
def _seq(env, frm, to, by):
    a, b, s = _scalar(frm), _scalar(to), _scalar(by)
    vals = np.arange(a, b + (s / 2 if s > 0 else -s / 2), s, dtype=np.float64)
    return _colfr(Column.from_numpy(vals), "seq")


@prim("seq_len")
def _seq_len(env, n):
    return _colfr(Column.from_numpy(
        np.arange(1, int(_scalar(n)) + 1, dtype=np.float64)), "seq_len")


# ---------------------------------------------------------------------------
# search (ast/prims/search)
# ---------------------------------------------------------------------------

@prim("match")
def _match(env, fr, table, nomatch=float("nan"), *_):
    c = _one_col(fr)
    if isinstance(table, (NumList, list)):
        tbl = [t.s if isinstance(t, StrLit) else t for t in table]
    else:
        tbl = [table.s if isinstance(table, StrLit) else table]
    nm = float("nan") if (not isinstance(nomatch, (int, float))
                          or nomatch != nomatch) else float(nomatch)
    if c.is_categorical:
        lut = np.full(max(c.cardinality, 1), nm, np.float64)
        for pos, t in enumerate(tbl):
            t = str(t)
            if t in (c.domain or []):
                lut[c.domain.index(t)] = pos + 1          # R 1-based match
        codes = np.asarray(c.to_numpy())
        vals = np.where(codes >= 0, lut[np.maximum(codes, 0)], nm)
    else:
        x = np.asarray(c.to_numpy(), np.float64)
        vals = np.full(len(x), nm)
        for pos, t in enumerate(tbl):
            vals = np.where(x == float(t), pos + 1, vals)
    return _colfr(Column.from_numpy(vals), "match")


@prim("which")
def _which(env, fr):
    """The row indices of the nonzero, non-NA values. On a row-sharded
    frame each rank finds its own rows' global indices and places them
    at their output positions (`row_block`s of the result)."""
    c = _one_col(fr)
    x = widen(c.data).double()
    idx = torch.nonzero(~torch.isnan(x) & (x != 0)).squeeze(1)
    mesh = SF.sharded_mesh(c)
    total = len(idx)
    if mesh is not None:
        counts = SF.all_gather_counts(mesh, total)
        total = sum(counts)
        pos = sum(counts[: mesh.rank]) + torch.arange(len(idx))
        (idx,), _ = SF.place_rows(mesh, pos, total, [c.shard[0] + idx])
    return _colfr(Column(store_numeric(idx.double().float(), T_NUM), T_NUM,
                         total), "which")


def _whichextreme_idx(M, is_max: bool, per_row: bool):
    """Arg-extreme ignoring NaN, per row or per column; all-NaN -> NaN."""
    fill = -torch.inf if is_max else torch.inf
    Mv = torch.where(torch.isnan(M), fill, M)
    dim = 1 if per_row else 0
    idx = torch.argmax(Mv, dim) if is_max else torch.argmin(Mv, dim)
    allna = torch.isnan(M).all(dim)
    return torch.where(allna, torch.nan, idx.float())


def _whichextreme_sharded(M, is_max: bool, lo: int, mesh):
    """`_whichextreme_idx` per column over every rank's rows: each
    rank's extreme, its first global index and its all-NaN flag
    all-gathered; the extreme of the extremes, the lowest index on a
    tie."""
    fill = -np.inf if is_max else np.inf
    Mv = torch.where(torch.isnan(M), fill, M)
    F = M.shape[1]
    if len(M):
        v, i = Mv.max(0) if is_max else Mv.min(0)
        part = torch.cat([v.double(), (i + lo).double(),
                          torch.isnan(M).all(0).double()])
    else:
        part = torch.cat([torch.full((F,), fill, dtype=torch.float64),
                          torch.full((F,), -1.0, dtype=torch.float64),
                          torch.ones(F, dtype=torch.float64)])
    got = SF.carry(mesh, part.tolist())
    got = got[got[:, F] >= 0]          # the ranks that hold rows
    out = np.full(F, np.nan)
    for j in range(F):
        v, i, na = got[:, j], got[:, F + j], got[:, 2 * F + j]
        if len(v) and not na.all():
            best = v.max() if is_max else v.min()
            out[j] = i[v == best].min()
    return torch.from_numpy(out.astype(np.float32))


def _whichextreme(fr, na_rm, axis, is_max: bool):
    ax = int(_scalar(axis))
    name = "which.max" if is_max else "which.min"
    mesh = SF.sharded_mesh(fr)
    if ax != 1 and mesh is not None:
        vals = _whichextreme_sharded(_dev_matrix(fr), is_max, fr.shard[0],
                                     mesh)
    else:
        vals = _whichextreme_idx(_dev_matrix(fr), is_max, ax == 1)
    if ax == 1:          # per row: a column on the device
        return _colfr(Column(vals, T_NUM, fr.nrows), name)
    return _colfr(Column.from_numpy(vals.cpu().numpy().astype(np.float64)),
                  name)


@prim("which.max")
def _whichmax(env, fr, na_rm=True, axis=0):
    return _whichextreme(fr, na_rm, axis, True)


@prim("which.min")
def _whichmin(env, fr, na_rm=True, axis=0):
    return _whichextreme(fr, na_rm, axis, False)


# ---------------------------------------------------------------------------
# string suite — operates on enum DOMAINS / host string data (strings never
# reach the device; core/frame.py)
# ---------------------------------------------------------------------------

def _map_strings(fr, fn, name=None):
    """Apply a str->str fn per column: enum columns transform their domain
    (deduplicating like the reference), string columns transform values."""
    out = Frame()
    for n in fr.names:
        c = fr.col(n)
        if c.is_categorical:
            newdom = [fn(v) for v in (c.domain or [])]
            uniq = sorted(set(newdom))
            remap = np.asarray([uniq.index(v) for v in newdom], np.int32)
            codes = np.asarray(c.to_numpy())
            newcodes = np.where(codes >= 0, remap[np.maximum(codes, 0)], -1)
            out.add(n, Column.from_numpy(
                np.asarray([uniq[i] if i >= 0 else None for i in newcodes],
                           object), ctype=T_CAT))
        elif c.is_string:
            vals = np.asarray([None if v is None else fn(str(v))
                               for v in c.host_data[: c.nrows]], object)
            out.add(n, Column._from_strings(vals))
        else:
            out.add(n, c)
    return out


def _map_string_nums(fr, fn, name):
    """str -> float per value; NA for NA. Each rank maps its own rows
    (enum columns through their domain)."""
    out = Frame()
    for n in fr.names:
        c = fr.col(n)
        if c.is_categorical:
            tbl = np.asarray([fn(v) for v in (c.domain or [])] or [np.nan],
                             np.float64)
            codes = c.data.long().cpu().numpy()
            vals = np.where(codes >= 0, tbl[np.maximum(codes, 0)], np.nan)
        elif c.is_string:
            vals = np.asarray([np.nan if v is None else fn(str(v))
                               for v in c.host_data[: c.local_rows]],
                              np.float64)
        else:
            continue
        out.add(n, _num_col(vals, c.nrows))
    if not out.ncols:
        raise ValueError(f"{name}: no string/enum columns")
    return out


@prim("tolower")
def _tolower(env, fr):
    return _map_strings(fr, str.lower)


@prim("toupper")
def _toupper(env, fr):
    return _map_strings(fr, str.upper)


@prim("trim")
def _trim(env, fr):
    return _map_strings(fr, str.strip)


@prim("lstrip")
def _lstrip(env, fr, chars=None):
    cs = _s(chars).strip('"') if chars is not None else None
    return _map_strings(fr, lambda s: s.lstrip(cs))


@prim("rstrip")
def _rstrip(env, fr, chars=None):
    cs = _s(chars).strip('"') if chars is not None else None
    return _map_strings(fr, lambda s: s.rstrip(cs))


@prim("substring")
def _substring(env, fr, start, end=None):
    a = int(_scalar(start))
    b = None if end is None or (isinstance(end, float) and end != end) \
        else int(_scalar(end))
    return _map_strings(fr, lambda s: s[a:b])


@prim("entropy")
def _entropy(env, fr):
    def ent(s):
        if not s:
            return 0.0
        _, cnt = np.unique(list(s), return_counts=True)
        p = cnt / cnt.sum()
        return float(-(p * np.log2(p)).sum())
    return _map_string_nums(fr, ent, "entropy")


@prim("countmatches")
def _countmatches(env, fr, pats):
    pl = ([_s(p).strip('"') for p in pats]
          if isinstance(pats, (list, NumList)) else [_s(pats).strip('"')])
    return _map_string_nums(fr, lambda s: float(sum(s.count(p) for p in pl)),
                            "countmatches")


@prim("num_valid_substrings")
def _num_valid_substrings(env, fr, path):
    with open(_s(path).strip('"')) as fh:
        words = set(w.strip() for w in fh if w.strip())

    def count(s):
        n = 0
        for i in range(len(s)):
            for j in range(i + 1, len(s) + 1):
                if s[i:j] in words:
                    n += 1
        return float(n)
    return _map_string_nums(fr, count, "num_valid_substrings")


@prim("grep")
def _grep(env, fr, regex, ignore_case=0, invert=0, output_logical=0):
    import re as _re

    flags = _re.IGNORECASE if _scalar(ignore_case) else 0
    rx = _re.compile(_s(regex).strip('"'), flags)
    inv = bool(_scalar(invert))
    logical = bool(_scalar(output_logical))
    c = _one_col(fr)
    if c.is_categorical:
        dom_hit = np.asarray([bool(rx.search(v)) for v in (c.domain or [])] or
                             [False])
        codes = np.asarray(c.to_numpy())
        hits = np.where(codes >= 0, dom_hit[np.maximum(codes, 0)], False)
    else:
        hits = np.asarray([v is not None and bool(rx.search(str(v)))
                           for v in c.host_data[: c.nrows]])
    if inv:
        hits = ~hits
    if logical:
        return _colfr(Column.from_numpy(hits.astype(np.float64)), "grep")
    return _colfr(Column.from_numpy(np.nonzero(hits)[0].astype(np.float64)),
                  "grep")


@prim("strsplit")
def _strsplit(env, fr, pattern):
    import re as _re

    rx = _re.compile(_s(pattern).strip('"'))
    c = _one_col(fr)
    if c.is_categorical:
        vals = [None if v is None else str(v) for v in c.values()]
    else:
        vals = [None if v is None else str(v) for v in c.host_data[: c.nrows]]
    parts = [([] if v is None else rx.split(v)) for v in vals]
    width = max((len(p) for p in parts), default=1) or 1
    out = Frame()
    for j in range(width):
        col = np.asarray([p[j] if j < len(p) else None for p in parts], object)
        out.add(f"C{j + 1}", Column.from_numpy(col, ctype=T_CAT))
    return out


@prim("tokenize")
def _tokenize(env, fr, split):
    import re as _re

    rx = _re.compile(_s(split).strip('"'))
    c = _one_col(fr)
    vals = ([None if v is None else str(v) for v in c.values()]
            if c.is_categorical else
            [None if v is None else str(v) for v in c.host_data[: c.nrows]])
    toks: List[Optional[str]] = []
    for v in vals:
        if v is not None:
            toks.extend(t for t in rx.split(v) if t)
        toks.append(None)                     # sentence separator row
    return _colfr(Column._from_strings(np.asarray(toks, object)))


@prim("strDistance")
def _strdistance(env, fr, other, measure, compare_empty=1):
    measure = _s(measure).strip('"').lower()

    def lev(a, b):
        if a is None or b is None:
            return np.nan
        la, lb = len(a), len(b)
        d = np.arange(lb + 1, dtype=np.float64)
        for i in range(1, la + 1):
            prev = d.copy()
            d[0] = i
            for j in range(1, lb + 1):
                d[j] = min(prev[j] + 1, d[j - 1] + 1,
                           prev[j - 1] + (a[i - 1] != b[j - 1]))
        return float(d[lb])

    def jw(a, b):
        if a is None or b is None:
            return np.nan
        if a == b:
            return 1.0
        la, lb = len(a), len(b)
        if not la or not lb:
            return 0.0
        match_dist = max(la, lb) // 2 - 1
        fa = [False] * la
        fb = [False] * lb
        matches = 0
        for i in range(la):
            for j in range(max(0, i - match_dist), min(lb, i + match_dist + 1)):
                if not fb[j] and a[i] == b[j]:
                    fa[i] = fb[j] = True
                    matches += 1
                    break
        if not matches:
            return 0.0
        t = 0
        k = 0
        for i in range(la):
            if fa[i]:
                while not fb[k]:
                    k += 1
                if a[i] != b[k]:
                    t += 1
                k += 1
        t /= 2
        return (matches / la + matches / lb + (matches - t) / matches) / 3

    fn = jw if measure in ("jw", "jaccard_winkler", "jarowinkler") else lev
    a = _one_col(fr)
    b = _one_col(other)
    av = a.values() if a.is_categorical else a.host_data[: a.nrows]
    bv = b.values() if b.is_categorical else b.host_data[: b.nrows]
    vals = np.asarray([fn(None if x is None else str(x),
                          None if y is None else str(y))
                       for x, y in zip(av, bv)], np.float64)
    return _colfr(Column.from_numpy(vals), "strDistance")


# ---------------------------------------------------------------------------
# time suite (ast/prims/time) — columns are epoch milliseconds
# ---------------------------------------------------------------------------

def _as_dt64(col: Column) -> np.ndarray:
    # exact epoch millis live host-side when available (core/frame.py keeps
    # them for time columns — f32 device storage rounds ~1-minute at 2020
    # magnitudes, enough to flip a midnight-boundary year)
    if col.host_data is not None and col.host_data.dtype.kind in "Mi":
        hd = col.host_data[: col.nrows]
        if hd.dtype.kind == "M":
            return hd.astype("datetime64[ms]")
        return hd.astype("int64").astype("datetime64[ms]")
    ms = np.asarray(col.to_numpy(), np.float64)
    out = np.full(len(ms), np.datetime64("NaT", "ms"))
    ok = ~np.isnan(ms)
    out[ok] = ms[ok].astype("int64").astype("datetime64[ms]")
    return out


def _time_field(fr, extract, name):
    out = Frame()
    for n in fr.names:
        c = fr.col(n)
        dt = _as_dt64(c)
        vals = np.full(len(dt), np.nan)
        ok = ~np.isnat(dt)
        vals[ok] = extract(dt[ok])
        out.add(n, Column.from_numpy(vals))
    return out


@prim("year")
def _year(env, fr):
    return _time_field(fr, lambda d: d.astype("datetime64[Y]").astype(int) + 1970,
                       "year")


@prim("month")
def _month(env, fr):
    return _time_field(
        fr, lambda d: d.astype("datetime64[M]").astype(int) % 12 + 1, "month")


@prim("day")
def _day(env, fr):
    return _time_field(
        fr, lambda d: (d.astype("datetime64[D]")
                       - d.astype("datetime64[M]").astype("datetime64[D]")
                       ).astype(int) + 1, "day")


@prim("dayOfWeek")
def _dayofweek(env, fr):
    # reference AstDayOfWeek: 0 = Monday
    return _time_field(
        fr, lambda d: (d.astype("datetime64[D]").astype(int) + 3) % 7,
        "dayOfWeek")


@prim("week")
def _week(env, fr):
    def iso_week(d):
        days = d.astype("datetime64[D]")
        return np.asarray([int(x.astype("datetime64[D]").item()
                               .isocalendar()[1]) for x in days], np.float64)
    return _time_field(fr, iso_week, "week")


@prim("hour")
def _hour(env, fr):
    return _time_field(
        fr, lambda d: (d.astype("int64") // 3_600_000) % 24, "hour")


@prim("minute")
def _minute(env, fr):
    return _time_field(
        fr, lambda d: (d.astype("int64") // 60_000) % 60, "minute")


@prim("second")
def _second(env, fr):
    return _time_field(
        fr, lambda d: (d.astype("int64") // 1000) % 60, "second")


@prim("millis")
def _millis(env, fr):
    return _time_field(fr, lambda d: d.astype("int64") % 1000, "millis")


@prim("mktime")
def _mktime(env, year, month, day, hour, minute, second, msec):
    def vals(v, default=0.0):
        if _is_fr(v):
            return np.asarray(_one_col(v).to_numpy(), np.float64)
        return np.asarray([float(v)])
    parts = [vals(v) for v in (year, month, day, hour, minute, second, msec)]
    n = max(len(p) for p in parts)
    parts = [np.resize(p, n) for p in parts]
    out = np.empty(n, np.float64)
    import datetime as _dt

    for i in range(n):
        y, mo, d, h, mi, s, ms = (parts[j][i] for j in range(7))
        # reference mktime: month and day are 0-based
        t = _dt.datetime(int(y), int(mo) + 1, int(d) + 1, int(h), int(mi),
                         int(s), int(ms) * 1000, tzinfo=_dt.timezone.utc)
        out[i] = t.timestamp() * 1000
    return _colfr(Column.from_numpy(out), "mktime")


@prim("moment")
def _moment(env, *args):
    return _mktime(env, *args)


@prim("as.Date")
def _asdate(env, fr, fmt):
    import datetime as _dt

    fmt = _s(fmt).strip('"')
    pyfmt = (fmt.replace("yyyy", "%Y").replace("yy", "%y")
             .replace("MM", "%m").replace("dd", "%d")
             .replace("HH", "%H").replace("mm", "%M").replace("ss", "%S"))
    c = _one_col(fr)
    vals = (c.values() if c.is_categorical
            else c.host_data[: c.nrows] if c.is_string
            else None)
    if vals is None:
        return _colfr(c)                    # already numeric/time
    out = np.full(len(vals), np.nan)
    for i, v in enumerate(vals):
        if v is None:
            continue
        try:
            t = _dt.datetime.strptime(str(v), pyfmt).replace(
                tzinfo=_dt.timezone.utc)
            out[i] = t.timestamp() * 1000
        except ValueError:
            pass
    col = Column.from_numpy(out)
    col.ctype = T_TIME
    return _colfr(col, "as.Date")


@prim("listTimeZones")
def _list_tz(env):
    import zoneinfo

    zones = sorted(zoneinfo.available_timezones())
    return _colfr(Column._from_strings(np.asarray(zones, object)))


@prim("getTimeZone")
def _get_tz(env):
    return "UTC"


@prim("setTimeZone")
def _set_tz(env, tz):
    return _s(tz).strip('"')


# ---------------------------------------------------------------------------
# timeseries
# ---------------------------------------------------------------------------

@prim("difflag1")
def _difflag1(env, fr):
    from h2o3_tpu_torch.ops import window

    c = _one_col(fr)
    dev = window.difflag1_device(c)
    if dev is None:
        raise TypeError(f"difflag1 of a {c.ctype} column")
    if not (c.is_numeric or c.ctype == T_TIME):
        # enum codes: stored as a numeric column of the host values
        dev = Column(store_numeric(dev.data, T_NUM), T_NUM, c.nrows)
    return _colfr(dev, "difflag1")


# ---------------------------------------------------------------------------
# mungers — the remaining ones
# ---------------------------------------------------------------------------

@prim("any.factor")
def _anyfactor(env, fr):
    return 1.0 if any(fr.col(n).is_categorical for n in fr.names) else 0.0


@prim("is.factor")
def _isfactor(env, fr):
    return [1.0 if fr.col(n).is_categorical else 0.0 for n in fr.names]


@prim("is.numeric")
def _isnumeric(env, fr):
    return [1.0 if fr.col(n).is_numeric else 0.0 for n in fr.names]


@prim("is.character")
def _ischaracter(env, fr):
    return [1.0 if fr.col(n).is_string else 0.0 for n in fr.names]


@prim("columnsByType")
def _columns_by_type(env, fr, coltype):
    ct = _s(coltype).strip('"').lower()
    idx = []
    for i, n in enumerate(fr.names):
        c = fr.col(n)
        hit = (ct == "numeric" and c.is_numeric or
               ct == "categorical" and c.is_categorical or
               ct == "string" and c.is_string or
               ct == "time" and c.ctype == T_TIME or
               ct == "bad" and c.ctype == "bad" or
               ct == "uuid" and c.ctype == "uuid")
        if hit:
            idx.append(float(i))
    return idx


@prim("flatten")
def _flatten(env, fr):
    c = _one_col(fr)
    if c.is_categorical:
        code = int(np.asarray(c.to_numpy())[0])
        return (c.domain[code] if code >= 0 else "NA")
    if c.is_string:
        return str(c.host_data[0])
    return float(np.asarray(c.to_numpy(), np.float64)[0])


@prim("nlevels")
def _nlevels(env, fr):
    return [float(fr.col(n).cardinality) for n in fr.names]


@prim("cut")
def _cut(env, fr, breaks, labels, include_lowest, right, dig_lab):
    """Bin a numeric column into an enum of interval labels (AstCut),
    each rank its own rows; the domain is the labels some row holds."""
    from h2o3_tpu_torch.ops.groupby import enum_of_labels

    c = _one_col(fr)
    x = widen(c.data).double()
    edges = np.asarray([float(b) for b in breaks], np.float64)
    right_ = bool(_scalar(right))
    incl = bool(_scalar(include_lowest))
    dig = int(_scalar(dig_lab))
    if isinstance(labels, (list, NumList)) and len(labels):
        labs = [_s(v).strip('"') for v in labels]
    else:
        def f(v):
            return f"%.{dig}g" % v
        labs = [(f"({f(edges[i])},{f(edges[i+1])}]" if right_
                 else f"[{f(edges[i])},{f(edges[i+1])})")
                for i in range(len(edges) - 1)]
    codes = torch.full(x.shape, -1, dtype=torch.long, device=x.device)
    for i in range(len(edges) - 1):
        lo, hi = float(edges[i]), float(edges[i + 1])
        if right_:
            m = (x > lo) & (x <= hi)
            if i == 0 and incl:
                m |= x == lo
        else:
            m = (x >= lo) & (x < hi)
            if i == len(edges) - 2 and incl:
                m |= x == hi
        codes[m] = i
    return _colfr(enum_of_labels(codes, labs, c.nrows, SF.sharded_mesh(c)),
                  "cut")


def _fill(M: torch.Tensor, forward: bool, maxlen: int, mesh=None,
          span=None) -> torch.Tensor:
    """Forward or backward fill along dim 0 with a run-length cap: the
    last valid row index propagates by a cumulative max. With `mesh`, M
    is a rank's block, rows [lo, hi) of n (`span`): the walk's positions
    are global, and the last valid row before the block (after it, for
    a backward fill) comes from the other ranks, one all-gather of each
    rank's last valid position and value a column."""
    n = M.shape[0]
    Mw = M if forward else torch.flip(M, [0])
    valid = ~torch.isnan(Mw)
    base = 0 if mesh is None else (span[0] if forward
                                   else span[2] - span[1])
    idx = (base + torch.arange(n, device=M.device))[:, None].expand_as(Mw)
    last_valid = torch.cummax(torch.where(valid, idx, -1), 0).values
    take = torch.gather(Mw, 0, (last_valid - base).clamp(0, max(n - 1, 0)))
    if mesh is not None:
        F = M.shape[1]
        mine = (last_valid[-1].tolist() + take[-1].double().tolist() if n
                else [-1.0] * F + [0.0] * F)
        got = SF.carry(mesh, mine)
        got = got[: mesh.rank] if forward else got[mesh.rank + 1:]
        if len(got):
            best = np.argmax(got[:, :F], axis=0)    # the nearest valid row
            cols = np.arange(F)
            cpos = torch.as_tensor(got[best, cols], device=M.device).long()
            cval = torch.as_tensor(got[best, F + cols], device=M.device
                                   ).to(M.dtype)
            none = last_valid < 0
            take = torch.where(none, cval, take)
            last_valid = torch.where(none, cpos, last_valid)
    filled = torch.where(valid, Mw, torch.where(
        (last_valid >= 0) & (idx - last_valid <= maxlen), take, Mw))
    return filled if forward else torch.flip(filled, [0])


@prim("h2o.fillna")
def _fillna(env, fr, method, axis, maxlen):
    method = _s(method).strip('"').lower()
    ax = int(_scalar(axis))
    forward = method in ("forward", "ffill")
    M = _dev_matrix(fr)
    if ax == 1:
        M = _fill(M.T, forward, int(_scalar(maxlen))).T
    else:
        mesh = SF.sharded_mesh(fr)
        M = _fill(M, forward, int(_scalar(maxlen)), mesh,
                  None if mesh is None else (*fr.shard, fr.nrows))
    out = Frame()
    for j, nm in enumerate(fr.names):
        out.add(nm, Column(M[:, j].contiguous(), T_NUM, fr.nrows))
    return out


@prim("filterNACols")
def _filternacols(env, fr, frac):
    f = float(_scalar(frac))
    keep = []
    for i, n in enumerate(fr.names):
        na = float(fr.col(n).rollups.na_count)
        if na / max(fr.nrows, 1) < f:
            keep.append(float(i))
    return keep


@prim("relevel")
def _relevel(env, fr, level):
    c = _one_col(fr)
    lvl = _s(level).strip('"')
    dom = list(c.domain or [])
    if lvl not in dom:
        raise ValueError(f"level {lvl!r} not in domain")
    newdom = [lvl] + [d for d in dom if d != lvl]
    remap = np.asarray([newdom.index(d) for d in dom], np.int32)
    codes = np.asarray(c.to_numpy())
    newcodes = np.where(codes >= 0, remap[np.maximum(codes, 0)], -1)
    vals = np.asarray([newdom[i] if i >= 0 else None for i in newcodes], object)
    return _colfr(Column.from_numpy(vals, ctype=T_CAT), "relevel")


@prim("setDomain")
def _setdomain(env, fr, in_place, domain):
    c = _one_col(fr)
    newdom = ([_s(v).strip('"') for v in domain]
              if isinstance(domain, (list, NumList)) else None)
    col = Column(c.data, T_CAT, c.nrows, domain=newdom)
    return _colfr(col, fr.names[0] if _is_fr(fr) else "C1")


@prim("setLevel")
def _setlevel(env, fr, level):
    c = _one_col(fr)
    lvl = _s(level).strip('"')
    dom = list(c.domain or [])
    if lvl not in dom:
        raise ValueError(f"level {lvl!r} not in domain")
    code = dom.index(lvl)
    vals = np.asarray([lvl] * c.nrows, object)
    return _colfr(Column.from_numpy(vals, ctype=T_CAT), "setLevel")


@prim("dropdup")
def _dropdup(env, fr, cols, keep):
    idx = _idx_list(cols, fr.ncols)
    keep_s = _s(keep).strip('"').lower()
    mesh = SF.sharded_mesh(fr)
    if mesh is not None:
        return _dropdup_sharded(fr, [fr.col(int(i)) for i in idx],
                                keep_s == "first", mesh)
    key_cols = [np.asarray(fr.col(int(i)).to_numpy()) for i in idx]
    seen = {}
    order = range(fr.nrows) if keep_s == "first" else range(fr.nrows - 1, -1, -1)
    for r in order:
        k = tuple(c[r] for c in key_cols)
        if k not in seen:
            seen[k] = r
    rows = np.asarray(sorted(seen.values()), np.int64)
    from h2o3_tpu_torch.ops.filters import take_rows

    return take_rows(fr, rows)


def _dropdup_sharded(fr, key_cols, first: bool, mesh):
    """dropdup across the row mesh, one process's rows: a row with a NaN
    numeric key is never a duplicate (NaN equals nothing) and stays; the
    others are sample-sorted with equal keys on one rank
    (`ops/sort.keyed_sort`; a string key's None is one key, as one
    process's dict holds it), each run keeps its first (or last) row,
    and the kept ids go home to be placed in row order (`keep_rows`)."""
    from h2o3_tpu_torch.ops.filters import keep_rows
    from h2o3_tpu_torch.ops.sort import keyed_sort

    dev = PS.device_of(fr)
    n = fr.local_rows
    nan_row = torch.zeros(n, dtype=torch.bool, device=dev)
    keys = []
    for c in key_cols:
        if c.data is None:
            keys.append(np.asarray(c.host_data[:n], object))
        else:
            k = widen(c.data).double().to(dev)
            nan_row |= torch.isnan(k)
            keys.append(k + 0.0)
    sel = torch.nonzero(~nan_row).squeeze(1)
    sel_np = sel.cpu().numpy()
    b = keyed_sort(mesh, [k[sel_np] if isinstance(k, np.ndarray) else k[sel]
                          for k in keys], PS.row_ids(fr, dev)[sel])
    keep = b.start if first else torch.cat(
        [b.start[1:], torch.ones(min(len(b), 1), dtype=torch.bool,
                                 device=dev)])
    kept = b.gid[keep]
    home = SF.Route(mesh, SF.owner_of(kept, fr.nrows, mesh.size))
    mine = home.send(kept) - fr.shard[0]
    rows = torch.sort(torch.cat([mine.to(dev),
                                 torch.nonzero(nan_row).squeeze(1)])).values
    return keep_rows(fr, rows)


@prim("sumaxis")
def _sumaxis(env, fr, na_rm, axis):
    out = Frame()
    if int(_scalar(axis)) == 1:
        out.add("sum", Column(_row_sum(fr)[0], T_NUM, fr.nrows))
        return out
    for n, v in zip(fr.names, _percol(fr, lambda c: c.rollups.mean *
                                      (c.nrows - c.rollups.na_count))):
        out.add(n, Column.from_numpy(np.asarray([v])))
    return out


@prim("sumNA")
def _sumna(env, fr, na_rm):
    """sum with na_rm=False semantics: NA if any NA present."""
    vals = []
    for n in fr.names:
        c = fr.col(n)
        if not c.is_numeric:
            vals.append(float("nan"))
            continue
        r = c.rollups
        vals.append(float("nan") if r.na_count > 0
                    else r.mean * (c.nrows - r.na_count))
    return vals[0] if len(vals) == 1 else vals


@prim("prod.na", "prod")
def _prod(env, fr, *rest):
    """The product of the non-NA values, multiplied in float64 and
    rounded to float32 (so it overflows as float32 does); on a
    row-sharded frame the ranks' products, all-gathered, multiply in
    rank order."""
    c = _one_col(fr)
    d = widen(c.data).double()
    p = float(torch.prod(torch.where(torch.isnan(d), 1.0, d)))
    mesh = SF.sharded_mesh(c)
    if mesh is not None:
        parts, p = SF.carry(mesh, [p])[:, 0].tolist(), 1.0
        for q in parts:
            p *= q
    with np.errstate(over="ignore"):
        return float(np.float32(p))


@prim("mad")
def _mad(env, fr, const=1.4826, *rest):
    from h2o3_tpu_torch.ops.quantile import quantile_column

    c = _one_col(fr)
    med = quantile_column(c, [0.5])[0]
    # each rank's own rows' deviations, rounded to float32 as
    # `Column.from_numpy` rounds them
    dev = (widen(c.data).double() - med).abs().float()
    dev = Column(store_numeric(dev, T_NUM), T_NUM, c.nrows)
    k = float(_scalar(const)) if not _is_fr(const) else 1.4826
    return k * quantile_column(dev, [0.5])[0]


@prim("topn")
def _topn(env, fr, col_idx, npercent, grab_topn):
    """The top (or bottom) npercent of a column's non-NaN values, with
    their row indices, largest (smallest) first; equal values keep
    their row order (a stable sort). On a row-sharded frame: the sample
    sort by (value, row id), the picked rows placed at their output
    positions and their values fetched (`take_global_rows`)."""
    c = fr.col(int(_scalar(col_idx)))
    name = fr.names[int(_scalar(col_idx))]
    top = int(_scalar(grab_topn)) >= 0
    mesh = SF.sharded_mesh(c)
    if mesh is not None:
        return _topn_sharded(fr.subframe([name]), float(_scalar(npercent)),
                             top, mesh)
    x = np.asarray(c.to_numpy(), np.float64)
    valid = np.nonzero(~np.isnan(x))[0]
    n = max(int(np.ceil(len(valid) * float(_scalar(npercent)) / 100.0)), 1)
    order = valid[np.argsort(x[valid], kind="stable")]
    pick = order[-n:][::-1] if top else order[:n]
    out = Frame()
    out.add("Row Indices", Column.from_numpy(pick.astype(np.float64)))
    out.add(name, Column.from_numpy(x[pick]))
    return out


def _topn_sharded(fr, pct: float, top: bool, mesh):
    from h2o3_tpu_torch.ops.sort import sample_sort_rows

    x = widen(fr.col(0).data).double()
    sel = torch.nonzero(~torch.isnan(x)).squeeze(1)
    V = sum(SF.all_gather_counts(mesh, len(sel)))
    k = min(max(int(np.ceil(V * pct / 100.0)), 1), V)
    got, off = sample_sort_rows(mesh, [x[sel] + 0.0,
                                       (fr.shard[0] + sel).double()])
    pos = off + torch.arange(len(got), device=got.device)
    want = pos >= V - k if top else pos < k
    out_pos = (V - 1 - pos) if top else pos
    (src,), _ = SF.place_rows(mesh, out_pos[want], k,
                              [got[:, 1][want].long()])
    vals = SF.take_global_rows(fr, src, k).col(0)
    out = Frame()
    out.add("Row Indices", Column(store_numeric(src.double().float(), T_NUM),
                                  T_NUM, k))
    out.add(fr.names[0], Column(store_numeric(widen(vals.data).float(),
                                              T_NUM), T_NUM, k))
    return out


@prim("signif")
def _signif(env, fr, digits):
    d = int(_scalar(digits))

    def sig(x):
        with np.errstate(divide="ignore", invalid="ignore"):
            mag = np.where(x == 0, 1.0,
                           10.0 ** (d - 1 - np.floor(np.log10(np.abs(x)))))
        return np.round(x * mag) / mag
    out = Frame()
    for n in fr.names:
        c = fr.col(n)
        if c.is_numeric:
            out.add(n, Column.from_numpy(sig(np.asarray(c.to_numpy(),
                                                        np.float64))))
        else:
            out.add(n, c)
    return out


@prim("any.na")
def _anyna(env, fr):
    return 1.0 if any(fr.col(n).rollups.na_count for n in fr.names) \
        else 0.0


@prim("melt")
def _melt(env, fr, id_vars, value_vars, var_name, value_name, skipna):
    ids = [fr.names[i] for i in _idx_list(id_vars, fr.ncols)]
    if value_vars is None or (isinstance(value_vars, (list, NumList))
                              and not len(value_vars)):
        vals = [n for n in fr.names if n not in ids]
    else:
        vals = [fr.names[i] for i in _idx_list(value_vars, fr.ncols)]
    vn = _s(var_name).strip('"') or "variable"
    valn = _s(value_name).strip('"') or "value"
    skip = bool(_scalar(skipna))
    mesh = SF.sharded_mesh(fr)
    if mesh is not None:
        return PS.melt(fr, ids, vals, vn, valn, skip, mesh)
    id_data = {c: np.asarray(fr.col(c).values(), object) for c in ids}
    xs = [np.asarray(fr.col(v).to_numpy(), np.float64) for v in vals]
    # value variable by value variable, each in row order
    keep = [np.nonzero(~np.isnan(x))[0] if skip else np.arange(len(x))
            for x in xs]
    rows = np.concatenate(keep) if vals else np.zeros(0, np.int64)
    var_col = np.asarray([v for v, k in zip(vals, keep) for _ in k], object)
    val_col = (np.concatenate([x[k] for x, k in zip(xs, keep)]) if vals
               else np.zeros(0))
    id_cols = {c: id_data[c][rows] for c in ids}
    out = Frame()
    for c in ids:
        out.add(c, Column.from_numpy(np.asarray(id_cols[c], object),
                                     ctype=T_CAT if fr.col(c).is_categorical
                                     else None))
    out.add(vn, Column.from_numpy(var_col, ctype=T_CAT))
    out.add(valn, Column.from_numpy(np.asarray(val_col, np.float64)))
    return out


@prim("pivot")
def _pivot(env, fr, index, column, value):
    iname = _s(index).strip('"')
    cname = _s(column).strip('"')
    vname = _s(value).strip('"')
    mesh = SF.sharded_mesh(fr)
    if mesh is not None:
        return PS.pivot(fr, iname, cname, vname, mesh)
    iv = np.asarray(fr.col(iname).values(), object)
    cv = np.asarray(fr.col(cname).values(), object)
    vv = np.asarray(fr.col(vname).to_numpy(), np.float64)
    uidx = sorted(set(iv.tolist()), key=lambda x: (x is None, x))
    ucol = sorted(set(v for v in cv.tolist() if v is not None))
    pos_i = {v: i for i, v in enumerate(uidx)}
    pos_c = {v: i for i, v in enumerate(ucol)}
    M = np.full((len(uidx), len(ucol)), np.nan)
    for i in range(len(iv)):
        if cv[i] is None:
            continue
        M[pos_i[iv[i]], pos_c[cv[i]]] = vv[i]
    out = Frame()
    out.add(iname, Column.from_numpy(
        np.asarray(uidx, object),
        ctype=T_CAT if fr.col(iname).is_categorical else None))
    for j, cn in enumerate(ucol):
        out.add(str(cn), Column.from_numpy(M[:, j]))
    return out


@prim("ddply")
def _ddply(env, fr, group_cols, fun):
    """AstDdply: apply an AST lambda per group; result row per group."""
    from h2o3_tpu_torch.ops.filters import take_rows

    idx = _idx_list(group_cols, fr.ncols)
    mesh = SF.sharded_mesh(fr)
    if mesh is not None:
        return PS.ddply(env, fr, idx, fun, mesh)
    keys = [np.asarray(fr.col(int(i)).to_numpy()) for i in idx]
    combo = {}
    for r in range(fr.nrows):
        combo.setdefault(tuple(k[r] for k in keys), []).append(r)
    rows_out: List[List[float]] = []
    width = 0
    for key, rows in sorted(combo.items(),
                            key=lambda kv: tuple(
                                (x != x, x) if isinstance(x, float) else (False, x)
                                for x in kv[0])):
        sub = take_rows(fr, np.asarray(rows, np.int64))
        res = _eval_lambda(env, fun, [sub])
        if _is_fr(res):
            vals = [float(v) for v in np.asarray(res.to_numpy(),
                                                 np.float64).ravel()]
        elif isinstance(res, (list, tuple)):
            vals = [float(v) for v in res]
        else:
            vals = [float(res)]
        rows_out.append(list(map(float, key)) + vals)
        width = max(width, len(vals))
        sub.delete()
    ncols = len(idx) + width
    M = np.full((len(rows_out), ncols), np.nan)
    for i, row in enumerate(rows_out):
        M[i, : len(row)] = row
    out = Frame()
    for j, i in enumerate(idx):
        out.add(fr.names[int(i)], Column.from_numpy(M[:, j]))
    for j in range(width):
        out.add(f"ddply_C{j + 1}", Column.from_numpy(M[:, len(idx) + j]))
    return out


@prim("apply")
def _apply(env, fr, margin, fun):
    """AstApply: margin 2 = per column, 1 = per row. On a row-sharded
    frame a column's lambda runs on the sharded column (its reductions
    are the sharded prims) and the one-row result is held whole on every
    rank; a row's runs on the rank that holds it."""
    m = int(_scalar(margin))
    mesh = SF.sharded_mesh(fr)
    if m == 2:
        results = [PS.first_value(_eval_lambda(env, fun,
                                               [_colfr(fr.col(n), n)]))
                   for n in fr.names]
        out = Frame()
        for n, v in zip(fr.names, results):
            out.add(n, _num_col(np.asarray([v]), 1,
                                replicate=mesh is not None))
        return out
    if mesh is not None:
        return PS.apply_rows(env, fr, fun)
    # margin 1: per-row — vectorize by evaluating the lambda on the whole
    # frame when possible is unsafe in general; do an explicit row loop
    return _colfr(Column.from_numpy(PS.row_lambdas(env, fun, fr.names,
                                                   _num_matrix(fr))),
                  "apply")


@prim("rank_within_groupby")
def _rank_within_group(env, fr, group_cols, sort_cols, ascending, new_col,
                       sort_orders_for_grouped=0):
    gidx = _idx_list(group_cols, fr.ncols)
    sidx = _idx_list(sort_cols, fr.ncols)
    # one direction flag per sort key (missing ones ascending)
    asc = ([bool(_scalar(a)) for a in ascending]
           if isinstance(ascending, (list, NumList)) else
           [True] * len(sidx))
    asc = (asc + [True] * len(sidx))[: len(sidx)]
    from h2o3_tpu_torch.ops import window

    rank_col = window.rank_within_groupby_device(fr, gidx, sidx, asc)
    mesh = SF.sharded_mesh(fr)
    if rank_col is None and mesh is not None:
        rank_col = window.rank_keyed(fr, gidx, sidx, asc, mesh)
    if rank_col is None:
        # the host walk, for string key columns: a string key sorts and
        # groups as its rank among the column's distinct strings does; in
        # the lexsort's order each row with every sort key present counts
        # on from the last such row unless a group key changed (NaN
        # differs from everything)
        from h2o3_tpu_torch.ops.sort import host_codes

        gkeys = [np.asarray(fr.col(int(i)).to_numpy()) for i in gidx]
        if fr.nrows > 1 and any(k.dtype == object and (k == None).any()
                                for k in gkeys):   # noqa: E711
            # the sort compares None with the strings, as lexsort would
            raise TypeError("'<' not supported between instances of "
                            "'NoneType' and 'str'")
        gkeys = [host_codes(k)[0] if k.dtype == object else k
                 for k in gkeys]
        skeys = [np.asarray(fr.col(int(i)).to_numpy(), np.float64)
                 for i in sidx]
        order_keys = [k if a else -k
                      for k, a in zip(reversed(skeys), reversed(asc))]
        order = np.lexsort(tuple(order_keys) + tuple(reversed(gkeys)))
        valid = np.ones(fr.nrows, bool)
        for k in skeys:
            valid &= ~np.isnan(k)
        ov = order[valid[order]]
        start = np.zeros(len(ov), bool)
        start[:1] = True
        for k in gkeys:
            start[1:] |= k[ov][1:] != k[ov][:-1]
        at = np.arange(len(ov))
        rank = np.full(fr.nrows, np.nan)
        rank[ov] = at - np.maximum.accumulate(np.where(start, at, 0)) + 1
        rank_col = Column.from_numpy(rank)
    out = fr.subframe(fr.names)
    out.add(_s(new_col).strip('"'), rank_col)
    return out


# ---------------------------------------------------------------------------
# round-4 prim-diff closure — the last 13 of the reference's named prims
# (ast/prims audit: every Ast*.java with a str() now has a registration)
# ---------------------------------------------------------------------------

def _host_strings(col: Column) -> np.ndarray:
    """Column → host string array (enum decode / raw strings / numbers)."""
    if col.is_categorical:
        dom = np.asarray(list(col.domain) + [None], object)
        codes = np.asarray(col.to_numpy(), np.int64)
        return dom[np.where(codes < 0, len(dom) - 1, codes)]
    if col.is_string:
        return np.asarray(col.host_data, object)
    return np.asarray(col.to_numpy()).astype(str).astype(object)


def _row_frame(value: float) -> Frame:
    """ValFrame.fromRow analog: 1x1 numeric frame."""
    return _colfr(Column.from_numpy(np.asarray([value], np.float64)))


@prim("none")
def _noop(env, *args):
    """AstNoOp — evaluates to its (last) argument unchanged."""
    return args[-1] if args else 0.0


@prim(",")
def _comma(env, *args):
    """AstComma — sequence: all arguments evaluated, last one returned."""
    return args[-1] if args else 0.0


_PROPERTIES: dict = {}


@prim("setproperty")
def _setproperty(env, prop, value):
    """AstSetProperty — set a runtime property (reference: JVM system
    properties across the cloud; here a process-wide registry)."""
    _PROPERTIES[_s(prop).strip('"')] = _s(value).strip('"')
    return _s(value).strip('"')


@prim("rename")
def _rename(env, old, new):
    """AstRename — move a DKV key."""
    from h2o3_tpu_torch.core.dkv import DKV

    old, new = _s(old).strip('"'), _s(new).strip('"')
    obj = DKV.get(old)
    if obj is None:
        raise ValueError(f"no DKV object {old!r} to rename")
    if hasattr(obj, "_key"):
        from h2o3_tpu_torch.core.dkv import Key

        obj._key = Key(new)
    DKV.put(new, obj)
    DKV.remove(old)
    return 0.0


@prim("model.reset.threshold")
def _reset_threshold(env, model_key, thr):
    """AstModelResetThreshold — swap a binomial model's labeling threshold;
    returns the OLD threshold as a 1x1 frame (ValFrame.fromRow)."""
    from h2o3_tpu_torch.core.dkv import DKV

    m = DKV.get(_s(model_key).strip('"'))
    if m is None:
        raise ValueError(f"model {model_key!r} not found")
    aucd = getattr(getattr(m._output, "training_metrics", None),
                   "auc_data", None)
    if aucd is None:
        raise ValueError("model has no binomial threshold to reset")
    old = float(aucd.max_f1_threshold)
    aucd.max_f1_threshold = float(_scalar(thr))
    return _row_frame(old)


@prim("perfectAUC")
def _perfect_auc(env, probs, acts):
    """AstPerfectAUC — EXACT AUC from raw probabilities (rank statistic,
    tie-aware), not the 400-bin approximation (AUC2.perfectAUC)."""
    p = np.asarray(_one_col(probs).to_numpy(), np.float64)
    y = np.asarray(_one_col(acts).to_numpy(), np.float64)
    ok = ~(np.isnan(p) | np.isnan(y))
    p, y = p[ok], y[ok]
    pos = y > 0
    n1, n0 = int(pos.sum()), int((~pos).sum())
    if n1 == 0 or n0 == 0:
        return _row_frame(float("nan"))
    order = np.argsort(p, kind="mergesort")
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    # midranks for ties
    sp = p[order]
    i = 0
    while i < len(sp):
        j = i
        while j + 1 < len(sp) and sp[j + 1] == sp[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    auc = (ranks[pos].sum() - n1 * (n1 + 1) / 2.0) / (n1 * n0)
    return _row_frame(float(auc))


@prim("segment_models_as_frame")
def _segment_models_as_frame(env, key):
    """AstSegmentModelsAsFrame: a SegmentModels' table as a frame; a
    column of numbers is numeric, any other an enum of its strings."""
    from h2o3_tpu_torch.core.dkv import DKV
    from h2o3_tpu_torch.models.segments import SegmentModels

    sm = DKV.get(_s(key).strip('"'))
    if not isinstance(sm, SegmentModels):
        raise ValueError(f"{key!r} is not a SegmentModels key")
    tbl = sm.as_frame()
    out = Frame()
    for i, h in enumerate(tbl.col_names):
        arr = np.asarray([row[i] for row in tbl.rows], object)
        try:
            out.add(h, Column.from_numpy(arr.astype(np.float64)))
        except (TypeError, ValueError):
            out.add(h, Column.from_numpy(arr.astype(str), ctype=T_CAT))
    return out


@prim("grouped_permute")
def _grouped_permute(env, fr, perm_col, groupby, permute_by, keep_col):
    """AstGroupedPermute — per group, pair the rows whose permuteBy level
    is 'D' against the rest: (group..., In, Out, InAmnt, OutAmnt)."""
    pc = int(_scalar(perm_col))
    kb = int(_scalar(keep_col))
    pb = int(_scalar(permute_by))
    gb = [int(i) for i in _idx_list(groupby, fr.ncols)]
    mesh = SF.sharded_mesh(fr)
    if mesh is not None:
        return PS.grouped_permute(fr, pc, kb, pb, gb, mesh)
    names = [fr.names[i] for i in gb]
    g_np = [np.asarray(fr.col(fr.names[i]).to_numpy()) for i in gb]
    perm = np.asarray(fr.col(fr.names[pc]).to_numpy(), np.float64)
    keep = np.asarray(fr.col(fr.names[kb]).to_numpy(), np.float64)
    pbcol = fr.col(fr.names[pb])
    dom = list(pbcol.domain or [])
    lab = np.asarray(pbcol.to_numpy(), np.int64)
    is_d = np.asarray([dom[v] == "D" if 0 <= v < len(dom) else False
                       for v in lab])
    # compound key over ALL group-by columns
    gkey = np.asarray(list(zip(*[g.astype(str) for g in g_np])), object)
    gkey = np.asarray(["\x1f".join(t) for t in gkey])
    # groups in sorted key order, each group's rows in row order; per
    # group its D rows, each paired with every other row
    order = np.argsort(gkey, kind="stable")
    cut = np.flatnonzero(gkey[order][1:] != gkey[order][:-1]) + 1
    pi, pj = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for grp in np.split(order, cut) if len(order) else []:
        din, dout = grp[is_d[grp]], grp[~is_d[grp]]
        pi.append(np.repeat(din, len(dout)))
        pj.append(np.tile(dout, len(din)))
    i, j = np.concatenate(pi), np.concatenate(pj)
    rows = {"in": perm[i], "out": perm[j], "inamnt": keep[i],
            "outamnt": keep[j]}
    grows = {nm: g_np[gi][i] for gi, nm in enumerate(names)}
    out = Frame()
    pdom = list(fr.col(fr.names[pc]).domain or []) or None
    kdom = list(fr.col(fr.names[kb]).domain or []) or None
    for nm in names:
        cdom = list(fr.col(nm).domain or []) or None
        out.add(nm, Column.from_numpy(
            np.asarray(grows[nm], np.float64),
            ctype="enum" if cdom else None, domain=cdom))
    out.add("In", Column.from_numpy(np.asarray(rows["in"], np.float64),
                                    ctype="enum" if pdom else None,
                                    domain=pdom))
    out.add("Out", Column.from_numpy(np.asarray(rows["out"], np.float64),
                                     ctype="enum" if pdom else None,
                                     domain=pdom))
    out.add("InAmnt", Column.from_numpy(np.asarray(rows["inamnt"],
                                                   np.float64),
                                        ctype="enum" if kdom else None,
                                        domain=kdom))
    out.add("OutAmnt", Column.from_numpy(np.asarray(rows["outamnt"],
                                                    np.float64),
                                         ctype="enum" if kdom else None,
                                         domain=kdom))
    return out


@prim("h2o.mad")
def _mad(env, fr, combine_method="interpolate", constant=1.4826):
    """AstMad — median absolute deviation × constant; NaN when the column
    carries NAs (reference semantics); combine_method resolves even-length
    medians (QuantileModel.CombineMethod). Both medians are exact order
    statistics (`kth_value`) of the float64 values and deviations, across
    the ranks of a row-sharded frame."""
    from h2o3_tpu_torch.ops.quantile import kth_value

    col = _one_col(fr)
    cm = _s(combine_method).strip('"').lower()
    mesh = SF.sharded_mesh(col)
    x = widen(col.data).double()
    nan = torch.tensor([float(torch.isnan(x).any())], dtype=torch.float64)
    if mesh is not None:
        mesh.all_reduce(nan, "max")
    n = col.nrows
    if n == 0 or nan[0] > 0:
        return float("nan")

    def median(v):
        hi = kth_value(v, n // 2, mesh)
        if n % 2 == 1:
            return hi
        lo = kth_value(v, n // 2 - 1, mesh)
        return lo if cm == "low" else hi if cm == "high" else \
            (lo + hi) / 2.0          # interpolate and average coincide
    med = median(x)
    return float(_scalar(constant)) * median((x - med).abs())


def _na_rollup(op):
    def impl(env, fr):
        col = _one_col(fr)
        x = np.asarray(col.to_numpy(), np.float64)
        if np.isnan(x).any():           # AstNaRollupOp: NAs poison the value
            return float("nan")
        return float(op(x))
    return impl


prim("maxNA")(_na_rollup(np.max))
prim("minNA")(_na_rollup(np.min))


def _isax_index(sym: np.ndarray, C: int, nrows: int, mesh=None) -> Column:
    """The iSax_index enum of the symbol rows `sym` (a rank's block with
    `mesh`), as `Column.from_numpy(labels, ctype="enum")` interns the
    labels: each distinct symbol row's label made once, the domain the
    sorted labels some row holds (with `mesh`, of every rank's)."""
    from h2o3_tpu_torch.core.frame import torch_code_dtype

    sym = sym.reshape(len(sym), -1)
    W = sym.shape[1]
    if (C + 1) ** W < 2 ** 62:
        # a row's symbols (each in [0, C]) as one integer
        code = sym.astype(np.int64) @ ((C + 1) ** np.arange(W - 1, -1, -1,
                                                             dtype=np.int64))
        _u, first, inv = np.unique(code, return_index=True,
                                   return_inverse=True)
        uniq = sym[first]
    else:
        uniq, inv = np.unique(sym, axis=0, return_inverse=True)
    labels = ["_".join(f"{int(s)}^{C}" for s in row) for row in uniq]
    dom = sorted(set(labels) if mesh is None else set().union(
        *SF.all_gather_object(mesh, sorted(set(labels)))))
    pos = {v: i for i, v in enumerate(dom)}
    lut = np.asarray([pos[v] for v in labels] or [0], np.int64)
    codes = torch.from_numpy(lut[inv.reshape(-1)])
    from h2o3_tpu_torch.core.frame import _device

    return Column(codes.to(torch_code_dtype(len(dom))).to(_device(None)),
                  T_CAT, nrows, domain=dom)


@prim("isax")
def _isax(env, fr, num_words, max_cardinality, optimize_card=0):
    """AstIsax — iSAX symbolization of row-wise series: z-normalize each
    row, PAA into num_words segments, symbolize against gaussian
    breakpoints. Output: iSax_index string column + c0..c{w-1} symbols
    (AstIsax.java:52 IsaxTask/IsaxStringTask)."""
    from statistics import NormalDist

    W = int(_scalar(num_words))
    C = int(_scalar(max_cardinality))
    if W <= 0 or C <= 0:
        raise ValueError("isax: numWords and maxCardinality must be > 0")
    mesh = SF.sharded_mesh(fr)
    if mesh is not None:
        return PS.isax(fr, W, C, mesh)
    X = _num_matrix(fr)                               # (n, T) series rows
    n, T = X.shape
    mu = np.nanmean(X, axis=1, keepdims=True)
    sd = np.nanstd(X, axis=1, keepdims=True)
    Z = (X - mu) / np.where(sd > 0, sd, 1.0)
    # PAA: mean per word segment
    edges = np.linspace(0, T, W + 1).astype(int)
    paa = np.stack([np.nanmean(Z[:, edges[i]:max(edges[i + 1], edges[i] + 1)],
                               axis=1) for i in range(W)], axis=1)
    nd = NormalDist()
    brk = np.asarray([nd.inv_cdf(q) for q in np.linspace(0, 1, C + 1)[1:-1]])
    sym = np.searchsorted(brk, paa)                   # (n, W) in [0, C)
    out = Frame()
    out.add("iSax_index", _isax_index(sym, C, n))
    for i in range(W):
        out.add(f"c{i}", Column.from_numpy(sym[:, i].astype(np.float64)))
    return out


@prim("tf-idf")
def _tfidf(env, fr, doc_id_idx, text_idx, preprocess=1, case_sensitive=1):
    """AstTfIdf — (doc, word, TF, IDF, TF-IDF) from a corpus frame."""
    di = int(_scalar(doc_id_idx))
    ti = int(_scalar(text_idx))
    pre = bool(int(_scalar(preprocess)))
    cs = bool(int(_scalar(case_sensitive)))
    mesh = SF.sharded_mesh(fr)
    if mesh is not None:
        return PS.tfidf(fr, di, ti, pre, cs, mesh)
    docs = np.asarray(fr.col(fr.names[di]).to_numpy())
    words = _host_strings(fr.col(fr.names[ti]))
    pairs = []
    for d, txt in zip(docs, words):
        if txt is None:
            continue
        toks = str(txt).split() if pre else [str(txt)]
        for tk in toks:
            pairs.append((d, tk if cs else tk.lower()))
    if not pairs:
        raise ValueError("tf-idf: empty corpus")
    darr = np.asarray([p[0] for p in pairs])
    warr = np.asarray([p[1] for p in pairs], object)
    dw, counts = {}, {}
    for d, w_ in zip(darr, warr):
        counts[(d, w_)] = counts.get((d, w_), 0) + 1
    n_docs = len(np.unique(darr))
    docs_with = {}
    for (d, w_) in counts:
        docs_with.setdefault(w_, set()).add(d)
    out_doc, out_word, tf, idf, tfidf = [], [], [], [], []
    for (d, w_), c in sorted(counts.items(), key=lambda kv: (str(kv[0][1]),
                                                             kv[0][0])):
        out_doc.append(float(d))
        out_word.append(w_)
        tf.append(float(c))
        iv = _math.log((n_docs + 1.0) / (len(docs_with[w_]) + 1.0))
        idf.append(iv)
        tfidf.append(c * iv)
    out = Frame()
    out.add("DocID", Column.from_numpy(np.asarray(out_doc)))
    out.add("Word", Column.from_numpy(np.asarray(out_word, object)
                                      .astype(str), ctype="enum"))
    out.add("TF", Column.from_numpy(np.asarray(tf)))
    out.add("IDF", Column.from_numpy(np.asarray(idf)))
    out.add("TF-IDF", Column.from_numpy(np.asarray(tfidf)))
    return out
