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

from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT, T_NUM, T_TIME
from h2o3_tpu_torch.rapids.eval import (NumList, StrLit, _colfr,
                                        _eval_lambda, _idx_list, _is_fr,
                                        _one_col, _percol, _row_sum, _s,
                                        _scalar, prim)


# only the host-shaped prims (transpose, per-row lambda apply, iSAX) copy
# a frame to the host, and only up to this many cells (the reference's
# default cap)
_HOST_MATRIX_MAX_CELLS = 100_000_000


def _num_matrix(fr: Frame) -> np.ndarray:
    cells = fr.nrows * max(len(fr.names), 1)
    if cells > _HOST_MATRIX_MAX_CELLS:
        raise ValueError(
            f"this operation copies the whole frame to the host "
            f"({fr.nrows} rows × {len(fr.names)} cols = {cells} cells > "
            f"cap {_HOST_MATRIX_MAX_CELLS}); subset the frame first")
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


def _corr(X, Y, usemode: str, method: str):
    """Correlation matrix of X's and Y's columns: weighted moments over
    the usable rows (complete.obs drops rows with an NA; everything
    lets NaN propagate); spearman ranks are midranks from sort and
    searchsorted with unusable rows pushed to +inf."""
    if usemode == "complete.obs":
        w = ~(torch.isnan(X).any(dim=1) | torch.isnan(Y).any(dim=1))
    else:
        w = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    wf = w.float()
    n_used = wf.sum()
    nn = torch.clamp_min(n_used, 1.0)

    def ranks(M):
        out = []
        for j in range(M.shape[1]):
            cv = torch.where(w, M[:, j], torch.inf)
            s = torch.sort(cv).values
            lo = torch.searchsorted(s, cv, side="left")
            hi = torch.searchsorted(s, cv, side="right")
            out.append((lo + hi + 1).float() / 2.0)
        return torch.stack(out, dim=1)

    if method == "spearman":
        X, Y = ranks(X), ranks(Y)
    mx = (wf @ torch.where(w[:, None], X, 0.0)) / nn
    my = (wf @ torch.where(w[:, None], Y, 0.0)) / nn
    Xc = torch.where(w[:, None], X - mx[None, :], 0.0)
    Yc = torch.where(w[:, None], Y - my[None, :], 0.0)
    denom = torch.sqrt(torch.outer((Xc ** 2).sum(dim=0),
                                   (Yc ** 2).sum(dim=0)))
    C = (Xc.T @ Yc) / torch.clamp_min(denom, 1e-30)
    return torch.where(n_used > 0, C, torch.nan)


@prim("cor")
def _cor(env, fr, other, use, method="pearson"):
    """Correlation matrix or vector (AstCorrelation). use: everything |
    complete.obs | all.obs; method: pearson | spearman."""
    method = _s(method).strip('"').lower()
    usemode = _s(use).strip('"')
    X = _dev_matrix(fr)
    same = not (_is_fr(other) and other is not fr)
    Y = X if same else _dev_matrix(other)
    C = _corr(X, Y, usemode, method)
    if C.shape == (1, 1):
        return float(C[0, 0])
    C = C.cpu().numpy().astype(np.float64)
    out = Frame()
    for j, n in enumerate((other if _is_fr(other) else fr).names):
        out.add(n, Column.from_numpy(C[:, j]))
    return out


@prim("distance")
def _distance(env, fr, other, measure):
    """Pairwise distances (AstDistance): rows of fr x rows of other; up
    to 64 result columns stay on the device."""
    measure = _s(measure).strip('"').lower()
    A = _dev_matrix(fr)
    B = _dev_matrix(other)
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
            out.add(f"C{j + 1}", Column.from_numpy(Dh[:, j]))
    return out


@prim("hist")
def _hist(env, fr, breaks):
    """AstHist: histogram frame (breaks, counts, mids_true, mids, density)."""
    x = np.asarray(_one_col(fr).to_numpy(), np.float64)
    x = x[~np.isnan(x)]
    if isinstance(breaks, (NumList, list)):
        edges = np.asarray([float(b) for b in breaks])
    else:
        b = _s(breaks).strip('"')
        if b in ("sturges", "Sturges"):
            k = int(np.ceil(np.log2(max(len(x), 2)) + 1))
        elif b in ("rice", "Rice"):
            k = int(np.ceil(2 * len(x) ** (1 / 3)))
        elif b in ("sqrt", "Sqrt"):
            k = int(np.ceil(np.sqrt(len(x))))
        elif b in ("doane", "Doane", "scott", "Scott", "fd", "FD"):
            k = max(len(np.histogram_bin_edges(x, bins=b.lower())) - 1, 1)
        else:
            k = int(float(b))
        edges = np.linspace(x.min(), x.max(), k + 1) if len(x) else np.array([0.0, 1.0])
    counts, edges = np.histogram(x, bins=edges)
    mids = 0.5 * (edges[:-1] + edges[1:])
    widths = np.diff(edges)
    dens = counts / np.maximum(counts.sum() * widths, 1e-300)
    out = Frame()
    out.add("breaks", Column.from_numpy(edges[1:]))
    out.add("counts", Column.from_numpy(counts.astype(np.float64)))
    out.add("mids_true", Column.from_numpy(mids))
    out.add("mids", Column.from_numpy(mids))
    out.add("density", Column.from_numpy(dens))
    return out


def _moment_stat(fr, power: int, na_rm) -> list:
    out = []
    for n in fr.names:
        c = fr.col(n)
        if not c.is_numeric:
            out.append(float("nan"))
            continue
        d = c.data
        valid = ~torch.isnan(d)
        nn = valid.sum()
        mu = torch.where(valid, d, 0.0).sum() / torch.clamp_min(nn, 1)
        dc = torch.where(valid, d - mu, 0.0)
        m2 = (dc ** 2).sum() / torch.clamp_min(nn - 1, 1)
        mk = (dc ** power).sum() / torch.clamp_min(nn, 1)
        out.append(float(mk / torch.clamp_min(m2 ** (power / 2.0),
                                              1e-300)))
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
    c = _one_col(fr)
    codes = np.asarray(c.to_numpy())
    codes = codes[codes >= 0] if c.is_categorical else codes[~np.isnan(codes)]
    if not len(codes):
        return float("nan")
    vals, cnt = np.unique(codes, return_counts=True)
    return float(vals[np.argmax(cnt)])


@prim("kfold_column")
def _kfold(env, fr, nfolds, seed):
    n = fr.nrows
    sd = int(_scalar(seed))
    rng = np.random.default_rng(sd if sd >= 0 else None)
    return _colfr(Column.from_numpy(
        rng.integers(0, int(_scalar(nfolds)), n).astype(np.float64)), "kfold")


@prim("modulo_kfold_column")
def _modulo_kfold(env, fr, nfolds):
    return _colfr(Column.from_numpy(
        (np.arange(fr.nrows) % int(_scalar(nfolds))).astype(np.float64)),
        "kfold")


@prim("stratified_kfold_column")
def _strat_kfold(env, fr, nfolds, seed):
    c = _one_col(fr)
    y = np.asarray(c.to_numpy())
    k = int(_scalar(nfolds))
    sd = int(_scalar(seed))
    rng = np.random.default_rng(sd if sd >= 0 else None)
    assign = rng.integers(0, k, len(y))
    for cls in np.unique(y[~np.isnan(y.astype(np.float64))] if y.dtype.kind == "f"
                         else y[y >= 0]):
        idx = np.nonzero(y == cls)[0]
        rng.shuffle(idx)
        assign[idx] = (np.arange(len(idx)) + rng.integers(k)) % k
    return _colfr(Column.from_numpy(assign.astype(np.float64)), "kfold")


@prim("h2o.random_stratified_split")
def _strat_split(env, fr, test_frac, seed):
    c = _one_col(fr)
    y = np.asarray(c.to_numpy())
    frac = float(_scalar(test_frac))
    sd = int(_scalar(seed))
    rng = np.random.default_rng(sd if sd >= 0 else None)
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
    M = _num_matrix(fr).T
    out = Frame()
    for j in range(M.shape[1]):
        out.add(f"C{j + 1}", Column.from_numpy(M[:, j]))
    return out


@prim("x")
def _mmult(env, a, b):
    """AstMMult: A (n x k) @ B (k x m) on the device; the result columns
    stay there."""
    if a.ncols != b.nrows:
        raise ValueError(f"x: non-conformable ({a.ncols} cols vs "
                         f"{b.nrows} rows)")
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
    c = _one_col(fr)
    x = np.asarray(c.to_numpy(), np.float64)
    idx = np.nonzero(~np.isnan(x) & (x != 0))[0].astype(np.float64)
    return _colfr(Column.from_numpy(idx), "which")


def _whichextreme_idx(M, is_max: bool, per_row: bool):
    """Arg-extreme ignoring NaN, per row or per column; all-NaN -> NaN."""
    fill = -torch.inf if is_max else torch.inf
    Mv = torch.where(torch.isnan(M), fill, M)
    dim = 1 if per_row else 0
    idx = torch.argmax(Mv, dim) if is_max else torch.argmin(Mv, dim)
    allna = torch.isnan(M).all(dim)
    return torch.where(allna, torch.nan, idx.float())


def _whichextreme(fr, na_rm, axis, is_max: bool):
    ax = int(_scalar(axis))
    name = "which.max" if is_max else "which.min"
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
    """str -> float per value; NA for NA."""
    out = Frame()
    for n in fr.names:
        c = fr.col(n)
        if c.is_categorical:
            tbl = np.asarray([fn(v) for v in (c.domain or [])] or [np.nan],
                             np.float64)
            codes = np.asarray(c.to_numpy())
            vals = np.where(codes >= 0, tbl[np.maximum(codes, 0)], np.nan)
        elif c.is_string:
            vals = np.asarray([np.nan if v is None else fn(str(v))
                               for v in c.host_data[: c.nrows]], np.float64)
        else:
            continue
        out.add(n, Column.from_numpy(vals))
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
    dev = (window.difflag1_device(c) if c.is_numeric or c.ctype == T_TIME
           else None)
    if dev is not None:
        return _colfr(dev, "difflag1")
    x = np.asarray(c.to_numpy(), np.float64)    # the host walk
    vals = np.concatenate([[np.nan], x[1:] - x[:-1]])
    return _colfr(Column.from_numpy(vals), "difflag1")


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
    x = np.asarray(_one_col(fr).to_numpy(), np.float64)
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
    codes = np.full(len(x), -1, np.int32)
    for i in range(len(edges) - 1):
        lo, hi = edges[i], edges[i + 1]
        if right_:
            m = (x > lo) & (x <= hi)
            if i == 0 and incl:
                m |= x == lo
        else:
            m = (x >= lo) & (x < hi)
            if i == len(edges) - 2 and incl:
                m |= x == hi
        codes[m] = i
    vals = np.asarray([labs[c] if c >= 0 else None for c in codes], object)
    return _colfr(Column.from_numpy(vals, ctype=T_CAT), "cut")


def _fill(M: torch.Tensor, forward: bool, maxlen: int) -> torch.Tensor:
    """Forward or backward fill along dim 0 with a run-length cap: the
    last valid row index propagates by a cumulative max."""
    n = M.shape[0]
    Mw = M if forward else torch.flip(M, [0])
    valid = ~torch.isnan(Mw)
    idx = torch.arange(n, device=M.device)[:, None].expand_as(Mw)
    last_valid = torch.cummax(torch.where(valid, idx, -1), 0).values
    take = torch.gather(Mw, 0, last_valid.clamp(0, max(n - 1, 0)))
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
        M = _fill(M, forward, int(_scalar(maxlen)))
    out = Frame()
    for j, nm in enumerate(fr.names):
        out.add(nm, Column(M[:, j].contiguous(), T_NUM, fr.nrows))
    return out


@prim("filterNACols")
def _filternacols(env, fr, frac):
    f = float(_scalar(frac))
    keep = []
    for i, n in enumerate(fr.names):
        c = fr.col(n)
        na = float(c.rollups.na_count) if not c.is_string else \
            sum(1 for v in c.host_data[: c.nrows] if v is None)
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
    d = _one_col(fr).data
    return float(torch.prod(torch.where(torch.isnan(d), 1.0, d)))


@prim("mad")
def _mad(env, fr, const=1.4826, *rest):
    from h2o3_tpu_torch.ops.quantile import quantile_column

    c = _one_col(fr)
    med = quantile_column(c, [0.5])[0]
    dev = Column.from_numpy(np.abs(np.asarray(c.to_numpy(), np.float64) - med))
    k = float(_scalar(const)) if not _is_fr(const) else 1.4826
    return k * quantile_column(dev, [0.5])[0]


@prim("topn")
def _topn(env, fr, col_idx, npercent, grab_topn):
    c = fr.col(int(_scalar(col_idx)))
    x = np.asarray(c.to_numpy(), np.float64)
    valid = np.nonzero(~np.isnan(x))[0]
    n = max(int(np.ceil(len(valid) * float(_scalar(npercent)) / 100.0)), 1)
    top = int(_scalar(grab_topn)) >= 0
    order = valid[np.argsort(x[valid])]
    pick = order[-n:][::-1] if top else order[:n]
    out = Frame()
    out.add("Row Indices", Column.from_numpy(pick.astype(np.float64)))
    out.add(fr.names[int(_scalar(col_idx))], Column.from_numpy(x[pick]))
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
    for n in fr.names:
        c = fr.col(n)
        if c.is_string:
            if any(v is None for v in c.host_data[: c.nrows]):
                return 1.0
        elif float(c.rollups.na_count) > 0:
            return 1.0
    return 0.0


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
    n = fr.nrows
    id_data = {c: np.asarray(fr.col(c).values(), object) for c in ids}
    var_col: List = []
    val_col: List[float] = []
    id_cols: dict = {c: [] for c in ids}
    for v in vals:
        x = np.asarray(fr.col(v).to_numpy(), np.float64)
        for i in range(n):
            if skip and np.isnan(x[i]):
                continue
            var_col.append(v)
            val_col.append(x[i])
            for c in ids:
                id_cols[c].append(id_data[c][i])
    out = Frame()
    for c in ids:
        out.add(c, Column.from_numpy(np.asarray(id_cols[c], object),
                                     ctype=T_CAT if fr.col(c).is_categorical
                                     else None))
    out.add(vn, Column.from_numpy(np.asarray(var_col, object), ctype=T_CAT))
    out.add(valn, Column.from_numpy(np.asarray(val_col, np.float64)))
    return out


@prim("pivot")
def _pivot(env, fr, index, column, value):
    iname = _s(index).strip('"')
    cname = _s(column).strip('"')
    vname = _s(value).strip('"')
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
    """AstApply: margin 2 = per column, 1 = per row."""
    m = int(_scalar(margin))
    if m == 2:
        results = []
        for n in fr.names:
            res = _eval_lambda(env, fun, [_colfr(fr.col(n), n)])
            results.append(float(_scalar(res)) if not _is_fr(res)
                           else float(np.asarray(res.to_numpy()).ravel()[0]))
        out = Frame()
        for n, v in zip(fr.names, results):
            out.add(n, Column.from_numpy(np.asarray([v])))
        return out
    # margin 1: per-row — vectorize by evaluating the lambda on the whole
    # frame when possible is unsafe in general; do an explicit row loop
    M = _num_matrix(fr)
    vals = np.empty(M.shape[0])
    row_fr = Frame()
    for j, n in enumerate(fr.names):
        row_fr.add(n, Column.from_numpy(M[0:1, j]))
    for i in range(M.shape[0]):
        rf = Frame()
        for j, n in enumerate(fr.names):
            rf.add(n, Column.from_numpy(M[i: i + 1, j]))
        res = _eval_lambda(env, fun, [rf])
        vals[i] = (float(_scalar(res)) if not _is_fr(res)
                   else float(np.asarray(res.to_numpy()).ravel()[0]))
    return _colfr(Column.from_numpy(vals), "apply")


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
    if rank_col is None:
        # the host walk, for string key columns
        gkeys = [np.asarray(fr.col(int(i)).to_numpy()) for i in gidx]
        skeys = [np.asarray(fr.col(int(i)).to_numpy(), np.float64)
                 for i in sidx]
        order_keys = [k if a else -k
                      for k, a in zip(reversed(skeys), reversed(asc))]
        order = np.lexsort(tuple(order_keys) + tuple(reversed(gkeys)))
        rank = np.full(fr.nrows, np.nan)
        prev_g = None
        r = 0
        for pos in order:
            gk = tuple(k[pos] for k in gkeys)
            if any(np.isnan(np.asarray(skeys)[:, pos])):
                continue
            if gk != prev_g:
                prev_g = gk
                r = 0
            r += 1
            rank[pos] = r
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
    rows = {k: [] for k in ("in", "out", "inamnt", "outamnt")}
    grows = {nm: [] for nm in names}
    for gv in np.unique(gkey):
        sel = gkey == gv
        din = np.where(sel & is_d)[0]
        dout = np.where(sel & ~is_d)[0]
        for i in din:
            for j in dout:
                for gi, nm in enumerate(names):
                    grows[nm].append(g_np[gi][i])
                rows["in"].append(perm[i])
                rows["out"].append(perm[j])
                rows["inamnt"].append(keep[i])
                rows["outamnt"].append(keep[j])
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


def _median_combine(x: np.ndarray, cm: str) -> float:
    """QuantileModel.CombineMethod semantics for the even-length median."""
    xs = np.sort(x)
    n = len(xs)
    if n % 2 == 1:
        return float(xs[n // 2])
    lo, hi = float(xs[n // 2 - 1]), float(xs[n // 2])
    if cm == "low":
        return lo
    if cm == "high":
        return hi
    return (lo + hi) / 2.0          # interpolate / average coincide here


@prim("h2o.mad")
def _mad(env, fr, combine_method="interpolate", constant=1.4826):
    """AstMad — median absolute deviation × constant; NaN when the column
    carries NAs (reference semantics); combine_method resolves even-length
    medians (QuantileModel.CombineMethod)."""
    col = _one_col(fr)
    x = np.asarray(col.to_numpy(), np.float64)
    if np.isnan(x).any() or not len(x):
        return float("nan")
    cm = _s(combine_method).strip('"').lower()
    med = _median_combine(x, cm)
    return float(_scalar(constant)) * _median_combine(np.abs(x - med), cm)


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
    idx_strings = np.asarray(
        ["_".join(f"{int(s)}^{C}" for s in row) for row in sym], object)
    out.add("iSax_index", Column.from_numpy(idx_strings, ctype="enum"))
    for i in range(W):
        out.add(f"c{i}", Column.from_numpy(sym[:, i].astype(np.float64)))
    return out


@prim("tf-idf")
def _tfidf(env, fr, doc_id_idx, text_idx, preprocess=1, case_sensitive=1):
    """AstTfIdf — (doc, word, TF, IDF, TF-IDF) from a corpus frame."""
    di = int(_scalar(doc_id_idx))
    ti = int(_scalar(text_idx))
    docs = np.asarray(fr.col(fr.names[di]).to_numpy())
    words = _host_strings(fr.col(fr.names[ti]))
    pre = bool(int(_scalar(preprocess)))
    cs = bool(int(_scalar(case_sensitive)))
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
