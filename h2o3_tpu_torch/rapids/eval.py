"""Rapids evaluator: Session, Env and the primitive registry
(counterpart of h2o3_tpu/rapids/eval.py; the reference:
water/rapids/Session.java, Env.java, ast/prims/*).

Statements evaluate eagerly: each prim is one or a few PyTorch ops over
the columns' tensors (ops/*), or a host pass where the reference also
works on the host (strings, numeric group keys). The reference also
plans statement fusion and lazy sessions (rapids/fusion.py,
rapids/planner.py); it holds fused and eager evaluation to the same bits,
so a statement here evaluates to what the reference's does either way.
The fusion slice is ROADMAP A11.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch.core.dkv import DKV
from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT, T_NUM
from h2o3_tpu_torch.ops import elementwise as E
from h2o3_tpu_torch.ops import filters as FL
from h2o3_tpu_torch.rapids.parser import (Id, Lambda, NumList, Span, StrLit,
                                          StrList, parse_cached)


class Session:
    """Refcounted temp frames (water/rapids/Session.java). `refcnt`
    counts, per Column.token, the temps that hold the column, so `rm`
    drops a key at once and the bookkeeping shows which columns other
    temps still alias."""

    def __init__(self, session_id: str = "default"):
        self.id = session_id
        self.temps: Dict[str, Frame] = {}
        self.refcnt: Dict[int, int] = {}

    def _track(self, fr: Frame, delta: int):
        for c in fr.columns:
            n = self.refcnt.get(c.token, 0) + delta
            if n <= 0:
                self.refcnt.pop(c.token, None)
            else:
                self.refcnt[c.token] = n

    def assign(self, key: str, fr: Frame) -> Frame:
        out = Frame(key=key)
        for n in fr.names:
            out.add(n, fr.col(n))
        out.install()
        old = self.temps.get(key)
        if old is not None:
            self._track(old, -1)
        self.temps[key] = out
        self._track(out, +1)
        return out

    def column_refs(self, col: Column) -> int:
        return self.refcnt.get(col.token, 0)

    def remove(self, key: str):
        old = self.temps.pop(key, None)
        if old is not None:
            self._track(old, -1)
        DKV.remove(key)

    def end(self):
        for k in list(self.temps):
            self.remove(k)


class Env:
    """Lexical scopes for lambda application (water/rapids/Env.java)."""

    def __init__(self, session: Session, parent: Optional["Env"] = None):
        self.session = session
        self.parent = parent
        self.vars: Dict[str, Any] = {}

    def lookup(self, name: str):
        if name == "_":          # h2o-py's placeholder argument
            return None
        e: Optional[Env] = self
        while e is not None:
            if name in e.vars:
                return e.vars[name]
            e = e.parent
        got = DKV.get(name)
        if got is not None:
            return got
        raise KeyError(f"unknown identifier {name!r}")


# ---------------------------------------------------------------------------
# value helpers
# ---------------------------------------------------------------------------

def _is_fr(v) -> bool:
    return isinstance(v, Frame)


def _one_col(v) -> Column:
    if isinstance(v, Column):
        return v
    if _is_fr(v):
        if v.ncols != 1:
            raise ValueError("expected a single-column frame")
        return v.col(0)
    raise TypeError(f"expected column, got {type(v)}")


def _colfr(col: Column, name: str = "C1") -> Frame:
    fr = Frame()
    fr.add(name, col)
    return fr


def _scalar(v) -> float:
    if isinstance(v, (int, float)):
        return float(v)
    if _is_fr(v) and v.ncols == 1 and v.nrows == 1:
        return float(v.col(0).to_numpy()[0])
    raise TypeError(f"expected scalar, got {type(v)}")


def _idx_list(v, n: int) -> np.ndarray:
    """NumList/Span/scalar -> absolute indices; all-negative indices
    drop those (R style)."""
    if isinstance(v, (int, float)):
        return np.asarray([int(v)])
    out: List[int] = []
    for item in v:
        if isinstance(item, Span):
            lo = int(item.lo)
            out.extend(range(lo, lo + int(item.cnt)))
        else:
            out.append(int(item))
    idx = np.asarray(out, np.int64)
    if len(idx) and (idx < 0).all():
        return np.setdiff1d(np.arange(n), -idx)
    return idx


def _s(v) -> str:
    return v.s if isinstance(v, StrLit) else str(v)


# ---------------------------------------------------------------------------
# primitive registry
# ---------------------------------------------------------------------------

PRIMS: Dict[str, Callable] = {}


def prim(*names):
    def deco(fn):
        for nm in names:
            PRIMS[nm] = fn
        return fn
    return deco


# -- assignment / session (ast/prims/assign) --------------------------------

@prim("tmp=", "assign")
def _assign(env, key, val):
    key = key.name if isinstance(key, Id) else str(key)
    fr = val if _is_fr(val) else _colfr(_one_col(val))
    return env.session.assign(key, fr)


@prim("rm")
def _rm(env, key):
    env.session.remove(key if isinstance(key, str) else key.name)
    return 0.0


# -- structure (ast/prims/mungers) ------------------------------------------

@prim("cols", "cols_py")
def _cols(env, fr, sel):
    if isinstance(sel, str):
        return fr.subframe([sel])
    if isinstance(sel, list) and sel and isinstance(sel[0], str):
        return fr.subframe(list(sel))
    return fr.subframe([fr.names[i] for i in _idx_list(sel, fr.ncols)])


@prim("rows")
def _rows(env, fr, sel):
    if _is_fr(sel):
        return FL.filter_rows(fr, _one_col(sel))
    idx = _idx_list(sel, fr.nrows)
    if len(idx) and np.array_equal(idx, np.arange(idx[0], idx[-1] + 1)):
        return FL.slice_rows(fr, int(idx[0]), int(idx[-1]) + 1)
    return FL.take_rows(fr, idx)


@prim("cbind")
def _cbind(env, *frames):
    out = frames[0] if _is_fr(frames[0]) else _colfr(_one_col(frames[0]))
    for f in frames[1:]:
        out = out.cbind(f if _is_fr(f) else _colfr(_one_col(f)))
    return out


@prim("rbind")
def _rbind(env, *frames):
    return FL.rbind(list(frames))


@prim("colnames=")
def _colnames(env, fr, cols, names):
    idx = _idx_list(cols, fr.ncols)
    new = [names] if isinstance(names, str) else [_s(s) for s in names]
    out = fr.subframe(fr.names)
    for i, nm in zip(idx, new):
        out.rename(out.names[int(i)], nm)
    return out


@prim("sort")
def _sort(env, fr, by, *asc):
    from h2o3_tpu_torch.ops.sort import sort_frame

    def names_of(sel):
        if isinstance(sel, str):
            return [sel]
        if isinstance(sel, StrLit):
            return [sel.s]
        if isinstance(sel, (int, float)):
            return [fr.names[int(sel)]]
        items = list(sel)
        if items and isinstance(items[0], (str, StrLit)):
            return [_s(s) for s in items]
        return [fr.names[i] for i in _idx_list(sel, fr.ncols)]

    names = names_of(by)
    if asc:
        # h2o-py sends 1 (ascending) or -1 (descending); 0 is descending
        ascending = [int(_scalar(a)) > 0 for a in
                     (asc[0] if isinstance(asc[0], (list, NumList))
                      else [asc[0]])]
    else:
        ascending = True
    return sort_frame(fr, names, ascending=ascending)


@prim("merge")
def _merge(env, left, right, all_x, all_y, by_x, by_y, method="auto"):
    from h2o3_tpu_torch.ops.merge import merge

    return merge(left, right, all_x=bool(all_x), all_y=bool(all_y))


@prim("unique")
def _unique(env, fr, include_nas=False):
    from h2o3_tpu_torch.ops.groupby import GroupBy

    return GroupBy(fr, fr.names).count().get_frame().subframe(fr.names)


@prim("table")
def _table(env, fr, *rest):
    from h2o3_tpu_torch.ops.groupby import table

    return table(fr)


@prim("h2o.impute")
def _impute(env, fr, column, method, combine_method, by, *rest):
    from h2o3_tpu_torch.ops.impute import impute

    col = (int(_scalar(column)) if not isinstance(column, (list, NumList))
           else -1)
    return impute(fr, column=col, method=_s(method).lower())


@prim("na.omit")
def _na_omit(env, fr):
    mask = None
    for c in fr.columns:
        m = E.is_na(c)
        mask = m if mask is None else E.binop("+", mask, m)
    return FL.filter_rows(fr, E.binop("==", mask, 0.0))


@prim("is.na")
def _isna_prim(env, v):
    return _colfr(E.is_na(_one_col(v)), "isNA")


@prim("ifelse")
def _ifelse_prim(env, cond, yes, no):
    y = _one_col(yes) if _is_fr(yes) else yes
    n = _one_col(no) if _is_fr(no) else no
    return _colfr(E.ifelse(_one_col(cond), y, n))


@prim("h2o.runif")
def _runif(env, fr, seed):
    rng = np.random.default_rng(int(seed) if seed == seed and seed >= 0
                                else None)
    return _colfr(Column.from_numpy(rng.random(fr.nrows)), "rnd")


@prim("asfactor", "as.factor")
def _asfactor(env, fr):
    out = Frame()
    for n in (fr.names if _is_fr(fr) else ["C1"]):
        c = fr.col(n)
        if c.is_categorical:
            out.add(n, c)
            continue
        vals = c.to_numpy()
        out.add(n, Column.from_numpy(
            np.asarray([("" if v != v else ("%g" % v)) for v in vals],
                       object), ctype=T_CAT))
    return out


@prim("as.numeric", "asnumeric")
def _asnumeric(env, fr):
    out = Frame()
    for n in fr.names:
        c = fr.col(n)
        if c.is_categorical:
            # levels that read as numbers convert by value, else by code
            codes = c.to_numpy()
            try:
                lut = np.asarray([float(x) for x in c.domain or []],
                                 np.float32)
                vals = np.where(codes >= 0, lut[np.maximum(codes, 0)],
                                np.nan)
            except ValueError:
                vals = np.where(codes >= 0, codes, np.nan)
            out.add(n, Column.from_numpy(vals.astype(np.float64)))
        else:
            out.add(n, c)
    return out


@prim("as.character", "ascharacter")
def _ascharacter(env, fr):
    out = Frame()
    for n in fr.names:
        out.add(n, Column.from_numpy(np.asarray(
            [None if v is None else str(v) for v in fr.col(n).values()],
            object)))
    return out


@prim("levels")
def _levels(env, fr):
    """One column per input column holding its levels, padded with ''
    to one length (AstLevels)."""
    doms = [list(fr.col(n).domain or []) for n in fr.names]
    depth = max((len(d) for d in doms), default=0) or 1
    out = Frame()
    for n, d in zip(fr.names, doms):
        out.add(n, Column.from_numpy(np.asarray(
            d + [""] * (depth - len(d)), object)))
    return out


@prim("append")
def _append(env, fr, col, name):
    out = fr.subframe(fr.names)
    out.add(_s(name), _one_col(col))
    return out


@prim(":=")
def _colassign(env, fr, rhs, col_idx, row_sel):
    """Column update as a copy-on-write new frame."""
    out = fr.subframe(fr.names)
    idx = _idx_list(col_idx, fr.ncols)
    rhs_cols = (rhs.columns if _is_fr(rhs) else
                [rhs] if isinstance(rhs, Column) else None)
    for k, ci in enumerate(idx):
        nm = fr.names[int(ci)] if int(ci) < fr.ncols else f"C{int(ci) + 1}"
        if rhs_cols is not None:
            newc = rhs_cols[k if len(rhs_cols) > 1 else 0]
        else:
            newc = Column.from_numpy(np.full(fr.nrows, float(rhs),
                                             np.float64))
        if nm in out:
            out.replace(nm, newc)
        else:
            out.add(nm, newc)
    return out


# -- group by ----------------------------------------------------------------

@prim("GB")
def _gb(env, fr, by, *aggs):
    """(GB fr [by...] agg col na agg col na ...)."""
    from h2o3_tpu_torch.ops.groupby import GroupBy

    gb = GroupBy(fr, [fr.names[i] for i in _idx_list(by, fr.ncols)])
    for i in range(0, len(aggs) - 2, 3):
        agg = aggs[i] if isinstance(aggs[i], str) else (
            aggs[i].name if isinstance(aggs[i], Id) else str(aggs[i]))
        col = aggs[i + 1]
        if agg == "nrow":
            gb.count()
            continue
        cname = col if isinstance(col, str) else fr.names[int(_scalar(col))]
        getattr(gb, agg)(cname)
    return gb.get_frame()


# -- reducers (ast/prims/reducers) ------------------------------------------

def _percol(fr, stat) -> List[float]:
    """Per-column reduction; non-numeric columns give NaN."""
    out = []
    for n in fr.names:
        c = fr.col(n)
        out.append(float(stat(c)) if c.is_numeric or c.ctype == "time"
                   else float("nan"))
    return out


def _row_sum(fr):
    """Per-row (sum of the non-NA numeric values, their count)."""
    num = [fr.col(n) for n in fr.names if fr.col(n).is_numeric]
    if not num:
        raise ValueError("no numeric columns for a row-wise reduction")
    stack = torch.stack([c.data for c in num], dim=1)
    mask = ~torch.isnan(stack)
    return torch.where(mask, stack, 0.0).sum(dim=1), mask.sum(dim=1)


@prim("mean")
def _mean(env, v, *rest):
    """(mean fr) -> scalar (one column); (mean fr skipna axis) -> a
    1-row frame of column means, or with axis 1 a column of row means."""
    if _is_fr(v) and rest:
        axis = int(_scalar(rest[1])) if len(rest) > 1 else 0
        out = Frame()
        if axis == 1:
            s, cnt = _row_sum(v)
            vals = torch.where(cnt > 0, s / cnt.clamp_min(1), torch.nan)
            out.add("mean", Column(vals, T_NUM, v.nrows))
            return out
        for n, m in zip(v.names, _percol(v, lambda c: c.rollups.mean)):
            out.add(n, Column.from_numpy(np.asarray([m])))
        return out
    return _one_col(v).rollups.mean


@prim("ls")
def _ls(env):
    """The DKV's frame and model keys as a 1-column frame (AstLs)."""
    from h2o3_tpu_torch.models.model import Model

    keys = [k for k in DKV.keys()
            if isinstance(DKV.get(k), (Frame, Model))]
    out = Frame()
    out.add("key", Column.from_numpy(np.asarray(keys or [""], object)))
    return out


@prim("getrow")
def _getrow(env, fr):
    """A 1-row frame -> its values as a list."""
    if not _is_fr(fr) or fr.nrows != 1:
        raise ValueError("getrow expects a single-row frame")
    return [float("nan") if fr.col(n).is_string
            else float(fr.col(n).to_numpy()[0]) for n in fr.names]


def _total(c: Column) -> float:
    r = c.rollups
    return r.mean * (c.nrows - r.na_count)


@prim("sum")
def _sum(env, v, *rest):
    if _is_fr(v) and v.ncols > 1:
        return _percol(v, _total)
    return _total(_one_col(v))


@prim("min")
def _min(env, v, *rest):
    if _is_fr(v) and v.ncols > 1:
        return float(np.nanmin(_percol(v, lambda c: c.rollups.min)))
    return _one_col(v).rollups.min


@prim("max")
def _max(env, v, *rest):
    if _is_fr(v) and v.ncols > 1:
        return float(np.nanmax(_percol(v, lambda c: c.rollups.max)))
    return _one_col(v).rollups.max


@prim("sd")
def _sd(env, v, *rest):
    if _is_fr(v) and v.ncols > 1:
        return _percol(v, lambda c: c.rollups.sigma)
    return _one_col(v).rollups.sigma


@prim("var")
def _var(env, v, *rest):
    if _is_fr(v) and v.ncols > 1:
        return _percol(v, lambda c: c.rollups.sigma ** 2)
    s = _one_col(v).rollups.sigma
    return s * s


@prim("naCnt", "nacnt")
def _nacnt(env, v):
    if _is_fr(v) and v.ncols > 1:
        return [float(v.col(n).rollups.na_count) for n in v.names]
    return float(_one_col(v).rollups.na_count)


@prim("median")
def _median(env, v, *rest):
    from h2o3_tpu_torch.ops.quantile import quantile_column

    if _is_fr(v) and v.ncols > 1:
        return [quantile_column(v.col(n), [0.5])[0] if v.col(n).is_numeric
                else float("nan") for n in v.names]
    return quantile_column(_one_col(v), [0.5])[0]


@prim("quantile")
def _quantile(env, fr, probs, *rest):
    from h2o3_tpu_torch.ops.quantile import quantile_column

    pl = [float(x) for x in (probs if isinstance(probs, (list, NumList))
                             else [probs])]
    out = Frame()
    out.add("Probs", Column.from_numpy(np.asarray(pl)))
    for n in fr.names:
        c = fr.col(n)
        if c.is_numeric:
            out.add(f"{n}QuantilesQ", Column.from_numpy(
                np.asarray(quantile_column(c, pl))))
    return out


@prim("all")
def _all(env, v):
    r = _one_col(v).rollups
    return 1.0 if r.min == 1.0 and r.max == 1.0 else 0.0


@prim("any")
def _any(env, v):
    return 1.0 if _one_col(v).rollups.max == 1.0 else 0.0


@prim("nrow")
def _nrow(env, fr):
    return float(fr.nrows)


@prim("ncol")
def _ncol(env, fr):
    return float(fr.ncols)


# -- cumulative --------------------------------------------------------------

def cumulative(op: str, d: torch.Tensor) -> torch.Tensor:
    """Running sum/product/min/max with NA read as the identity (0, 1,
    +inf, -inf), as the reference reads it."""
    x = torch.where(torch.isnan(d), {"add": 0.0, "mul": 1.0,
                                     "min": torch.inf,
                                     "max": -torch.inf}[op], d)
    if op == "add":
        return torch.cumsum(x, 0, dtype=torch.float32)
    if op == "mul":
        return torch.cumprod(x, 0, dtype=torch.float32)
    m = (torch.cummin if op == "min" else torch.cummax)(x, 0).values
    # the reference orders -0 below +0: a zero running max is +0 once a
    # +0 was seen, a zero running min -0 once a -0 was seen
    z = x == 0
    seen = torch.cumsum(z & (torch.signbit(x) == (op == "min")), 0) > 0
    signed = torch.where(seen, 0.0, -0.0) if op == "max" else \
        torch.where(seen, -0.0, 0.0)
    return torch.where(m == 0, signed, m)


def _cumprim(op):
    def impl(env, v, axis=0):
        c = _one_col(v)
        return _colfr(Column.from_device(cumulative(op, c.data), T_NUM,
                                         c.nrows))
    return impl


PRIMS["cumsum"] = _cumprim("add")
PRIMS["cumprod"] = _cumprim("mul")
PRIMS["cummin"] = _cumprim("min")
PRIMS["cummax"] = _cumprim("max")


# -- string ops (host side; the device never holds strings) ------------------

def _strop(fn):
    def impl(env, fr, *args):
        out = Frame()
        for n in fr.names:
            c = fr.col(n)
            if c.is_categorical:
                dom = [fn(x, *args) for x in (c.domain or [])]
                out.add(n, Column(c.data, T_CAT, c.nrows, domain=dom))
            elif c.is_string:
                out.add(n, Column.from_numpy(np.asarray(
                    [None if v is None else fn(v, *args)
                     for v in c.host_data], object)))
            else:
                out.add(n, c)
        return out
    return impl


def _replace(env, fr, pat, rep, ignore_case, count):
    import re

    flags = re.IGNORECASE if ignore_case else 0
    p, r = _s(pat), _s(rep)
    return _strop(lambda s: re.sub(p, r, s, count=count, flags=flags))(env,
                                                                       fr)


@prim("replacefirst")
def _replacefirst(env, fr, pat, rep, ignore_case=0.0):
    return _replace(env, fr, pat, rep, ignore_case, 1)


@prim("replaceall")
def _replaceall(env, fr, pat, rep, ignore_case=0.0):
    return _replace(env, fr, pat, rep, ignore_case, 0)


@prim("strlen", "nchar")
def _strlen(env, fr):
    out = Frame()
    for n in fr.names:
        c = fr.col(n)
        if c.is_string:
            vals = np.asarray([np.nan if v is None else len(v)
                               for v in c.host_data])
        elif c.is_categorical:
            lut = np.asarray([len(x) for x in (c.domain or [])] or [0],
                             np.float64)
            codes = c.to_numpy()
            vals = np.where(codes >= 0, lut[np.maximum(codes, 0)], np.nan)
        else:
            vals = np.full(c.nrows, np.nan)
        out.add(n, Column.from_numpy(vals))
    return out


# -- arithmetic / comparison / logic ----------------------------------------

def _str_cmp(col: Column, s: str, op: str) -> Column:
    """(col == 'label') / (col != 'label'): enum columns compare codes
    with the label's, strings compare on the host, numeric columns
    compare with the number the string reads as; NA stays NA."""
    if col.is_categorical:
        dom = col.domain or []
        idx = dom.index(s) if s in dom else -2
        codes = col.to_numpy()
        eq = (codes == idx).astype(np.float64)
        if op == "!=":
            eq = 1.0 - eq
        eq[codes < 0] = np.nan
        return Column.from_numpy(eq)
    if col.is_string:
        return Column.from_numpy(np.array(
            [np.nan if v is None else float((v == s) if op == "=="
                                            else (v != s))
             for v in col.host_data], np.float64))
    vals = col.to_numpy()
    try:
        eq = (vals == float(s)).astype(np.float64)
    except ValueError:
        eq = np.zeros(len(vals), np.float64)
    if op == "!=":
        eq = 1.0 - eq
    eq[~np.isfinite(vals)] = np.nan
    return Column.from_numpy(eq)


def _binprim(op):
    def impl(env, l, r):
        sl = l.s if isinstance(l, StrLit) else (l if isinstance(l, str)
                                                else None)
        sr = r.s if isinstance(r, StrLit) else (r if isinstance(r, str)
                                                else None)
        if op in ("==", "!=") and (sl is not None) != (sr is not None):
            col = _one_col(r if sl is not None else l)
            return _colfr(_str_cmp(col, sl if sl is not None else sr, op),
                          op)
        lv = _one_col(l) if _is_fr(l) else l
        rv = _one_col(r) if _is_fr(r) else r
        if isinstance(lv, Column) or isinstance(rv, Column):
            return _colfr(E.binop(op, lv, rv), op)
        return float(E.binop(op, Column.from_numpy(np.asarray([float(lv)])),
                             float(rv)).to_numpy()[0])
    return impl


for _op in ("+", "-", "*", "/", "^", "%", "intDiv", "==", "!=", "<", "<=",
            ">", ">="):
    PRIMS[_op] = _binprim(_op)
PRIMS["%%"] = _binprim("%")
PRIMS["%/%"] = _binprim("intDiv")


def _logical(op):
    def impl(env, l, r):
        lc = _one_col(l) if _is_fr(l) else l
        rc = _one_col(r) if _is_fr(r) else r
        return _colfr(E.logical(op, lc, rc), op)
    return impl


PRIMS["&"] = PRIMS["&&"] = _logical("&")
PRIMS["|"] = PRIMS["||"] = _logical("|")


def _unprim(op):
    def impl(env, v):
        return _colfr(E.unop(op, _one_col(v)), op)
    return impl


for _op in E._UNOPS:
    PRIMS[_op] = _unprim(_op)


@prim("scale")
def _scale(env, fr, center, scale):
    out = Frame()
    for n in fr.names:
        c = fr.col(n)
        if not c.is_numeric:
            out.add(n, c)
            continue
        r = c.rollups
        mu = r.mean if (center == 1.0 or center is True) else 0.0
        sd = r.sigma if (scale == 1.0 or scale is True) else 1.0
        out.add(n, E.binop("/", E.binop("-", c, mu), sd if sd else 1.0))
    return out


# -- frame split -------------------------------------------------------------

@prim("h2o.splitframe")
def _splitframe(env, fr, ratios, seed=-1.0):
    rl = [float(x) for x in (ratios if isinstance(ratios, (list, NumList))
                             else [ratios])]
    parts = FL.split_frame(fr, rl, seed=int(seed) if seed >= 0 else None)
    for i, pr in enumerate(parts):
        env.session.assign(f"{fr.key}_split_{i}", pr)
    return parts[0]


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _eval(ast, env: Env):
    if isinstance(ast, (int, float)):
        return float(ast)
    if isinstance(ast, StrLit):
        return ast.s
    if isinstance(ast, (NumList, StrList, Lambda)):
        return ast
    if isinstance(ast, Id):
        return env.lookup(ast.name)
    if isinstance(ast, list):
        if not ast:
            return None
        head = ast[0]
        if isinstance(head, Id):
            name = head.name
            if name in ("tmp=", "assign"):
                return PRIMS[name](env, ast[1], _eval(ast[2], env))
            if name == "rm":
                k = ast[1]
                return PRIMS["rm"](env, k.name if isinstance(k, Id)
                                   else _eval(k, env))
            fn = PRIMS.get(name)
            if fn is None:
                raise ValueError(f"unknown rapids primitive {name!r}")
            return fn(env, *[_eval(a, env) for a in ast[1:]])
        if isinstance(head, Lambda):
            return _eval_lambda(env, head, [_eval(a, env) for a in ast[1:]])
        res = None          # a bare list of expressions: the last one's
        for e in ast:
            res = _eval(e, env)
        return res
    raise TypeError(f"cannot evaluate {ast!r}")


def _eval_lambda(env: Env, lam, args):
    """Apply an AST lambda (AstFunction) to evaluated arguments; the
    arity must match."""
    if not isinstance(lam, Lambda):
        raise TypeError(f"expected lambda, got {type(lam)}")
    if len(args) != len(lam.args):
        raise ValueError(f"lambda expects {len(lam.args)} argument(s) "
                         f"({' '.join(lam.args)}), got {len(args)}")
    sub = Env(env.session, parent=env)
    for nm, v in zip(lam.args, args):
        sub.vars[nm] = v
    return _eval(lam.body, sub)


def exec_rapids(expr: str, session: Optional[Session] = None):
    """Parse and evaluate one Rapids statement (water/rapids/Rapids.exec).
    A bare string literal names a DKV key."""
    env = Env(session or Session())
    ast = parse_cached(expr)
    if isinstance(ast, StrLit):
        return env.lookup(ast.s)
    return _eval(ast, env)


# the extended suites register on import (advmath, time, string, search,
# mungers, matrix, repeaters, timeseries)
from h2o3_tpu_torch.rapids import prims_ext as _prims_ext  # noqa: E402,F401
