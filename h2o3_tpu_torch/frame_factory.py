"""H2OFrame, the user-facing frame with h2o-py's operator surface
(counterpart of h2o3_tpu/frame_factory.py).

Client and server are one process, so operators evaluate eagerly into
new columns through the ops layer; every H2OFrame lives in the DKV under
its key. `create_frame` is hex/CreateFrame.java's synthetic generator.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT, T_NUM
from h2o3_tpu_torch.ops import elementwise as ew
from h2o3_tpu_torch.ops import filters as flt


class H2OFrame(Frame):
    """A Frame with h2o-py's surface (h2o-py/h2o/frame.py)."""

    @staticmethod
    def _wrap(fr: Frame) -> "H2OFrame":
        out = H2OFrame.__new__(H2OFrame)
        out.__dict__.update(fr.__dict__)
        out.install()
        return out

    def __init__(self, python_obj=None,
                 destination_frame: Optional[str] = None,
                 column_names: Optional[Sequence[str]] = None,
                 column_types: Optional[Dict[str, str]] = None,
                 device=None):
        super().__init__(key=destination_frame)
        types = column_types or {}
        if python_obj is None:
            pass
        elif isinstance(python_obj, dict):
            for name, vals in python_obj.items():
                self.add(str(name), Column.from_numpy(
                    np.asarray(vals), ctype=types.get(name), device=device))
        elif isinstance(python_obj, (list, tuple, np.ndarray)):
            arr = np.asarray(python_obj)
            if arr.ndim == 1:
                arr = arr[:, None]
            names = (list(column_names) if column_names
                     else [f"C{i + 1}" for i in range(arr.shape[1])])
            for i, name in enumerate(names):
                self.add(name, Column.from_numpy(
                    arr[:, i], ctype=types.get(name), device=device))
        elif hasattr(python_obj, "columns") and hasattr(python_obj, "dtypes"):
            # a pandas DataFrame, read through its own methods
            for n, c in Frame.from_pandas(python_obj, column_types=types,
                                          device=device)._cols.items():
                self.add(n, c)
        else:
            raise TypeError(f"cannot build H2OFrame from {type(python_obj)}")
        self.install()

    @property
    def frame_id(self) -> str:
        return str(self.key)

    # -- selection --------------------------------------------------------
    def __getitem__(self, sel):
        if isinstance(sel, (str, int)):
            return H2OFrame._wrap(self.subframe([sel]))
        if isinstance(sel, (list, np.ndarray)) and len(sel) and \
                isinstance(sel[0], (str, int, np.integer)):
            return H2OFrame._wrap(self.subframe(list(sel)))
        if isinstance(sel, slice):
            return H2OFrame._wrap(flt.slice_rows(
                self, sel.start or 0,
                sel.stop if sel.stop is not None else self.nrows))
        if isinstance(sel, Frame):
            return H2OFrame._wrap(flt.filter_rows(self, sel.col(0)))
        if isinstance(sel, tuple) and len(sel) == 2:
            rows, cols = sel
            fr = self
            if isinstance(cols, (str, int)):
                fr = fr.subframe([cols])
            elif isinstance(cols, (list, np.ndarray)):
                fr = fr.subframe(list(cols))
            elif isinstance(cols, slice):
                fr = fr.subframe(fr.names[cols])
            if isinstance(rows, Frame):
                return H2OFrame._wrap(flt.filter_rows(fr, rows.col(0)))
            if isinstance(rows, slice):
                return H2OFrame._wrap(flt.slice_rows(
                    fr, rows.start or 0,
                    rows.stop if rows.stop is not None else fr.nrows))
            if isinstance(rows, (list, np.ndarray)):
                return H2OFrame._wrap(flt.take_rows(fr, np.asarray(rows)))
            if rows is None:
                return H2OFrame._wrap(fr) if fr is not self else self
            raise TypeError(f"bad row selector {rows!r}")
        raise TypeError(f"bad selector {sel!r}")

    def __setitem__(self, name, value):
        if isinstance(value, Frame):
            col = value.col(0)
        elif isinstance(value, Column):
            col = value
        elif np.isscalar(value):
            col = Column.from_numpy(np.full(self.nrows, value))
        else:
            col = Column.from_numpy(np.asarray(value))
        self.replace(name, col)

    # -- operators --------------------------------------------------------
    def _bin(self, op, other, rev=False):
        a = self.col(0)
        b = other.col(0) if isinstance(other, Frame) else other
        left, right = (b, a) if rev else (a, b)
        return H2OFrame._wrap(Frame({self.names[0]:
                                     ew.binop(op, left, right)}))

    def __add__(self, o):
        return self._bin("+", o)

    def __radd__(self, o):
        return self._bin("+", o, rev=True)

    def __sub__(self, o):
        return self._bin("-", o)

    def __rsub__(self, o):
        return self._bin("-", o, rev=True)

    def __mul__(self, o):
        return self._bin("*", o)

    def __rmul__(self, o):
        return self._bin("*", o, rev=True)

    def __truediv__(self, o):
        return self._bin("/", o)

    def __rtruediv__(self, o):
        return self._bin("/", o, rev=True)

    def __pow__(self, o):
        return self._bin("^", o)

    def __mod__(self, o):
        return self._bin("%", o)

    def __eq__(self, o):  # noqa: elementwise, as in h2o-py
        return self._bin("==", o)

    def __ne__(self, o):
        return self._bin("!=", o)

    def __lt__(self, o):
        return self._bin("<", o)

    def __le__(self, o):
        return self._bin("<=", o)

    def __gt__(self, o):
        return self._bin(">", o)

    def __ge__(self, o):
        return self._bin(">=", o)

    def __hash__(self):
        return hash(self._key)

    def __and__(self, o):
        return self._bin("*", o)       # and of 0/1 columns is the product

    def __or__(self, o):
        return self._bin("+", o)._bin(">", 0)

    def __invert__(self):
        return self._un("not")

    def __len__(self):
        return self.nrows

    # -- math methods -----------------------------------------------------
    def _un(self, op):
        return H2OFrame._wrap(Frame({self.names[0]:
                                     ew.unop(op, self.col(0))}))

    def abs(self):
        return self._un("abs")

    def exp(self):
        return self._un("exp")

    def log(self):
        return self._un("log")

    def log10(self):
        return self._un("log10")

    def log1p(self):
        return self._un("log1p")

    def sqrt(self):
        return self._un("sqrt")

    def floor(self):
        return self._un("floor")

    def ceil(self):
        return self._un("ceiling")

    def sign(self):
        return self._un("sign")

    def tanh(self):
        return self._un("tanh")

    def isna(self):
        return H2OFrame._wrap(Frame({self.names[0]: ew.is_na(self.col(0))}))

    def ifelse(self, yes, no):
        y = yes.col(0) if isinstance(yes, Frame) else yes
        n = no.col(0) if isinstance(no, Frame) else no
        return H2OFrame._wrap(Frame({"ifelse":
                                     ew.ifelse(self.col(0), y, n)}))

    # -- reductions -------------------------------------------------------
    def _per_col(self, stat):
        vals = [stat(self.col(n)) for n in self.names]
        return vals if len(vals) > 1 else vals[0]

    def mean(self, na_rm=True, axis=0, return_frame=False):
        return self._per_col(lambda c: c.mean())

    def sum(self, na_rm=True):
        return self._per_col(lambda c: c.rollups.mean * c.rollups.rows)

    def min(self):
        return min(self.col(n).min() for n in self.names)

    def max(self):
        return max(self.col(n).max() for n in self.names)

    def sd(self):
        return self._per_col(lambda c: c.sigma())

    def nacnt(self):
        return [self.col(n).na_count() for n in self.names]

    def median(self):
        from h2o3_tpu_torch.ops.quantile import quantile_column

        return self._per_col(lambda c: quantile_column(c, [0.5])[0])

    def quantile(self, prob=None):
        from h2o3_tpu_torch.ops.quantile import quantile_frame

        prob = prob or [0.01, 0.1, 0.25, 0.333, 0.5, 0.667, 0.75, 0.9, 0.99]
        out = H2OFrame({"Probs": np.asarray(prob)})
        for n, v in quantile_frame(self, prob).items():
            out.add(n + "Quantiles", Column.from_numpy(np.asarray(v)))
        return out

    # -- type munging -----------------------------------------------------
    def asfactor(self):
        from h2o3_tpu_torch.ops.groupby import factor_column

        fr = Frame()
        for n in self.names:
            c = self.col(n)
            if c.is_categorical:
                fr.add(n, c)
                continue
            fr.add(n, factor_column(c, lambda v: str(int(v))))
        return H2OFrame._wrap(fr)

    def asnumeric(self):
        fr = Frame()
        for n in self.names:
            c = self.col(n)
            fr.add(n, Column.from_device(ew._as_f32(c), T_NUM, c.nrows)
                   if c.data is not None else
                   Column.from_numpy(c.host_data.astype(np.float32)))
        return H2OFrame._wrap(fr)

    def levels(self):
        return [self.col(n).domain or [] for n in self.names]

    def nlevels(self):
        return [self.col(n).cardinality for n in self.names]

    def set_names(self, names: List[str]):
        if len(names) != self.ncols:
            raise ValueError(f"{len(names)} names for {self.ncols} columns")
        for old, new in zip(list(self._names), names):
            if old != new:
                self.rename(old, new)
        return self

    def set_name(self, col, name):
        self.rename(self._names[col] if isinstance(col, int) else col, name)
        return self

    # -- shape ops --------------------------------------------------------
    def cbind(self, other):
        return H2OFrame._wrap(super().cbind(other))

    def rbind(self, other):
        return H2OFrame._wrap(flt.rbind([self, other]))

    def split_frame(self, ratios=None, destination_frames=None, seed=None):
        parts = flt.split_frame(self, ratios if ratios is not None
                                else [0.75], seed=seed,
                                destination_frames=destination_frames)
        return [H2OFrame._wrap(p) for p in parts]

    def head(self, rows=10):
        return H2OFrame._wrap(flt.slice_rows(self, 0, min(rows, self.nrows)))

    def tail(self, rows=10):
        return H2OFrame._wrap(flt.slice_rows(
            self, max(0, self.nrows - rows), self.nrows))

    def drop(self, cols):
        if isinstance(cols, (str, int)):
            cols = [cols]
        names = [self._names[c] if isinstance(c, int) else c for c in cols]
        return H2OFrame._wrap(self.subframe(
            [n for n in self.names if n not in names]))

    def describe(self):
        return self.summary()

    def structure(self):
        return self.summary()

    def as_data_frame(self, use_pandas=True):
        return self.to_pandas()

    def group_by(self, by):
        from h2o3_tpu_torch.ops.groupby import GroupBy

        return GroupBy(self, by)

    def impute(self, column=-1, method="mean"):
        from h2o3_tpu_torch.ops.impute import impute

        return impute(self, column, method)

    def table(self, dense=True):
        from h2o3_tpu_torch.ops.groupby import table

        return H2OFrame._wrap(table(self))

    def unique(self):
        from h2o3_tpu_torch.ops.groupby import level_counts

        lev, cnt = level_counts(self.col(0))
        return H2OFrame({self.names[0]: lev[cnt > 0]})

    def runif(self, seed=None):
        return H2OFrame({"rnd":
                         np.random.default_rng(seed).random(self.nrows)})

    def merge(self, other, all_x=False, all_y=False, by_x=None, by_y=None,
              method="auto"):
        from h2o3_tpu_torch.ops.merge import merge

        return H2OFrame._wrap(merge(self, other, all_x=all_x, all_y=all_y,
                                    by_x=by_x, by_y=by_y))

    def sort(self, by, ascending=True):
        from h2o3_tpu_torch.ops.sort import sort_frame

        return H2OFrame._wrap(sort_frame(self, by, ascending))

    def __repr__(self):
        return f"<H2OFrame {self._key} {self.nrows}x{self.ncols}>"


def create_frame(rows=100, cols=4, key=None, randomize=True,
                 real_fraction=None, categorical_fraction=None,
                 integer_fraction=None, binary_fraction=0.0, factors=5,
                 real_range=100, integer_range=100, missing_fraction=0.0,
                 seed=None, has_response=False, response_factors=2,
                 **kw) -> H2OFrame:
    """Synthetic frame generator (hex/CreateFrame.java), numpy's
    default_rng draws in the reference's order."""
    rng = np.random.default_rng(seed)
    rf = real_fraction if real_fraction is not None else 0.5
    cf = categorical_fraction if categorical_fraction is not None else 0.25
    if integer_fraction is None:
        integer_fraction = max(0.0, 1.0 - rf - cf - binary_fraction)
    fracs = np.array([rf, cf, integer_fraction, binary_fraction], np.float64)
    raw = fracs / max(fracs.sum(), 1e-12) * cols
    counts = np.floor(raw).astype(int)
    # largest remainder first, so no requested type is starved by flooring
    rem = raw - counts
    while counts.sum() < cols:
        i = int(np.argmax(rem))
        counts[i] += 1
        rem[i] = -1.0
    fr = H2OFrame(destination_frame=key)
    ci = 0
    for _ in range(counts[0]):
        v = rng.uniform(-real_range, real_range, rows)
        _add_missing(v, missing_fraction, rng)
        fr.add(f"C{ci + 1}", Column.from_numpy(v))
        ci += 1
    for _ in range(counts[1]):
        codes = rng.integers(0, factors, rows)
        labels = np.asarray([f"c{ci}.l{k}" for k in codes], dtype=object)
        if missing_fraction:
            labels[rng.random(rows) < missing_fraction] = None
        fr.add(f"C{ci + 1}", Column.from_numpy(labels, ctype=T_CAT))
        ci += 1
    for _ in range(counts[2]):
        v = rng.integers(-integer_range, integer_range, rows).astype(
            np.float64)
        _add_missing(v, missing_fraction, rng)
        fr.add(f"C{ci + 1}", Column.from_numpy(v))
        ci += 1
    for _ in range(counts[3]):
        v = rng.integers(0, 2, rows).astype(np.float64)
        _add_missing(v, missing_fraction, rng)
        fr.add(f"C{ci + 1}", Column.from_numpy(v))
        ci += 1
    if has_response:
        if response_factors and response_factors > 1:
            codes = rng.integers(0, response_factors, rows)
            fr.add("response", Column.from_numpy(
                np.asarray([f"r{k}" for k in codes], dtype=object),
                ctype=T_CAT))
        else:
            fr.add("response", Column.from_numpy(rng.normal(size=rows)))
    return fr


def _add_missing(v, frac, rng):
    if frac:
        v[rng.random(len(v)) < frac] = np.nan
