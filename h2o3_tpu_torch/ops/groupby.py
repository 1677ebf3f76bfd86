"""Group-by aggregation (counterpart of h2o3_tpu/ops/groupby.py).

The by-columns flatten into one int64 code per row (-1 where any part is
NA): enum columns by their codes on the device, numeric columns
factorised on the host with np.unique, as the reference does. Groups come
out in flat-code order, only those with rows. Counts are exact; min and
max are scatter reductions (order-free); sums and sums of squares use
the order-free int64 fixed-point sum (core/ops.fixed_point_segment_sum),
so the card, the CPU and a rerun agree bit for bit. The reference adds
float32 partials per shard and then across its 8 shards, so sums, means,
sd and var agree with it to float32 rounding (ROADMAP C2); means, sd and
var are finished in float32 on the host as the reference finishes them.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT
from h2o3_tpu_torch.core.ops import fixed_point_segment_sum


def _codes_and_levels(frame: Frame, by: Sequence[str]
                      ) -> Tuple[torch.Tensor, List[np.ndarray], int]:
    sizes = []
    code_arrays = []
    levels = []
    dev = frame.col(by[0]).device
    for name in by:
        c = frame.col(name)
        if c.is_categorical:
            code_arrays.append(c.data.long())
            sizes.append(max(c.cardinality, 1))
            levels.append(np.asarray(c.domain, dtype=object))
        else:
            vals = c.to_numpy()
            ok = ~np.isnan(vals)
            uniq, codes = np.unique(vals[ok], return_inverse=True)
            full = np.full(c.nrows, -1, np.int64)
            full[ok] = codes
            code_arrays.append(torch.from_numpy(full).to(dev))
            sizes.append(max(len(uniq), 1))
            levels.append(uniq)
    flat = torch.zeros_like(code_arrays[0])
    any_na = torch.zeros_like(code_arrays[0], dtype=torch.bool)
    for arr, size in zip(code_arrays, sizes):
        arr = arr.to(dev)
        any_na = any_na | (arr < 0)
        flat = flat * size + arr.clamp_min(0)
    return torch.where(any_na, -1, flat), levels, int(np.prod(sizes))


def group_aggregates(codes: torch.Tensor, x: torch.Tensor, ngroups: int):
    """Per group of `codes` (-1 = no group): (count of valid x, sum, sum
    of squares, min, max) of the float32 values x, on x's device. NA rows
    land in an extra slot that is dropped."""
    valid = (codes >= 0) & ~torch.isnan(x)
    seg = torch.where(valid, codes, ngroups)
    xv = torch.where(valid, x, 0.0)
    cnt = torch.bincount(seg, minlength=ngroups + 1)
    s = fixed_point_segment_sum(seg, xv, ngroups + 1)
    ss = fixed_point_segment_sum(seg, xv * xv, ngroups + 1)
    x0 = x + 0.0                                    # one zero for min/max
    mn = torch.full((ngroups + 1,), torch.inf, device=x.device).scatter_reduce(
        0, seg, torch.where(valid, x0, torch.inf), "amin")
    mx = torch.full((ngroups + 1,), -torch.inf,
                    device=x.device).scatter_reduce(
        0, seg, torch.where(valid, x0, -torch.inf), "amax")
    return tuple(a[:ngroups] for a in (cnt, s, ss, mn, mx))


def group_counts(codes: torch.Tensor, ngroups: int) -> torch.Tensor:
    seg = torch.where(codes >= 0, codes, ngroups)
    return torch.bincount(seg, minlength=ngroups + 1)[:ngroups]


class GroupBy:
    """The h2o-py GroupBy surface: chained aggregates, then
    get_frame(). `na` is accepted and, as in the reference, NA values are
    left out of every aggregate but the row count."""

    def __init__(self, frame: Frame, by: Union[str, Sequence[str]]):
        self._frame = frame
        self._by = ([by] if isinstance(by, str) else
                    [frame.names[b] if isinstance(b, int) else b
                     for b in by])
        self._aggs: List[Tuple[str, str]] = []

    def _add(self, op: str, col) -> "GroupBy":
        cols = ([c for c in self._frame.names if c not in self._by]
                if col is None or col == [] else
                ([col] if isinstance(col, str) else list(col)))
        for c in cols:
            if self._frame.col(c).is_numeric:
                self._aggs.append((op, c))
        return self

    def count(self, na="all"):
        self._aggs.append(("count", self._by[0]))
        return self

    def sum(self, col=None, na="all"):
        return self._add("sum", col)

    def mean(self, col=None, na="all"):
        return self._add("mean", col)

    def min(self, col=None, na="all"):
        return self._add("min", col)

    def max(self, col=None, na="all"):
        return self._add("max", col)

    def sd(self, col=None, na="all"):
        return self._add("sd", col)

    def var(self, col=None, na="all"):
        return self._add("var", col)

    def get_frame(self):
        from h2o3_tpu_torch.frame_factory import H2OFrame

        codes, levels, ngroups = _codes_and_levels(self._frame, self._by)
        dev = codes.device
        cnt_all = group_counts(codes, ngroups).cpu().numpy()
        present = np.nonzero(cnt_all > 0)[0]
        out = Frame()
        sizes = [len(lv) for lv in levels]
        rem = present.copy()
        decoded = []
        for size in reversed(sizes):
            decoded.append(rem % size)
            rem = rem // size
        for name, lev, codes_i in zip(self._by, levels, reversed(decoded)):
            c = self._frame.col(name)
            vals = np.asarray(lev[codes_i],
                              dtype=object if lev.dtype == object else None)
            out.add(name, Column.from_numpy(
                vals, ctype=T_CAT if c.is_categorical else None, device=dev))
        done = set()
        for op, cname in self._aggs:
            key = f"{op}_{cname}"
            if key in done:
                continue
            done.add(key)
            if op == "count":
                out.add("nrow", Column.from_numpy(
                    cnt_all[present].astype(np.float32), device=dev))
                continue
            x = self._frame.col(cname).data
            cnt, s, ss, mn, mx = (a.cpu().numpy() for a in
                                  group_aggregates(codes, x, ngroups))
            cnt_g = cnt[present].astype(np.float32)
            s_g = s[present]
            with np.errstate(invalid="ignore", divide="ignore"):
                if op == "sum":
                    v = s_g
                elif op == "mean":
                    v = s_g / cnt_g
                elif op == "min":
                    v = mn[present]
                elif op == "max":
                    v = mx[present]
                elif op in ("sd", "var"):
                    m = s_g / cnt_g
                    var = (np.maximum(ss[present] / cnt_g - m * m, 0.0)
                           * cnt_g / np.maximum(cnt_g - 1, 1))
                    v = np.sqrt(var) if op == "sd" else var
                else:
                    raise ValueError(op)
            out.add(key, Column.from_numpy(v, device=dev))
        return H2OFrame._wrap(out)


def table(frame: Frame) -> Frame:
    """(table fr): counts of the value combinations of the first one or
    two columns (AstTable)."""
    return GroupBy(frame, frame.names[: min(2, frame.ncols)]).count() \
        .get_frame()
