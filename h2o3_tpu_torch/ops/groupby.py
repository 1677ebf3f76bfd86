"""Group-by aggregation (counterpart of h2o3_tpu/ops/groupby.py).

The by-columns flatten into one int64 code per row (-1 where any part is
NA): enum columns by their codes on the device, numeric columns
factorised on the host with np.unique, as the reference does. Groups come
out in flat-code order, only those with rows. Counts are exact; min and
max are scatter reductions (order-free); sums and sums of squares use
the order-free int64 fixed-point sum (core/ops.fixed_point_group_sums),
so the card, the CPU and a rerun agree bit for bit. The reference adds
float32 partials per shard and then across its 8 shards, so sums, means,
sd and var agree with it to float32 rounding (ROADMAP C2); means, sd and
var are finished in float32 on the host as the reference finishes them.

On a row-sharded cloud the global levels of a numeric by-column are the
union of every rank's unique values (all-gathered), counts and the
fixed-point sums are all-reduced (`fixed_point_group_sums` with the
mesh: the same bits for any split of the rows), min and max are
all-reduced too, and the output frame is built from the host results
as in one process, so it lands in `mesh.row_block`s and equals one
process's bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT, widen
from h2o3_tpu_torch.core.ops import fixed_point_group_sums
from h2o3_tpu_torch.core.sharded_frame import sharded_mesh


def _codes_and_levels(frame: Frame, by: Sequence[str]
                      ) -> Tuple[torch.Tensor, List[np.ndarray], int]:
    sizes = []
    code_arrays = []
    levels = []
    dev = frame.col(by[0]).device
    mesh = sharded_mesh(frame)
    for name in by:
        c = frame.col(name)
        if c.is_categorical:
            code_arrays.append(c.data.long())
            sizes.append(max(c.cardinality, 1))
            levels.append(np.asarray(c.domain, dtype=object))
        else:
            vals = widen(c.data).cpu().numpy()
            ok = ~np.isnan(vals)
            uniq, codes = np.unique(vals[ok], return_inverse=True)
            if mesh is not None:
                # the cloud's levels: every rank's unique values
                every = mesh.all_gather(torch.from_numpy(uniq)).numpy()
                uniq = np.unique(every)
                codes = np.searchsorted(uniq, vals[ok])
            full = np.full(len(vals), -1, np.int64)
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


def group_aggregates(codes: torch.Tensor, x: torch.Tensor, ngroups: int,
                     mesh=None):
    """Per group of `codes` (-1 = no group): (count of valid x, sum, sum
    of squares, min, max) of the float32 values x, on x's device. NA rows
    land in an extra slot that is dropped. A bfloat16 x is widened
    exactly first: the reference's program squares it in float32 too
    (XLA drops the bfloat16 round trip of x * x before the float32
    scatter-add). With `mesh`, every aggregate is the cloud's."""
    x = widen(x)
    valid = (codes >= 0) & ~torch.isnan(x)
    seg = torch.where(valid, codes, ngroups)
    xv = torch.where(valid, x, 0.0)
    cnt = torch.bincount(seg, minlength=ngroups + 1)
    sums = fixed_point_group_sums(seg, torch.stack([xv, xv * xv], 1),
                                  ngroups + 1, mesh).float()
    s, ss = sums[:, 0], sums[:, 1]
    x0 = x + 0.0                                    # one zero for min/max
    mn = torch.full((ngroups + 1,), torch.inf, device=x.device).scatter_reduce(
        0, seg, torch.where(valid, x0, torch.inf), "amin")
    mx = torch.full((ngroups + 1,), -torch.inf,
                    device=x.device).scatter_reduce(
        0, seg, torch.where(valid, x0, -torch.inf), "amax")
    if mesh is not None:
        mesh.all_reduce(cnt, "sum")
        mesh.all_reduce(mn, "min")
        mesh.all_reduce(mx, "max")
    return tuple(a[:ngroups] for a in (cnt, s, ss, mn, mx))


def group_counts(codes: torch.Tensor, ngroups: int, mesh=None
                 ) -> torch.Tensor:
    seg = torch.where(codes >= 0, codes, ngroups)
    cnt = torch.bincount(seg, minlength=ngroups + 1)
    if mesh is not None:
        mesh.all_reduce(cnt, "sum")
    return cnt[:ngroups]


def level_counts(col: Column) -> Tuple[np.ndarray, np.ndarray]:
    """(levels, counts) of a column over every row, on every rank: an
    enum column's domain codes with their counts, a numeric column's
    distinct non-NA values (float32, sorted; `np.unique`'s) with theirs.
    The group-by's own levels and counts (`_codes_and_levels`,
    `group_counts`): on a row-sharded cloud the distinct values are
    all-gathered and the counts all-reduced, no row moves."""
    fr = Frame()
    fr.add("c", col)
    codes, levels, ngroups = _codes_and_levels(fr, ["c"])
    cnt = group_counts(codes, ngroups, sharded_mesh(fr)).cpu().numpy()
    lev = (np.arange(ngroups) if col.is_categorical
           else np.asarray(levels[0], np.float32))
    return lev, cnt[: len(lev)]


def enum_of_labels(idx: torch.Tensor, labels: Sequence[str], nrows: int,
                   mesh=None) -> Column:
    """An enum column whose rows hold `labels[idx]` (idx -1: NA), as
    `Column.from_numpy` interns the labels of every row: the domain is
    the sorted set of the labels some row holds ("" reads as NA), the
    codes of the narrowest dtype. With `mesh` (idx a rank's block of a
    row-sharded column) which labels are held is all-reduced."""
    from h2o3_tpu_torch.core.frame import torch_code_dtype

    idx = idx.long()
    held = torch.bincount(idx[idx >= 0], minlength=len(labels))
    if mesh is not None:
        mesh.all_reduce(held, "sum")
    held = held.cpu().numpy()
    dom = sorted({lb for lb, h in zip(labels, held) if h and lb != ""})
    pos = {lb: i for i, lb in enumerate(dom)}
    lut = torch.tensor([pos.get(lb, -1) for lb in labels] or [-1],
                       dtype=torch.long, device=idx.device)
    codes = torch.where(idx >= 0, lut[idx.clamp_min(0)], -1)
    return Column(codes.to(torch_code_dtype(len(dom))), T_CAT, nrows,
                  domain=dom)


def factor_column(col: Column, label) -> Column:
    """A numeric column as an enum column whose labels are `label(v)` of
    its values (NA stays NA), as `Column.from_numpy` interns the labels
    of every row (`enum_of_labels`). The labels are made from the
    column's distinct values, told apart by their float32 bits (-0 is
    not +0), which each rank finds among its own rows and the ranks
    all-gather; each rank then maps its own rows."""
    if col.data is None:
        raise TypeError(f"cannot make a factor of a {col.ctype} column")
    v = widen(col.data).float()
    ok = ~torch.isnan(v)
    bits = v.view(torch.int32)
    uniq = torch.unique(bits[ok])
    mesh = sharded_mesh(col)
    if mesh is not None:
        uniq = torch.unique(mesh.all_gather(uniq))
    labels = [label(float(x)) for x in uniq.cpu().numpy().view(np.float32)]
    at = torch.searchsorted(uniq, bits).clamp(max=max(len(labels) - 1, 0))
    return enum_of_labels(torch.where(ok, at, -1), labels, col.nrows, mesh)


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
        mesh = sharded_mesh(self._frame)
        cnt_all = group_counts(codes, ngroups, mesh).cpu().numpy()
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
                                  group_aggregates(codes, x, ngroups, mesh))
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
