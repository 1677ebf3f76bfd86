"""Per-column rollup statistics (counterpart of h2o3_tpu/ops/rollups.py
`Rollups` :22, `_rollup_fn` :33, `compute_rollups` :55).

One masked pass over the column on its device: the count of valid
values, their float32 sum and sum of squares, min, max and the count of
nonzero values. Mean and sigma are finished in float64 on the host from
the float32 sums, as the reference finishes them; only the order of the
float32 adds differs, so mean and sigma agree with the reference to
about 1e-6 relative, and min, max, na and nz counts are exact.

On a row-sharded cloud each rank makes these partials over its rows and
the row mesh reduces them (counts and sums added in float64, min and
max as such), so every rank holds the cloud's rollups: the reference's
psum over its row shards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch


@dataclass(frozen=True)
class Rollups:
    min: float
    max: float
    mean: float
    sigma: float
    na_count: int
    nz_count: int
    rows: int  # valid (non-NA) rows


def compute_rollups(col) -> Rollups:
    from h2o3_tpu_torch.core.sharded_frame import mesh_of

    if col.data is None:  # string column: host-side, NAs counted
        a = col.host_data[: col.local_rows]
        na = sum(1 for v in a if v is None)
        mesh = mesh_of(col)
        if mesh is not None:
            na = int(mesh.all_reduce(torch.tensor([na]), "sum")[0])
        return Rollups(np.nan, np.nan, np.nan, np.nan, na, col.nrows - na,
                       col.nrows - na)
    data = col.data
    if col.is_categorical:
        valid = data >= 0
        x = torch.where(valid, data, 0).float()
    else:
        valid = ~torch.isnan(data)
        x = torch.where(valid, data, 0.0).float()
    mesh = mesh_of(col)
    if mesh is None:
        n = int(valid.sum())
        s = float(torch.sum(x, dtype=torch.float32))
        ss = float(torch.sum(x * x, dtype=torch.float32))
        mn = float(torch.where(valid, x, torch.inf).min()) if n else np.nan
        mx = float(torch.where(valid, x, -torch.inf).max()) if n else np.nan
        nz = int((valid & (x != 0)).sum())
    else:
        dev = x.device
        part = torch.stack([
            valid.sum().double(), torch.sum(x, dtype=torch.float32).double(),
            torch.sum(x * x, dtype=torch.float32).double(),
            (valid & (x != 0)).sum().double()]).to(dev).contiguous()
        lo = torch.where(valid, x, torch.inf).double()
        hi = torch.where(valid, x, -torch.inf).double()
        ext = torch.stack([
            lo.min() if lo.numel() else torch.tensor(torch.inf, device=dev,
                                                     dtype=torch.float64),
            -(hi.max() if hi.numel() else torch.tensor(
                -torch.inf, device=dev, dtype=torch.float64))]).contiguous()
        mesh.all_reduce(part, "sum")
        mesh.all_reduce(ext, "min")
        n, s, ss, nz = part.tolist()
        n, nz = int(n), int(nz)
        mn = float(ext[0]) if n else np.nan
        mx = float(-ext[1]) if n else np.nan
    na = col.nrows - n
    mean = s / n if n else float("nan")
    var = max(ss / n - mean * mean, 0.0) if n else float("nan")
    sigma = float(np.sqrt(var * n / (n - 1))) if n and n > 1 else 0.0
    return Rollups(mn, mx, mean, sigma, int(na), nz, n)


def moments(d: torch.Tensor, power: int = 2, mesh=None) -> List[float]:
    """[count, sum of squares, sum of `power`-th powers] of the non-NaN
    float64 values d about their mean, in two passes (the count and sum,
    then the centred sums), each all-reduced across `mesh`: moments whose
    ranks' partials add in float64, so a row-sharded column's agree with
    one process's to float64 rounding (the float32 one-pass rollups above
    lose ~1e-5 of a variance whose mean is large against it)."""
    valid = ~torch.isnan(d)
    s1 = torch.stack([valid.sum().double(), torch.where(valid, d, 0.0)
                      .sum()])
    if mesh is not None:
        mesh.all_reduce(s1, "sum")
    nn, tot = s1.tolist()
    dc = torch.where(valid, d - tot / max(nn, 1.0), 0.0)
    s2 = torch.stack([(dc ** 2).sum(), (dc ** power).sum()])
    if mesh is not None:
        mesh.all_reduce(s2, "sum")
    return [nn, tot] + s2.tolist()
