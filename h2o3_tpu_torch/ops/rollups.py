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
    if col.data is None:  # string column: host-side
        a = col.host_data[: col.nrows]
        na = sum(1 for v in a if v is None)
        return Rollups(np.nan, np.nan, np.nan, np.nan, na, len(a) - na,
                       len(a) - na)
    data = col.data
    if col.is_categorical:
        valid = data >= 0
        x = torch.where(valid, data, 0).float()
    else:
        valid = ~torch.isnan(data)
        x = torch.where(valid, data, 0.0).float()
    from h2o3_tpu_torch.core.sharded_frame import mesh_of

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
