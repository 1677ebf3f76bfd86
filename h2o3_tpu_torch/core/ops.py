"""Small tensor operations shared by the port's modules."""

from __future__ import annotations

import torch


def segment_sum(idx: torch.Tensor, vals: torch.Tensor, size: int
                ) -> torch.Tensor:
    """(size, *vals.shape[1:]) sums of the rows of `vals` grouped by `idx`
    (int64 in [0, size)), the same on every run and on every device.

    The rows are sorted by group (a stable sort), scanned in float64 and
    each group's sum is the difference of the scan at its two ends,
    rounded once to the values' dtype. No atomics: a scatter-add would sum
    in the order its atomics land, and on the card ``index_put_`` with
    accumulate serializes every group through one warp."""
    order = torch.argsort(idx, stable=True)
    v = vals[order].double().reshape(len(idx), -1)
    # scan each column along its contiguous (innermost) dim: the card's
    # scan over an outer dim runs one thread per column
    csum = torch.cumsum(v.T.contiguous(), dim=1)
    csum = torch.nn.functional.pad(csum, (1, 0))            # (C, N+1)
    starts = torch.searchsorted(
        idx[order], torch.arange(size + 1, device=idx.device))
    out = (csum[:, starts[1:]] - csum[:, starts[:-1]]).T    # (size, C)
    return out.reshape((size,) + tuple(vals.shape[1:])).to(vals.dtype)


def fixed_point_segment_sum(idx: torch.Tensor, x: torch.Tensor, size: int
                            ) -> torch.Tensor:
    """(size,) float32 sums of the float32 values `x` grouped by `idx`
    (int64 in [0, size)), the same on every run and on every device.

    The histogram kernel's order-free convention (models/tree/
    hist_gather.py), per group: each group g gets the power-of-two scale
    2**k_g with k_g = 62 - e_g - ceil(log2(n_g)), where |x| < 2**e_g over
    the group's n_g finite values; each value is scaled and rounded to an
    int64 (half to even), the integers are summed exactly with
    ``index_add_`` in any order, and the sum is scaled back in float64
    and rounded once to float32. A group holding +inf (-inf) sums to
    +inf (-inf), both or a NaN to NaN."""
    dev = x.device
    finite = torch.isfinite(x)
    xf = torch.where(finite, x, 0.0).double()
    gmax = torch.zeros(size, dtype=torch.float64, device=dev).scatter_reduce(
        0, idx, xf.abs(), "amax")
    cnt = torch.bincount(idx, minlength=size).double()
    rbits = torch.where(cnt > 1, torch.floor(torch.log2(
        torch.clamp_min(cnt - 1, 1))) + 1, torch.zeros_like(cnt))
    k = 62 - torch.frexp(gmax)[1].double() - rbits
    two = torch.full_like(k, 2.0)
    q = torch.round(xf * torch.pow(two, k)[idx]).long()
    acc = torch.zeros(size, dtype=torch.int64, device=dev).index_add_(
        0, idx, q)
    s = (acc.double() * torch.pow(two, -k)).float()
    bad = lambda m: torch.bincount(idx[m], minlength=size) > 0  # noqa: E731
    pinf, ninf, nan = bad(x == torch.inf), bad(x == -torch.inf), \
        bad(torch.isnan(x))
    s = torch.where(pinf, torch.inf, s)
    s = torch.where(ninf, -torch.inf, s)
    return torch.where(nan | (pinf & ninf), torch.nan, s)
