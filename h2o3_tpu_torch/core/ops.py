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
