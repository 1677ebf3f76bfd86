"""Small tensor operations shared by the port's modules."""

from __future__ import annotations

import math

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
    # an empty rank of a row mesh has no rows to infer the width from
    v = vals[order].double().reshape(len(idx), math.prod(vals.shape[1:]))
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
    (int64 in [0, size)), the same on every run and on every device:
    `fixed_point_group_sums` of one column, rounded once to float32."""
    return fixed_point_group_sums(idx, x, size)[:, 0].float()


def _row_bits(cnt: torch.Tensor) -> torch.Tensor:
    """ceil(log2(max(c, 1))) of float64 counts, elementwise."""
    return torch.where(cnt > 1, torch.floor(torch.log2(
        torch.clamp_min(cnt - 1, 1))) + 1, torch.zeros_like(cnt))


def fixed_point_group_sums(idx: torch.Tensor, vals: torch.Tensor, size: int,
                           mesh=None) -> torch.Tensor:
    """(size, C) float64 sums of the rows of the (N, C) float values
    `vals` grouped by `idx` (int64 in [0, size)), the same on every run,
    on every device and for every split of the rows into ranks of `mesh`
    (the sums are all-reduced across it).

    The histogram kernel's order-free convention, per group g and column
    c: with |x| < 2**e over the group's finite values (the max over every
    rank) and n_g its rows (over every rank), each value is scaled by
    2**k, k = 62 - e - ceil(log2(n_g)), and rounded half to even to an
    int64; the integers are summed exactly (then a SUM all-reduce) and
    the sum Q is returned as float64(Q) * 2**-k. A group holding +inf
    (-inf) sums to +inf (-inf), both or a NaN to NaN.

    Maxima and integer sums are exact in any order, so they are taken
    however is fastest: one group by dense reductions, a few groups by
    scatters over copies of the groups (row i to copy i % copies), so
    that a scatter's atomics do not queue on a few addresses."""
    dev = vals.device
    v = (vals[:, None] if vals.dim() == 1 else vals).double()
    N, C = v.shape
    copies = max(1, min(1024, N // (256 * max(size, 1))))
    slot = idx if copies == 1 else \
        torch.arange(N, device=dev) % copies * size + idx

    def reduce(x, how):
        if size == 1 and N:
            return (x.amax(0, keepdim=True) if how == "amax"
                    else x.sum(0, keepdim=True))
        out = torch.zeros(copies * size, x.shape[1], dtype=x.dtype,
                          device=dev)
        if how == "amax":
            out.scatter_reduce_(0, slot[:, None].expand(-1, x.shape[1]), x,
                                "amax")
            return out.view(copies, size, x.shape[1]).amax(0)
        out.index_add_(0, slot, x)
        return out.view(copies, size, x.shape[1]).sum(0)

    finite = torch.isfinite(v)
    vf = torch.where(finite, v, 0.0)
    gmax = reduce(vf.abs(), "amax")
    ones = torch.ones(N, 1, dtype=torch.int64, device=dev)
    counts = reduce(torch.cat(
        [ones, (v == torch.inf).long(), (v == -torch.inf).long(),
         torch.isnan(v).long()], dim=1), "sum")
    if mesh is not None:
        mesh.all_reduce(gmax, "max")
        mesh.all_reduce(counts, "sum")
    k = 62 - torch.frexp(gmax)[1].double() - _row_bits(
        counts[:, :1].double())
    two = torch.full_like(k, 2.0)
    scale = torch.pow(two, k)
    q = torch.round(vf * (scale if size == 1 else scale[idx])).long()
    acc = reduce(q, "sum")
    if mesh is not None:
        mesh.all_reduce(acc, "sum")
    s = acc.double() * torch.pow(two, -k)
    pinf = counts[:, 1:1 + C] > 0
    ninf = counts[:, 1 + C:1 + 2 * C] > 0
    nan = counts[:, 1 + 2 * C:] > 0
    s = torch.where(pinf, torch.inf, s)
    s = torch.where(ninf, -torch.inf, s)
    return torch.where(nan | (pinf & ninf), torch.nan, s)


def fixed_point_sums(vals: torch.Tensor, mesh=None) -> torch.Tensor:
    """(C,) float64 sums of the columns of (N, C) `vals` (a 1-D tensor is
    one column) by `fixed_point_group_sums` with one group: order-free,
    and the same for every split of the rows into ranks of `mesh`."""
    v = vals[:, None] if vals.dim() == 1 else vals
    idx = torch.zeros(v.shape[0], dtype=torch.int64, device=v.device)
    return fixed_point_group_sums(idx, v, 1, mesh)[0]
