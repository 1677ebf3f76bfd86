"""Tree-histogram gather -> accumulate: the CUDA kernel's wrapper, its
plain PyTorch version and the shared-memory tile planner.

Counterpart of h2o3_tpu/models/tree/pallas_hist.py (`hist_gather` :416,
`_build_gather` :326, `_pad_rows` :385, `hist_gather_xla` :443,
`plan_tiles` :82). The function: an (n, F) integer bin matrix, per-row
node / w / y and per-feature base offsets give an (S*TB, 3) f32
histogram of (w, w*y, w*y*y) at flat index ``node*TB + offsets[f] +
bin``. Rows whose node lies outside [0, S) (dead rows carry -1)
contribute nothing.

Both versions sum in int64 fixed point, so the result does not depend
on the order of the adds and the kernel equals the plain version bit
for bit. For each channel c of (w, w*y, (w*y)*y), computed in f32 over
all n rows whatever their node:

1. ``m_c = max |v|``; ``e_c`` is its frexp exponent (``m_c < 2**e_c``),
   ``b = ceil(log2(max(n, 1)))`` and ``k_c = 62 - e_c - b``, so no sum of
   n rows can reach 2**62;
2. each row's value becomes ``q = round_half_even(float64(v) * 2**k_c)``
   as int64, and the buckets sum the q's;
3. a bucket's int64 sum Q gives ``float32(float64(Q) * 2**-k_c)``;
4. a channel whose ``m_c`` is Inf or NaN is NaN in every bucket.

A bucket is then exact to about ``rows * 2**-k_c`` absolute, far inside
an f32 row-order sum.

On a CUDA tensor :func:`hist_gather` launches the hand-written kernel in
``csrc/hist_gather.cu`` (see the note there for its bound and design);
on a CPU tensor it computes the plain version :func:`hist_gather_ref`.
There is no fallback between the two: a CUDA call that cannot launch
raises. The kernel needs no row padding (it masks its ragged last row
block itself), so the reference's `_pad_rows` has no counterpart.
"""

from __future__ import annotations

import math

import torch

# The most shared memory one block may use on Hopper (227 KB).
SMEM_PER_BLOCK = 232_448
# Shared-memory bytes per histogram bucket: three int64 sums.
BUCKET_BYTES = 24
# Rows per block: at least this many, and enough that at most MAX_CTAS
# blocks cover n. The grid depends on n alone, never on the card.
ROWS_PER_CTA_MIN = 4096
MAX_CTAS = 256
# Passes of the C entry point, as its `passes` bit mask.
PASS_SCALE, PASS_ACCUMULATE, PASS_FINALISE = 1, 2, 4
ALL_PASSES = PASS_SCALE | PASS_ACCUMULATE | PASS_FINALISE

# Kernel launches made by hist_gather (not by the plain version).
launches = 0


def plan_tiles(TB: int, S: int, budget: int = SMEM_PER_BLOCK):
    """Frontier tiling for an (S*TB, 3) int64 accumulator in `budget`
    bytes of shared memory: the largest power-of-two tile_S whose
    accumulator (tile_S*TB*24 bytes) fits, capped at S. Returns
    ``(tile_S, n_tiles)``, or None when even a single slot does not fit
    (the kernel then adds straight into its global accumulator)."""
    slot = BUCKET_BYTES * TB
    if slot > budget:
        return None
    tile_S = 1
    while tile_S < S and 2 * slot * tile_S <= budget:
        tile_S *= 2
    tile_S = min(tile_S, S)
    return tile_S, -(-S // tile_S)


def row_grid(n: int):
    """(rows_per_cta, G): the fixed row range each block owns, a multiple
    of 32 rows, and the number of row blocks."""
    rows = max(ROWS_PER_CTA_MIN, -(-n // MAX_CTAS))
    rows = -(-rows // 32) * 32
    return rows, -(-n // rows)


def row_bits(n: int) -> int:
    """b of the fixed-point convention: ceil(log2(max(n, 1)))."""
    return (max(n, 1) - 1).bit_length()


def fixed_point_exponent(m: float, n: int):
    """k_c of the fixed-point convention for a channel whose largest
    |value| over n rows is `m`: ``62 - e - row_bits(n)`` with
    ``m < 2**e`` (frexp). None when `m` is Inf or NaN."""
    if not math.isfinite(m):
        return None
    return 62 - math.frexp(m)[1] - row_bits(n)


def hist_gather_ref(binned, node, w, y, *, offsets, TB: int, S: int):
    """Plain PyTorch version of the kernel's integers: the same per-row
    f32 triples and k_c, quantised in float64, summed with ``index_add_``
    on int64 (exact, so the order of the adds does not matter) and
    finalised as the kernel does."""
    n, F = binned.shape
    dev = binned.device
    wf, yf = w.float(), y.float()
    wy = wf * yf
    vals = torch.stack([wf, wy, wy * yf], dim=-1)                # (n, 3)
    if n == 0:
        return torch.zeros(S * TB, 3, dtype=torch.float32, device=dev)
    ks = [fixed_point_exponent(m, n) for m in vals.abs().amax(0).tolist()]
    scale = torch.tensor([0.0 if k is None else math.ldexp(1.0, k)
                          for k in ks], dtype=torch.float64, device=dev)
    finite = torch.tensor([k is not None for k in ks], device=dev)
    q = torch.round(torch.where(finite, vals.double() * scale, 0.0)).long()
    live = (node >= 0) & (node < S)
    nd = node[live].long()
    off = torch.as_tensor(offsets, dtype=torch.long, device=dev)
    idx = nd[:, None] * TB + off[None, :] + binned[live].long()  # (m, F)
    acc = torch.zeros(S * TB, 3, dtype=torch.int64, device=dev)
    acc.index_add_(0, idx.reshape(-1),
                   q[live][:, None, :].expand(-1, F, 3).reshape(-1, 3))
    unscale = torch.tensor([math.nan if k is None else math.ldexp(1.0, -k)
                            for k in ks], dtype=torch.float64, device=dev)
    return (acc.double() * unscale).float()


def _check(binned, node, w, y, offsets, F):
    dev = binned.device
    if binned.dim() != 2 or binned.dtype not in (torch.uint8, torch.int16,
                                                 torch.int32):
        raise ValueError(f"binned must be (n, F) uint8/int16/int32, got "
                         f"{tuple(binned.shape)} {binned.dtype}")
    n = binned.shape[0]
    for name, t, dt in (("node", node, torch.int32), ("w", w, torch.float32),
                        ("y", y, torch.float32),
                        ("offsets", offsets, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, binned on {dev}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        want = F if name == "offsets" else n
        if t.dim() != 1 or t.shape[0] != want:
            raise ValueError(f"{name} must have shape ({want},), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not binned.is_contiguous():
        raise ValueError("binned must be contiguous")


def launch(lib, binned, node, w, y, offsets, scratch, out, *, TB, S, tile_S,
           n_tiles, passes=ALL_PASSES):
    """One call of the C entry point on the current stream: the chosen
    `passes` over `scratch` (int64, 2 + S*TB*3 words: the channel maxima,
    then the bucket sums) into `out`. Returns the CUDA error code."""
    n, F = binned.shape
    rows, G = row_grid(n)
    return lib.hist_gather_launch(
        binned.data_ptr(), binned.element_size(), node.data_ptr(),
        w.data_ptr(), y.data_ptr(), offsets.data_ptr(), n, F, TB, S, tile_S,
        n_tiles, rows, G, row_bits(n), passes,
        scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(binned.device).cuda_stream)


def hist_gather(binned, node, w, y, *, offsets, TB: int, S: int,
                tile_S=None):
    """(n, F) bins + per-row node/w/y -> (S*TB, 3) f32 histogram.

    `offsets` is the (F,) per-feature base (an int32 tensor on the bins'
    device, or anything ``torch.as_tensor`` takes); every
    ``offsets[f] + bin`` must be < TB. `tile_S` overrides the planner;
    0 adds every row straight into the global accumulator, with no
    shared-memory tile, as the planner does when one slot does not fit.
    The result is bitwise the same for every tiling. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    global launches
    if binned.device.type == "cpu":
        return hist_gather_ref(binned, node, w, y, offsets=offsets, TB=TB,
                               S=S)
    if binned.device.type != "cuda":
        raise ValueError(f"hist_gather runs on cuda or cpu, not "
                         f"{binned.device}")
    n, F = binned.shape
    offsets = torch.as_tensor(offsets, dtype=torch.int32,
                              device=binned.device)
    _check(binned, node, w, y, offsets, F)
    if tile_S is None:
        tile_S, n_tiles = plan_tiles(TB, S) or (0, 1)
    else:
        tile_S = int(tile_S)
        n_tiles = -(-S // tile_S) if tile_S else 1
        if BUCKET_BYTES * TB * tile_S > SMEM_PER_BLOCK:
            raise ValueError(f"tile_S={tile_S} needs "
                             f"{BUCKET_BYTES * TB * tile_S} bytes of shared "
                             f"memory, more than a block's {SMEM_PER_BLOCK}")
    if n == 0:
        return torch.zeros(S * TB, 3, dtype=torch.float32,
                           device=binned.device)
    from h2o3_tpu_torch import kernels

    lib = kernels.load("hist_gather")
    scratch = torch.zeros(2 + S * TB * 3, dtype=torch.int64,
                          device=binned.device)
    out = torch.empty(S * TB, 3, dtype=torch.float32, device=binned.device)
    err = launch(lib, binned, node, w, y, offsets, scratch, out, TB=TB, S=S,
                 tile_S=tile_S, n_tiles=n_tiles)
    if err != 0:
        raise RuntimeError(f"hist_gather kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
