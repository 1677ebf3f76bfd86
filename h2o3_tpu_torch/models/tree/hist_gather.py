"""Tree-histogram gather -> accumulate: the CUDA kernel's wrapper, its
plain PyTorch version and the shared-memory tile planner.

Counterpart of h2o3_tpu/models/tree/pallas_hist.py (`hist_gather` :416,
`_build_gather` :326, `_pad_rows` :385, `hist_gather_xla` :443,
`plan_tiles` :82). The function: an (n, F) integer bin matrix, per-row
node / w / y and per-feature base offsets give an (S*TB, 3) f32
histogram of (w, w*y, w*y*y) at flat index ``node*TB + offsets[f] +
bin``. Rows whose node lies outside [0, S) (dead rows carry -1)
contribute nothing.

On a CUDA tensor :func:`hist_gather` launches the hand-written kernel in
``csrc/hist_gather.cu`` (see the note there for its bound and design);
on a CPU tensor it computes the plain version :func:`hist_gather_ref`.
There is no fallback between the two: a CUDA call that cannot launch
raises. The kernel needs no row padding (it masks its ragged last row
block itself), so the reference's `_pad_rows` has no counterpart.
"""

from __future__ import annotations

import torch

# The most shared memory one block may use on Hopper (227 KB).
SMEM_PER_BLOCK = 232_448
# Pass 1's per-warp staging of (w, w*y, w*y*y) for 32 rows (8 warps).
STAGE_BYTES = 8 * 96 * 4
# Rows per block: at least this many, and enough that at most MAX_CTAS
# blocks cover n. The row ranges depend on n alone, so the partial sums,
# and with them the result, are the same for every tile plan.
ROWS_PER_CTA_MIN = 4096
MAX_CTAS = 256

# Kernel launches made by hist_gather (not by the plain version).
launches = 0


def plan_tiles(TB: int, S: int, budget: int = SMEM_PER_BLOCK - STAGE_BYTES):
    """Frontier tiling for an (S*TB, 3) f32 accumulator in `budget` bytes
    of shared memory: the largest power-of-two tile_S whose accumulator
    (tile_S*TB*12 bytes) fits, capped at S. Returns ``(tile_S, n_tiles)``
    or None when even a single slot does not fit."""
    if 12 * TB > budget:
        return None
    tile_S = 1
    while tile_S < S and 24 * TB * tile_S <= budget:
        tile_S *= 2
    tile_S = min(tile_S, S)
    return tile_S, -(-S // tile_S)


def row_grid(n: int):
    """(rows_per_cta, G): the fixed row range each block owns, a multiple
    of 32 rows, and the number of row blocks."""
    rows = max(ROWS_PER_CTA_MIN, -(-n // MAX_CTAS))
    rows = -(-rows // 32) * 32
    return rows, -(-n // rows)


def hist_gather_ref(binned, node, w, y, *, offsets, TB: int, S: int):
    """Plain PyTorch version: flat index + ``index_add_``. The per-row
    triples are the kernel's f32 values; they are summed in float64 and
    rounded once, so the result does not depend on the order the adds
    take (``index_add_`` on the card adds atomically)."""
    n, F = binned.shape
    live = (node >= 0) & (node < S)
    nd = node[live].long()
    b = binned[live].long()
    wl = w[live].float()
    yl = y[live].float()
    off = torch.as_tensor(offsets, dtype=torch.long, device=binned.device)
    idx = nd[:, None] * TB + off[None, :] + b                   # (m, F)
    wy = wl * yl
    vals = torch.stack([wl, wy, wy * yl], dim=-1).double()      # (m, 3)
    out = torch.zeros(S * TB, 3, dtype=torch.float64, device=binned.device)
    out.index_add_(0, idx.reshape(-1),
                   vals[:, None, :].expand(-1, F, 3).reshape(-1, 3))
    return out.float()


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


def hist_gather(binned, node, w, y, *, offsets, TB: int, S: int,
                tile_S=None):
    """(n, F) bins + per-row node/w/y -> (S*TB, 3) f32 histogram.

    `offsets` is the (F,) per-feature base (an int32 tensor on the bins'
    device, or anything ``torch.as_tensor`` takes); every
    ``offsets[f] + bin`` must be < TB. `tile_S` overrides the planner (the
    result is bitwise the same for every tiling). CPU tensors take the
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
        plan = plan_tiles(TB, S)
        if plan is None:
            raise ValueError(
                f"one histogram slot ({TB} bins x 3 f32 = {12 * TB} bytes) "
                f"does not fit in a block's shared memory; this geometry "
                f"needs the scatter lowering, which is not ported yet")
        tile_S, n_tiles = plan
    else:
        tile_S = int(tile_S)
        n_tiles = -(-S // tile_S)
    out = torch.empty(S * TB, 3, dtype=torch.float32, device=binned.device)
    rows, G = row_grid(n)
    if G == 0:
        return out.zero_()
    from h2o3_tpu_torch import kernels

    lib = kernels.load("hist_gather")
    smem = lib.hist_gather_smem_bytes(TB, tile_S)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"tile_S={tile_S} needs {smem} bytes of shared "
                         f"memory, more than a block's {SMEM_PER_BLOCK}")
    scratch = torch.empty(G, n_tiles * tile_S * TB * 3, dtype=torch.float32,
                          device=binned.device)
    stream = torch.cuda.current_stream(binned.device).cuda_stream
    err = lib.hist_gather_launch(
        binned.data_ptr(), binned.element_size(), node.data_ptr(),
        w.data_ptr(), y.data_ptr(), offsets.data_ptr(), n, F, TB, S, tile_S,
        n_tiles, rows, G, scratch.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hist_gather kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
