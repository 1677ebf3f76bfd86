"""Level-wise histogram, row routing and leaf sums (counterpart of
h2o3_tpu/models/tree/histogram.py: `build_histogram` :89, `route_rows`
:138, `leaf_stats` :177).

The level-wise growers (host_grow.py, isofor.py) alternate one device
histogram of the active nodes, a host split decision and one device
routing pass. The histogram is the hand-written kernel (hist_gather.py)
on the card and its plain version on the CPU, over the BinSpec's ragged
per-feature offsets (TB = tot_bins); the slot count is padded to a
power of two, as the reference pads it, and the result comes to the host
as float64.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.ops import segment_sum
from h2o3_tpu_torch.models.tree.hist_gather import hist_gather


def _pow2(n: int) -> int:
    return max(1 << (int(n) - 1).bit_length(), 1) if n else 1


def build_histogram(binned, row_node, w, y, spec, n_nodes: int
                    ) -> np.ndarray:
    """-> host (n_nodes, tot_bins, 3) float64 histogram (w, wy, wyy) of
    the rows whose row_node is in [0, n_nodes); rows at -1 add nothing."""
    S = _pow2(n_nodes)
    dev = binned.device
    valid = row_node >= 0
    node = torch.where(valid, row_node, -1).int()
    wv = torch.where(valid, w.float(), 0.0)
    offsets = torch.as_tensor(spec.offsets[:-1], dtype=torch.int32,
                              device=dev)
    out = hist_gather(binned, node, wv, y.float().contiguous(),
                      offsets=offsets, TB=spec.tot_bins, S=S)
    return (out.reshape(S, spec.tot_bins, 3).cpu().numpy()
            .astype(np.float64)[:n_nodes])


def route_rows(binned, row_node, row_leaf, *, split_feat, left_table,
               left_slot, right_slot, leaf_id):
    """Apply one level's split decisions (host arrays, one entry per
    active slot) to every row on the device: a row of a splitting slot
    moves to its child slot, a row of a terminal slot takes the slot's
    leaf id and leaves the frontier (node -1)."""
    S = len(split_feat)
    dev = binned.device
    maxB = left_table.shape[1] if S else 1

    def t(a, fill):
        a = np.asarray(a, np.int64)
        return torch.as_tensor(a if S else np.full(1, fill), device=dev)

    sf = t(split_feat, -1)
    lt = torch.as_tensor(np.asarray(left_table, bool) if S
                         else np.zeros((1, 1), bool), device=dev)
    ls, rs, lid = t(left_slot, -1), t(right_slot, -1), t(leaf_id, -1)
    active = row_node >= 0
    node = torch.clamp_min(row_node, 0).long()
    f = sf[node]
    terminal = f < 0
    b = torch.gather(binned, 1, torch.clamp_min(f, 0)[:, None])[:, 0].long()
    go_left = lt[node, torch.clamp_max(b, maxB - 1)]
    new_node = torch.where(go_left, ls[node], rs[node])
    new_node = torch.where(active & ~terminal, new_node, -1).int()
    new_leaf = torch.where(active & terminal, lid[node].int(), row_leaf)
    return new_node, new_leaf


def leaf_stats(row_leaf, num, den, n_leaves: int):
    """Per-leaf sums of (num, den) -> two host float64 arrays."""
    idx = torch.where(row_leaf >= 0, row_leaf.long(), n_leaves)
    sums = segment_sum(idx, torch.stack([num.float(), den.float()], -1),
                       n_leaves + 1)[:n_leaves]
    out = sums.cpu().numpy().astype(np.float64)
    return out[:, 0], out[:, 1]
