"""Device-side tree growth: histogram, split search, routing and leaf
statistics for one tree, all on the device (counterpart of
h2o3_tpu/models/tree/device_tree.py).

Dense-frontier slots: level d holds S_d = min(2^d, frontier_cap) slots;
nodes that split are renumbered by a prefix sum and record explicit
child-slot links in their row of the packed per-level table. When a
level wants more than S_{d+1}/2 splits, the lowest-gain candidates
become leaves. Every level's histogram is the hand-written CUDA kernel
(hist_gather.py) on the card, its plain version on the CPU. The tree is
grown with eager torch ops queued on the current stream; nothing is
fetched to the host until the end of training, except the packed tables
of trees deeper than 10 levels (stash_packed).

On a row-sharded cloud (``mesh=``) each rank grows the tree over its own
rows: the histograms are the kernel's cross-rank form, the response
mean and the leaf sums are order-free fixed-point sums all-reduced
across the ranks (core/ops.fixed_point_group_sums), split search runs
replicated on the reduced histogram (as the reference's runs on its
psum'd one) and routing stays shard-local. Every rank holds the same
tree, bit for bit the one-process tree over all the rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from h2o3_tpu_torch.core.ops import (fixed_point_group_sums,
                                     fixed_point_sums)
from h2o3_tpu_torch.models.tree.hist_gather import hist_gather

EPS_W = 1e-12
DEFAULT_FRONTIER_CAP = 4096
# block length of the reference's prefix sum (see _prefix_sum)
_SCAN_BLOCK = 16


def frontier_cap(F: Optional[int] = None, maxB: Optional[int] = None) -> int:
    """Frontier width budget; with the feature geometry given it shrinks
    so an (S, F, maxB, 3) f32 histogram stays under ~512 MB."""
    cap = DEFAULT_FRONTIER_CAP
    if F and maxB:
        budget_slots = (512 * 1024 * 1024) // (F * maxB * 12)
        mem_cap = 1 << max(int(budget_slots).bit_length() - 1, 8)
        cap = min(cap, mem_cap)
    return cap


def stash_packed(packed: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Fit loops hold every tree's packed table until the end of training.
    Shallow tables stay on the device; deep ones (cap-wide levels) move
    to the host at once, so a long depth-20 forest does not fill the
    card."""
    if max_depth > 10:
        return packed.cpu()
    return packed


def build_feat_masks(max_depth: int, feat_mask_fn, F: Optional[int] = None,
                     maxB: Optional[int] = None):
    """Per-level (S_d, F) bool column-sampling masks (host numpy) for
    grow_tree_device, drawn level by level as the reference draws them."""
    if feat_mask_fn is None:
        return None
    widths = level_widths(max_depth, frontier_cap(F, maxB))
    return [np.asarray(feat_mask_fn(wd), bool) for wd in widths[:max_depth]]


def level_widths(max_depth: int, cap: Optional[int] = None
                 ) -> Tuple[int, ...]:
    """Per-level slot counts S_d = min(2^d, cap)."""
    cap = cap or frontier_cap()
    return tuple(min(2 ** d, cap) for d in range(max_depth + 1))


def level_offsets(widths: Tuple[int, ...]) -> Tuple[int, ...]:
    out, acc = [], 0
    for s in widths:
        out.append(acc)
        acc += s
    return tuple(out)


def pack_width(maxB: int) -> int:
    """Per-slot f32 lanes: split_feat, thresh, na_left, gain, left_table
    (maxB), tot (3), left_slot, right_slot."""
    return 4 + maxB + 3 + 2


def _scan_f32(x: torch.Tensor) -> torch.Tensor:
    """Sequential float32 inclusive scan along the last dim, the order the
    reference's XLA reductions take on the CPU (torch's own cumsum and
    sum use other orders, and on the CPU a float64 accumulator)."""
    out = x.clone()
    for i in range(1, out.shape[-1]):
        out[..., i] += out[..., i - 1]
    return out


def _prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 prefix sum along `dim` in the reference's
    summation order: XLA on the CPU scans blocks of 16 sequentially and
    adds each block the (recursively scanned) total of the blocks before
    it. The same order on the card and the CPU keeps the split gains
    equal to the reference's on the same histogram."""
    x = x.movedim(dim, -1)
    L = x.shape[-1]
    if L <= _SCAN_BLOCK:
        out = _scan_f32(x)
    else:
        nb = -(-L // _SCAN_BLOCK)
        xp = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - L))
        inb = _scan_f32(xp.reshape(*x.shape[:-1], nb, _SCAN_BLOCK))
        before = _prefix_sum(inb[..., -1], -1)[..., :-1]
        inb[..., 1:, :] += before[..., None]
        out = inb.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :L]
    return out.movedim(-1, dim)


def _search_level(hist, *, nbins, is_cat, maxB: int, min_rows: float,
                  min_split_improvement: float, feat_mask=None):
    """hist (S, F, maxB, 3) -> split tables for this level.

    nbins (F,) int64 and is_cat (F,) bool are tensors on hist's device;
    feat_mask, when given, is an (S, F) bool tensor there: a feature it
    leaves out cannot split that slot.
    Returns split_feat (S,) int32 (-1 terminal), thresh (S,) int32
    (position in sorted-bin space), na_left (S,) bool, gain (S,) f32,
    left_table (S, maxB) bool, tot (S, 3) f32 node totals.
    """
    S, F = hist.shape[0], hist.shape[1]
    dev = hist.device
    binsr = torch.arange(maxB, device=dev)
    fr = torch.arange(F, device=dev)

    na_pos = nbins - 1                                     # (F,)
    val_mask = binsr[None, :] < na_pos[:, None]            # (F, maxB)
    na = hist[:, fr, na_pos, :]                            # (S, F, 3)
    V = hist * val_mask[None, :, :, None]
    tot = _scan_f32(V.movedim(2, -1))[..., -1] + na        # (S, F, 3)

    w_, wy_, wyy_ = tot[..., 0], tot[..., 1], tot[..., 2]
    se_parent = wyy_ - torch.where(
        w_ > EPS_W, wy_ * wy_ / torch.clamp_min(w_, EPS_W), 0.0)

    # bin order: categorical by per-node mean response, numeric by index
    mean = torch.where(V[..., 0] > EPS_W,
                       V[..., 1] / torch.clamp_min(V[..., 0], EPS_W),
                       torch.inf)
    sort_key = torch.where(is_cat[None, :, None], mean,
                           binsr[None, None, :].float())
    order = torch.argsort(sort_key, dim=2, stable=True)    # (S, F, maxB)
    Vs = torch.gather(V, 2, order[..., None].expand(-1, -1, -1, 3))
    cand = _prefix_sum(Vs, 2)[:, :, :-1, :]                # split after t

    # valid candidate positions: t <= nbins[f]-3 (value bins minus one)
    cand_ok = binsr[None, :-1] <= (nbins[:, None] - 3)     # (F, maxB-1)

    def gains_for(na_dir):
        L = cand + na[:, :, None, :] if na_dir else cand
        R = tot[:, :, None, :] - L
        ok = (L[..., 0] >= min_rows) & (R[..., 0] >= min_rows) & cand_ok[None]
        seL = L[..., 2] - torch.where(
            L[..., 0] > EPS_W,
            L[..., 1] ** 2 / torch.clamp_min(L[..., 0], EPS_W), 0.0)
        seR = R[..., 2] - torch.where(
            R[..., 0] > EPS_W,
            R[..., 1] ** 2 / torch.clamp_min(R[..., 0], EPS_W), 0.0)
        g = se_parent[:, :, None] - seL - seR
        return torch.where(ok, g, -torch.inf)

    gains = torch.stack([gains_for(0), gains_for(1)], dim=-1)  # (S,F,maxB-1,2)
    if feat_mask is not None:
        gains = torch.where(feat_mask[:, :, None, None], gains, -torch.inf)
    flat = gains.reshape(S, -1)
    bi = torch.argmax(flat, dim=1)                 # first maximum
    bg = torch.gather(flat, 1, bi[:, None])[:, 0]
    per_f = (maxB - 1) * 2
    f_star = bi // per_f
    rem = bi % per_f
    t_star = (rem // 2).int()
    na_left = (rem % 2).bool()

    valid = bg > min_split_improvement
    split_feat = torch.where(valid, f_star.int(), -1)

    # routing LUT: bin b goes left iff its position in the sorted order <= t*
    order_sel = order[torch.arange(S, device=dev), f_star]   # (S, maxB)
    rank = torch.argsort(order_sel, dim=1, stable=True)      # inverse perm
    go_left = rank <= t_star[:, None]
    napos_sel = na_pos[f_star]                               # (S,)
    left_table = torch.where(binsr[None, :] == napos_sel[:, None],
                             na_left[:, None], go_left)
    tot0 = tot[:, 0, :]                                      # same for all f
    return (split_feat, t_star, na_left, torch.where(valid, bg, 0.0),
            left_table, tot0)


def leaf_sums(row_leaf, cols, tot_slots: int, mesh=None):
    """(tot_slots, C) per-leaf column sums, rounded once to the columns'
    dtype from order-free fixed-point sums (the same on every run and for
    every split of the rows into ranks of `mesh`; rows outside any leaf
    go to a dropped extra slot)."""
    idx = torch.where(row_leaf >= 0, row_leaf, tot_slots)
    idx = torch.clamp_max(idx, tot_slots).long()
    return fixed_point_group_sums(idx, cols, tot_slots + 1,
                                  mesh)[:tot_slots].to(cols.dtype)


def grow_tree_device(binned, w, y, spec, *, max_depth: int, min_rows: float,
                     min_split_improvement: float, num=None, den=None,
                     feat_masks=None, mesh=None, n_global=None):
    """Grow one tree on binned's device; nothing is fetched to the host.

    binned (N, F) integer bin matrix (BinSpec.bin_columns); w, y, num, den
    (N,) float32 (num/den are the leaf Newton-step rows; default num=w*y,
    den=w). feat_masks: optional per-level (S_d, F) bool arrays for levels
    0..max_depth-1 (column sampling, mtries), widths as level_widths().
    Returns (packed, leaf4, row_leaf):
      packed   (max_depth+1, S_max, pack_width(maxB)) f32 per-level split
               tables with explicit child-slot links
      leaf4    (total_slots, 4) per-leaf sums of (w, w*y, num, den),
               indexed by GLOBAL slot id (level offset + slot)
      row_leaf (N,) int32 global leaf slot id per row
    With `mesh` the rows are this rank's block of `n_global` rows and the
    tables and sums are the cloud's (see the module note).
    """
    N, F = binned.shape
    dev = binned.device
    maxB = int(spec.nbins.max())
    widths = level_widths(int(max_depth), frontier_cap(F, maxB))
    offs = level_offsets(widths)
    tot_slots = sum(widths)
    Smax = max(widths)
    K = pack_width(maxB)
    TB = F * maxB
    offsets = torch.arange(F, dtype=torch.int32, device=dev) * maxB
    nbins = torch.as_tensor(spec.nbins, dtype=torch.long, device=dev)
    is_cat = torch.as_tensor(spec.is_cat, dtype=torch.bool, device=dev)
    w = w.float()
    y = y.float()
    num = w * y if num is None else num.float()
    den = w if den is None else den.float()

    # center y for the histogram: split gains are invariant under a
    # constant shift; only the packed node totals are de-centered below
    masks = (None if feat_masks is None else
             [torch.as_tensor(np.asarray(m), device=dev) for m in feat_masks])
    # order-free fixed-point sums of the float64 products (w*y of two
    # f32s is exact there), rounded once to f32: the same on the card and
    # the CPU whatever order the sums take, and for any split into ranks
    wd = w.double()
    sw_wy = fixed_point_sums(torch.stack([wd * y.double(), wd], dim=1),
                             mesh)
    ymean = (sw_wy[0] / torch.clamp_min(sw_wy[1], EPS_W)).float()
    yc = y - ymean
    row_node = torch.zeros(N, dtype=torch.int32, device=dev)
    row_leaf = torch.full((N,), -1, dtype=torch.int32, device=dev)

    packed = torch.zeros(max_depth + 1, Smax, K, dtype=torch.float32,
                         device=dev)
    for d in range(max_depth + 1):
        S = widths[d]
        live = row_leaf < 0
        if d < max_depth:
            hist = hist_gather(binned, torch.where(live, row_node, -1),
                               torch.where(live, w, 0.0), yc,
                               offsets=offsets, TB=TB, S=S, mesh=mesh,
                               n_global=n_global)
            (split_feat, t_star, na_left, gain, left_table,
             tot) = _search_level(
                hist.reshape(S, F, maxB, 3), nbins=nbins, is_cat=is_cat,
                maxB=maxB, min_rows=min_rows,
                min_split_improvement=min_split_improvement,
                feat_mask=None if masks is None else masks[d])
            # frontier budget: keep at most S_{d+1}//2 splits, best gain
            # first; the rest become leaves
            want = split_feat >= 0
            if 2 * S > widths[d + 1]:
                order = torch.argsort(-torch.where(want, gain, -torch.inf),
                                      stable=True)
                rank = torch.argsort(order, stable=True)
                keep = want & (rank < widths[d + 1] // 2)
            else:
                keep = want
            split_feat = torch.where(keep, split_feat, -1)
            gain = torch.where(keep, gain, 0.0)
            ki = keep.int()
            excl = torch.cumsum(ki, 0, dtype=torch.int32) - ki
            left_slot = torch.where(keep, 2 * excl, -1)
            right_slot = torch.where(keep, 2 * excl + 1, -1)
        else:
            split_feat = torch.full((S,), -1, dtype=torch.int32, device=dev)
            t_star = torch.zeros(S, dtype=torch.int32, device=dev)
            na_left = torch.zeros(S, dtype=torch.bool, device=dev)
            gain = torch.zeros(S, dtype=torch.float32, device=dev)
            left_table = torch.zeros(S, maxB, dtype=torch.bool, device=dev)
            tot = torch.zeros(S, 3, dtype=torch.float32, device=dev)
            left_slot = right_slot = split_feat

        # de-center the node totals back to true y space
        # (wy = wy_c + w*ymean; wyy = wyy_c + 2*ymean*wy_c + ymean^2*w)
        tot_true = torch.stack(
            [tot[:, 0],
             tot[:, 1] + tot[:, 0] * ymean,
             tot[:, 2] + 2 * ymean * tot[:, 1] + ymean * ymean * tot[:, 0]],
            dim=1)
        packed[d, :S, :] = torch.cat(
            [split_feat.float()[:, None], t_star.float()[:, None],
             na_left.float()[:, None], gain[:, None], left_table.float(),
             tot_true, left_slot.float()[:, None],
             right_slot.float()[:, None]], dim=1)

        node = row_node.long()
        sf = split_feat[node]
        terminal = sf < 0
        row_leaf = torch.where(live & terminal, offs[d] + row_node, row_leaf)
        b = torch.gather(binned, 1, torch.clamp_min(sf, 0).long()[:, None])
        gl = left_table[node, torch.clamp_max(b[:, 0].long(), maxB - 1)]
        row_node = torch.where(live & ~terminal,
                               torch.where(gl, left_slot[node],
                                           right_slot[node]), 0)

    leaf4 = leaf_sums(row_leaf, torch.stack([w, w * y, num, den], dim=-1),
                      tot_slots, mesh)
    return packed, leaf4, row_leaf


def apply_packed(binned, packed, values, max_depth: int, maxB: int):
    """Route (N, F) binned rows through one packed tree table ->
    (N,) f32 leaf values, `values` indexed by global leaf slot id (the
    in-training validation margins)."""
    N, F = binned.shape
    dev = binned.device
    widths = level_widths(int(max_depth), frontier_cap(F, maxB))
    offs = level_offsets(widths)
    K = pack_width(maxB)
    row_node = torch.zeros(N, dtype=torch.long, device=dev)
    row_leaf = torch.full((N,), -1, dtype=torch.long, device=dev)
    for d in range(int(max_depth) + 1):
        S = widths[d]
        split_feat = packed[d, :S, 0].long()
        left_table = packed[d, :S, 4:4 + maxB] > 0.5
        ls = packed[d, :S, K - 2].long()
        rs = packed[d, :S, K - 1].long()
        live = row_leaf < 0
        sf = split_feat[row_node]
        terminal = sf < 0
        row_leaf = torch.where(live & terminal, offs[d] + row_node, row_leaf)
        b = torch.gather(binned, 1, torch.clamp_min(sf, 0)[:, None])[:, 0]
        gl = left_table[row_node, torch.clamp_max(b.long(), maxB - 1)]
        row_node = torch.where(live & ~terminal,
                               torch.where(gl, ls[row_node], rs[row_node]), 0)
    return values[torch.clamp_min(row_leaf, 0)]


def assemble_trees(packs, leaf_vals, leaf_wys, spec, max_depth: int,
                   scale: float = 1.0):
    """End-of-training epilogue: fetch every tree's tables in one transfer
    (host-stashed deep tables are stacked on the host) and build the
    HostTrees (leaf values scaled by `scale`: DRF divides by the tree
    count so the summed traversal averages)."""
    packs_np = torch.stack(packs).cpu().numpy()
    vals_np = torch.stack(leaf_vals).cpu().numpy().astype(np.float64) * scale
    wys_np = torch.stack(leaf_wys).cpu().numpy().astype(np.float64)
    return [host_tree_from_packed(packs_np[i], wys_np[i], spec, max_depth,
                                  leaf_values=vals_np[i])
            for i in range(len(packs))]


def host_tree_from_packed(packed_np: np.ndarray, leaf_wy: np.ndarray,
                          spec, max_depth: int,
                          leaf_values: Optional[np.ndarray] = None):
    """Assemble a HostTree from one tree's packed table (numpy).

    packed_np (max_depth+1, S_max, K); leaf_wy (total_slots, 2) per-leaf
    (w, w*y); leaf_values optional (total_slots,) leaf predictions. Leaf
    ids are GLOBAL slot ids."""
    from h2o3_tpu_torch.models.tree.dtree import HostTree, Split

    maxB = int(spec.nbins.max())
    K = pack_width(maxB)
    widths = level_widths(max_depth, frontier_cap(spec.F, maxB))
    offs = level_offsets(widths)
    tree = HostTree()
    tree.n_leaves = sum(widths)
    # slot -> node id of the current level, in the order the nodes were
    # made (one dict per level, not one scanned whole at every level)
    level_nid = {0: 0}
    root_tot = packed_np[0, 0, 4 + maxB:4 + maxB + 3]
    tree.nodes[0].weight = float(root_tot[0])
    tree.nodes[0].pred = float(root_tot[1]) / max(float(root_tot[0]), EPS_W)

    for d in range(max_depth + 1):
        lv = packed_np[d]
        next_lv = packed_np[d + 1] if d + 1 <= max_depth else None
        next_nid = {}
        for s, nid in level_nid.items():
            node = tree.nodes[nid]
            f = int(lv[s, 0])
            if f < 0:
                gid = offs[d] + s
                node.leaf_id = gid
                lw, lwy = leaf_wy[gid]
                node.weight = float(lw)
                node.pred = float(lwy) / max(float(lw), EPS_W)
                if leaf_values is not None:
                    node.leaf_value = float(leaf_values[gid])
                continue
            Bf = int(spec.nbins[f])
            lt_row = lv[s, 4:4 + maxB] > 0.5
            if bool(spec.is_cat[f]):
                sp = Split(f, True, -1, lt_row[: Bf - 1].copy(),
                           bool(lv[s, 2] > 0.5), float(lv[s, 3]),
                           (0.0, 0.0), (0.0, 0.0))
            else:
                sp = Split(f, False, int(lv[s, 1]), None,
                           bool(lv[s, 2] > 0.5), float(lv[s, 3]),
                           (0.0, 0.0), (0.0, 0.0))
            node.split = sp
            node.left = tree.new_node(d + 1)
            node.right = tree.new_node(d + 1)
            ls, rs = int(lv[s, K - 2]), int(lv[s, K - 1])
            next_nid[ls] = node.left
            next_nid[rs] = node.right
            if next_lv is not None:
                for child_nid, cs in ((node.left, ls), (node.right, rs)):
                    cw = float(next_lv[cs, 4 + maxB])
                    cwy = float(next_lv[cs, 4 + maxB + 1])
                    tree.nodes[child_nid].weight = cw
                    tree.nodes[child_nid].pred = cwy / max(cw, EPS_W)
                sp.left_stats = (float(next_lv[ls, 4 + maxB]),
                                 float(next_lv[ls, 4 + maxB + 1]))
                sp.right_stats = (float(next_lv[rs, 4 + maxB]),
                                  float(next_lv[rs, 4 + maxB + 1]))
        level_nid = next_nid
    return tree
