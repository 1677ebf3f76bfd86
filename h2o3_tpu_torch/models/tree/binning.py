"""Feature binning for histogram tree building (counterpart of
h2o3_tpu/models/tree/binning.py).

Global bins computed once before training: quantile edges, or
equal-width edges over [min, max] (strategy "uniform", which isolation
forests use: they split uniformly in value space). Above `sample` rows
the edges come from a stride sample whose stride is taken, as the
reference takes it, from the length the reference pads a column to on
one device (`pad_rows`), not from the row count. Bins for feature f:
0..B_f-2 are value bins, B_f-1 is the NA bin. Numeric bin b holds x in
(edge[b-1], edge[b]], i.e. bin = searchsorted(edges, x, side='left');
categorical bin = category code, capped at the NA bin.

On a row-sharded cloud the edges are the one-process edges bit for bit:
each rank takes the rows of the global stride sample that fall in its
block, the row mesh gathers them in row order (the reference's
``jnp.nanquantile`` over its global array gathers too), and every rank
computes the same quantiles; "uniform" takes the cloud's min and max.
`bin_columns` bins each rank's own rows (core/sharded_frame.pack_binned).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame, widen


def _nanquantile(data: torch.Tensor, qs: np.ndarray) -> np.ndarray:
    """Linear-interpolation quantiles of the non-NaN values of `data`,
    computed exactly as the reference's ``jnp.nanquantile`` on the CPU
    (float32 throughout): position q*(count-1) in float32, and the
    interpolation low*(1-h) rounded, then high*h + that as one fused
    multiply-add. jnp.nanquantile returns its input's dtype, so the
    quantiles of a bfloat16 column are those float32 results rounded to
    bfloat16. Returns float64 values of the results."""
    half = data.dtype == torch.bfloat16
    v = data[~torch.isnan(data)].float().cpu()
    q = torch.as_tensor(qs, dtype=torch.float32)
    if v.numel() == 0:
        return np.full(len(qs), np.nan)
    v, _ = torch.sort(v)
    cnt = torch.tensor(float(v.numel()), dtype=torch.float32)
    pos = q * (cnt - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    low = torch.clamp(low, 0, cnt - 1).long()
    high = torch.clamp(high, 0, cnt - 1).long()
    lo_part = (v[low] * lw).double()
    # f64 holds the f32 product high*hw exactly, so one f64 add and one
    # rounding to f32 give the fused multiply-add
    out = (v[high].double() * hw.double() + lo_part).float()
    if half:
        out = out.to(torch.bfloat16)
    return out.double().numpy()


def _uniform_edges(data: torch.Tensor, nbins: int, mesh=None) -> np.ndarray:
    """The nbins-1 inner edges of nbins equal-width bins over the non-NaN
    [min, max] of `data` (of every rank's, with `mesh`), computed as the
    reference computes them: the float32 min and max, then
    ``np.linspace`` in float64. No edges when the column is all NaN or
    constant."""
    v = data[~torch.isnan(data)]
    if mesh is not None:
        ext = torch.tensor([float(v.min()) if v.numel() else np.inf,
                            -float(v.max()) if v.numel() else np.inf],
                           dtype=torch.float64)
        mesh.all_reduce(ext, "min")
        lo, hi = float(ext[0]), -float(ext[1])
        if not (np.isfinite(lo) and np.isfinite(hi) and hi > lo):
            return np.zeros(0)
        return np.linspace(lo, hi, nbins + 1)[1:-1]
    if v.numel() == 0:
        return np.zeros(0)
    lo, hi = float(v.min()), float(v.max())
    if not (np.isfinite(lo) and np.isfinite(hi) and hi > lo):
        return np.zeros(0)
    return np.linspace(lo, hi, nbins + 1)[1:-1]


def pad_rows(n: int, align: int = 8) -> int:
    """The length the reference pads an n-row column to on one device
    (h2o3_tpu/core/runtime.py:153 with one row shard): the smallest
    multiple of `align` >= n, at least `align`."""
    return max(-(-int(n) // align) * align, align)


class BinSpec:
    """Per-feature bin layout.

    names: feature names in order; is_cat (F,) bool; nbins (F,) B_f
    INCLUDING the NA bin; offsets (F+1,) start of each feature's bins in a
    flattened histogram row (tot_bins = offsets[-1]); edges: per-feature
    float32 arrays (numeric: ascending unique quantile edges, len B_f-2;
    categorical: empty); cards (F,) categorical cardinalities (0 numeric).
    """

    def __init__(self, names, is_cat, nbins, edges, cards):
        self.names: List[str] = list(names)
        self.is_cat = np.asarray(is_cat, bool)
        self.nbins = np.asarray(nbins, np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.nbins)]
                                      ).astype(np.int64)
        self.tot_bins = int(self.offsets[-1])
        self.edges = edges
        self.cards = np.asarray(cards, np.int64)
        self.F = len(self.names)

    @staticmethod
    def build(frame: Frame, feature_names: Sequence[str], *,
              nbins: int = 20, nbins_cats: int = 1024,
              sample: int = 200_000,
              strategy: str = "quantile") -> "BinSpec":
        """Edges per numeric feature (quantiles, or equal-width over the
        non-NaN [min, max] for strategy "uniform"; of a stride sample
        above `sample` padded rows), identity bins per categorical."""
        if strategy not in ("quantile", "uniform"):
            raise ValueError(f"unknown binning strategy {strategy!r} "
                             "(quantile | uniform)")
        from h2o3_tpu_torch.core.sharded_frame import mesh_of

        is_cat, B, edges, cards = [], [], [], []
        qs = np.linspace(0, 1, nbins + 1)[1:-1]
        mesh = mesh_of(frame.col(feature_names[0])) if feature_names \
            else None
        for name in feature_names:
            c = frame.col(name)
            if c.is_categorical:
                card = min(max(c.cardinality, 1), nbins_cats)
                is_cat.append(True)
                B.append(card + 1)
                edges.append(np.zeros(0, np.float32))
                cards.append(card)
                continue
            data = c.data
            # the reference's padding rows are NaN and drop out of the
            # quantiles, so striding the real rows samples the same rows
            n_pad = pad_rows(c.nrows)
            stride = max(n_pad // sample, 1) if n_pad > sample else 1
            lo = c.shard[0] if mesh is not None else 0
            # this rank's rows of the global stride sample: rows r with
            # r % stride == 0, from the first such row of its block
            data = data[(-lo) % stride:: stride]
            if strategy == "uniform":
                e = _uniform_edges(data, nbins, mesh)
            else:
                if mesh is not None:
                    data = mesh.all_gather(data)
                e = _nanquantile(data, qs)
            e = np.unique(e[np.isfinite(e)]).astype(np.float32)
            is_cat.append(False)
            B.append(len(e) + 2)        # len(e)+1 value bins + NA bin
            edges.append(e)
            cards.append(0)
        return BinSpec(feature_names, is_cat, B, edges, cards)

    def threshold_value(self, f: int, t: int) -> float:
        """The real threshold of the numeric split `bin <= t` (x <= edge
        t; binning.py:172)."""
        e = self.edges[f]
        return float(e[t]) if t < len(e) else float("inf")

    def padded_edges(self) -> np.ndarray:
        """(F, emax) float32 edge table, +inf beyond each feature's edges
        (the +inf lanes never count, so it bins like the ragged arrays)."""
        emax = max((len(e) for e in self.edges), default=0) or 1
        ep = np.full((self.F, emax), np.inf, np.float32)
        for i, e in enumerate(self.edges):
            ep[i, : len(e)] = e
        return ep

    def bin_columns(self, frame: Frame) -> torch.Tensor:
        """-> (N, F) bin matrix on the frame's device, in the narrowest
        integer dtype that holds every bin (uint8 up to 256 bins)."""
        from h2o3_tpu_torch.core.sharded_frame import ShardedFrame

        return ShardedFrame.of(frame, self.names).pack_binned(self)
