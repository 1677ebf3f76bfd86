"""Segment models: one model per distinct combination of segment
columns (counterpart of h2o3_tpu/models/segments.py: `SegmentModels`
:28, `as_frame` :48, `train_segments` :59).

`train_segments` trains the same builder and parameters on each
segment's rows (ops/filters.take_rows on the frame's device), the
segment columns left out of the predictors. On a row-sharded cloud the
segments' keys are all-gathered as distinct values and each segment's
rows are placed through the row exchange, so a segment trains across
the ranks through its builder's own `row_sharded` gate; each NaN-keyed
row is a segment of its own there as in one process. A segment whose train
raises is recorded with its error and the others go on, as the
reference's bulk builder does. The result lives in the DKV under its
key; `as_frame` is its table of segment values, model keys, status and
errors (the Rapids prim segment_models_as_frame turns it into a frame).
"""

from __future__ import annotations

import traceback
from typing import List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.dkv import Keyed
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.utils.twodim import TwoDimTable


class SegmentModels(Keyed):
    """One row per segment: its values, the trained model's key or the
    error its train raised."""

    def __init__(self, segment_columns: List[str], key: Optional[str] = None):
        super().__init__(key)
        self.segment_columns = list(segment_columns)
        self.rows: List[dict] = []
        self.install()

    def add(self, values: tuple, model=None, error: Optional[str] = None,
            warnings: Optional[List[str]] = None):
        self.rows.append({
            "segment": dict(zip(self.segment_columns, values)),
            "model_id": str(model.key) if model is not None else None,
            "status": "SUCCEEDED" if model is not None else "FAILED",
            "errors": error,
            "warnings": warnings or [],
        })

    def as_frame(self) -> TwoDimTable:
        t = TwoDimTable("segment_models",
                        self.segment_columns + ["model", "status", "errors"],
                        ["string"] * (len(self.segment_columns) + 3))
        for r in self.rows:
            t.add_row(*[r["segment"][c] for c in self.segment_columns],
                      r["model_id"], r["status"], r["errors"] or "")
        return t

    def __len__(self):
        return len(self.rows)


def _segments(frame: Frame, seg_cols: List[str]):
    """(the distinct rows of the segment columns' values, sorted as
    `np.unique(axis=0)` sorts them; a function from a segment's index to
    a frame of its rows, in row order). On a row-sharded cloud each rank
    finds the distinct keys of its own rows, the ranks all-gather those
    (keys, not rows), and a segment's rows are each rank's matching rows
    placed through the row exchange (`filters.keep_rows`). A row with a
    NaN key is a segment of its own (NaN equals nothing), as one process
    makes it; the ranks all-gather those rows' keys and ids, and such
    segments sort after the others at their NaN's column, tied ones in
    row order (ROADMAP C53: one process's `np.unique` orders the tied
    ones as its quicksort leaves them)."""
    from h2o3_tpu_torch.core import sharded_frame as SF
    from h2o3_tpu_torch.core.frame import widen
    from h2o3_tpu_torch.ops.filters import keep_rows, take_rows

    mesh = SF.sharded_mesh(frame)
    if mesh is None:
        codes = np.stack([np.asarray(frame.col(c).to_numpy())
                          for c in seg_cols], axis=1)
        uniq, inverse = np.unique(codes, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        return uniq, lambda si: take_rows(frame, np.nonzero(inverse == si)[0])
    if any(frame.col(c).data is None for c in seg_cols):
        # one process stacks the columns into an object array, which
        # np.unique(axis=0) refuses
        raise TypeError("The axis argument to unique is not supported for "
                        "dtype object")
    codes = np.stack([widen(frame.col(c).data).cpu().numpy()
                      for c in seg_cols], axis=1)
    lo = frame.shard[0]
    nan = np.isnan(codes).any(axis=1)
    parts = SF.all_gather_object(mesh, (
        np.unique(codes[~nan], axis=0),
        [(r.tolist(), lo + i) for i, r in zip(np.nonzero(nan)[0],
                                                codes[nan])]))
    segs = [(r.tolist(), -1) for r in np.unique(np.concatenate(
        [p[0] for p in parts]), axis=0)]
    segs += [t for p in parts for t in p[1]]
    segs.sort(key=lambda t: (tuple((v != v, 0.0 if v != v else v)
                                   for v in t[0]), t[1]))
    uniq = np.asarray([v for v, _g in segs], codes.dtype).reshape(
        len(segs), len(seg_cols))

    def rows_of(si):
        vals, g = segs[si]
        if g >= 0:      # a NaN row: its own segment
            hit = [g - lo] if lo <= g < lo + frame.local_rows else []
        else:
            hit = np.nonzero((codes == np.asarray(vals)).all(axis=1))[0]
        return keep_rows(frame, torch.as_tensor(np.asarray(hit, np.int64)))
    return uniq, rows_of


def train_segments(builder_cls, params: dict, frame: Frame,
                   segment_columns: Sequence[str],
                   y: Optional[str] = None,
                   max_segments: int = 0) -> SegmentModels:
    """builder_cls(**params) trained once per distinct combination of
    the segment columns' values (enum codes, NA as its own segment),
    in sorted order."""
    seg_cols = list(segment_columns)
    for c in seg_cols:
        if c not in frame:
            raise ValueError(f"segment column {c!r} not in frame")
    uniq, rows_of = _segments(frame, seg_cols)
    if max_segments and len(uniq) > max_segments:
        raise ValueError(f"{len(uniq)} segments exceed max_segments="
                         f"{max_segments}")
    out = SegmentModels(seg_cols)
    for si in range(len(uniq)):
        vals = []
        for j, c in enumerate(seg_cols):
            col = frame.col(c)
            v = uniq[si, j]
            if col.is_categorical and col.domain is not None and v >= 0:
                vals.append(col.domain[int(v)])
            else:
                vals.append(v)
        sub = None
        try:
            sub = rows_of(si)
            p = dict(params)
            p["ignored_columns"] = list(p.get("ignored_columns") or []) \
                + seg_cols
            m = builder_cls(**p).train(y=y, training_frame=sub)
            out.add(tuple(vals), model=m)
        except Exception:   # noqa: BLE001 — recorded per segment
            out.add(tuple(vals), error=traceback.format_exc(limit=3))
        finally:
            if sub is not None:
                sub.delete()
    return out
