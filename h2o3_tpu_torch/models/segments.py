"""Segment models: one model per distinct combination of segment
columns (counterpart of h2o3_tpu/models/segments.py: `SegmentModels`
:28, `as_frame` :48, `train_segments` :59).

`train_segments` trains the same builder and parameters on each
segment's rows (ops/filters.take_rows on the frame's device), the
segment columns left out of the predictors. A segment whose train
raises is recorded with its error and the others go on, as the
reference's bulk builder does. The result lives in the DKV under its
key; `as_frame` is its table of segment values, model keys, status and
errors (the Rapids prim segment_models_as_frame turns it into a frame).
"""

from __future__ import annotations

import traceback
from typing import List, Optional, Sequence

import numpy as np

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


def train_segments(builder_cls, params: dict, frame: Frame,
                   segment_columns: Sequence[str],
                   y: Optional[str] = None,
                   max_segments: int = 0) -> SegmentModels:
    """builder_cls(**params) trained once per distinct combination of
    the segment columns' values (enum codes, NA as its own segment),
    in sorted order."""
    from h2o3_tpu_torch.ops.filters import take_rows

    seg_cols = list(segment_columns)
    for c in seg_cols:
        if c not in frame:
            raise ValueError(f"segment column {c!r} not in frame")
    codes = np.stack([np.asarray(frame.col(c).to_numpy()) for c in seg_cols],
                     axis=1)
    uniq, inverse = np.unique(codes, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
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
            sub = take_rows(frame, np.nonzero(inverse == si)[0])
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
