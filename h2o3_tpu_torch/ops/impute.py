"""NA imputation (counterpart of h2o3_tpu/ops/impute.py; AstImpute).

`impute` fills the NAs of the named column (or of every column) in
place, by the mean, the median (the exact quantile) or the mode, and
returns the fill values (None for a column it left alone). Enum columns
take only the mode, the most frequent code (the lowest on a tie).

Every statistic is the column's over all its rows: on a row-sharded
cloud the mean is the cloud's rollups, the median the sharded quantile,
and the mode comes from the group-by's level counts (`level_counts`:
an enum column's counts all-reduced, a numeric column's distinct values
all-gathered), so every rank fills its own rows with one value and no
row moves.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT, widen


def mode_of(col: Column) -> float:
    """The most frequent non-NA value (enum: code) of a column over all
    its rows, the lowest on a tie; NaN when it has none."""
    from h2o3_tpu_torch.ops.groupby import level_counts

    lev, cnt = level_counts(col)
    if not len(lev) or int(cnt.max()) == 0:
        return float("nan")
    return float(lev[int(np.argmax(cnt))])


def impute(frame: Frame, column=-1, method: str = "mean"):
    cols = (frame.names if (column == -1 or column is None) else
            [frame.names[column] if isinstance(column, int) else column])
    values = []
    for name in cols:
        c = frame.col(name)
        if c.is_categorical:
            if method != "mode":
                values.append(None)
                continue
            mode = mode_of(c)
            if mode != mode:
                values.append(None)
                continue
            codes = c.data.long()
            frame.replace(name, Column(
                torch.where(codes >= 0, codes, int(mode)).to(c.data.dtype),
                T_CAT, c.nrows, domain=c.domain))
            values.append(mode)
        elif c.is_numeric or c.ctype == "time":
            if method == "mean":
                v = c.mean()
            elif method == "median":
                from h2o3_tpu_torch.ops.quantile import quantile_column

                v = quantile_column(c, [0.5])[0]
            elif method == "mode":
                v = mode_of(c)
            else:
                raise ValueError(f"method {method!r}")
            # a float32 fill promotes a bf16 column to float32, as the
            # reference's jnp.float32 fill does
            d = widen(c.data)
            fill = torch.tensor(np.float32(v), device=d.device)
            frame.replace(name, Column.from_device(
                torch.where(torch.isnan(d), fill, d), c.ctype, c.nrows))
            values.append(float(v))
        else:
            values.append(None)
    return values
