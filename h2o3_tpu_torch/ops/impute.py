"""NA imputation (counterpart of h2o3_tpu/ops/impute.py; AstImpute).

`impute` fills the NAs of the named column (or of every column) in
place, by the mean, the median (the exact quantile) or the mode, and
returns the fill values (None for a column it left alone). Enum columns
take only the mode, the most frequent code (the lowest on a tie).
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Column, Frame, T_CAT


def impute(frame: Frame, column=-1, method: str = "mean"):
    cols = (frame.names if (column == -1 or column is None) else
            [frame.names[column] if isinstance(column, int) else column])
    values = []
    for name in cols:
        c = frame.col(name)
        if c.is_categorical:
            codes = c.data.long()
            valid = codes[codes >= 0]
            if method != "mode" or valid.numel() == 0:
                values.append(None)
                continue
            mode = int(torch.argmax(torch.bincount(valid)))
            frame.replace(name, Column(
                torch.where(codes >= 0, codes, mode).to(c.data.dtype),
                T_CAT, c.nrows, domain=c.domain))
            values.append(float(mode))
        elif c.is_numeric or c.ctype == "time":
            if method == "mean":
                v = c.mean()
            elif method == "median":
                from h2o3_tpu_torch.ops.quantile import quantile_column

                v = quantile_column(c, [0.5])[0]
            elif method == "mode":
                vals = c.to_numpy()
                u, cnts = np.unique(vals[~np.isnan(vals)], return_counts=True)
                v = float(u[cnts.argmax()]) if len(u) else np.nan
            else:
                raise ValueError(f"method {method!r}")
            fill = torch.tensor(np.float32(v), device=c.data.device)
            frame.replace(name, Column.from_device(
                torch.where(torch.isnan(c.data), fill, c.data), c.ctype,
                c.nrows))
            values.append(float(v))
        else:
            values.append(None)
    return values
