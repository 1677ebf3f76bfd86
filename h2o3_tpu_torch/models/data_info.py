"""Response preparation (counterpart of the `response_weight` :169 and
`clean_response` :183 parts of h2o3_tpu/models/data_info.py)."""

from __future__ import annotations

import torch


class DataInfo:

    @staticmethod
    def response_weight(y, w=None):
        """Effective row weight: user weights x response-valid mask (NA
        responses, NaN or a -1 code, drop out)."""
        valid = (y >= 0) if not torch.is_floating_point(y) \
            else ~torch.isnan(y)
        base = valid.float()
        if w is not None:
            base = base * torch.where(torch.isnan(w), 0.0, w).float()
        return base

    @staticmethod
    def clean_response(y):
        """Replace the NA sentinel with 0 so math stays finite (weights are
        already 0 there)."""
        if not torch.is_floating_point(y):
            return torch.clamp_min(y, 0)
        return torch.where(torch.isnan(y), 0.0, y)
