"""Box coders (counterpart of ``detmatch_tpu/core/coders.py``; the
inference slice needs only the residual decode)."""
from __future__ import annotations

import torch


class ResidualCoder:
    """7-dof anchor-residual coder (pcdet ``ResidualCoder``)."""

    code_size = 7

    def decode(self, encodings, anchors):
        """encodings (..., 7), anchors (..., 7+C) → boxes (..., 7)."""
        diag = torch.sqrt(anchors[..., 3] ** 2 + anchors[..., 4] ** 2)
        xg = encodings[..., 0] * diag + anchors[..., 0]
        yg = encodings[..., 1] * diag + anchors[..., 1]
        zg = encodings[..., 2] * anchors[..., 5] + anchors[..., 2]
        dxg = torch.exp(encodings[..., 3]) * anchors[..., 3]
        dyg = torch.exp(encodings[..., 4]) * anchors[..., 4]
        dzg = torch.exp(encodings[..., 5]) * anchors[..., 5]
        rg = encodings[..., 6] + anchors[..., 6]
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg], dim=-1)
