"""Box coders (counterpart of ``detmatch_tpu/core/coders.py``: the 7-dof
residual coder that PV-RCNN uses)."""
from __future__ import annotations

import torch


class ResidualCoder:
    """7-dof anchor-residual coder (pcdet ``ResidualCoder``)."""

    code_size = 7

    def encode(self, boxes, anchors):
        """boxes, anchors (..., 7) → residual targets (..., 7); sizes
        clamped at 1e-5."""
        dxa = torch.clamp(anchors[..., 3], min=1e-5)
        dya = torch.clamp(anchors[..., 4], min=1e-5)
        dza = torch.clamp(anchors[..., 5], min=1e-5)
        dxg = torch.clamp(boxes[..., 3], min=1e-5)
        dyg = torch.clamp(boxes[..., 4], min=1e-5)
        dzg = torch.clamp(boxes[..., 5], min=1e-5)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            (boxes[..., 0] - anchors[..., 0]) / diag,
            (boxes[..., 1] - anchors[..., 1]) / diag,
            (boxes[..., 2] - anchors[..., 2]) / dza,
            torch.log(dxg / dxa), torch.log(dyg / dya),
            torch.log(dzg / dza), boxes[..., 6] - anchors[..., 6]], dim=-1)

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
