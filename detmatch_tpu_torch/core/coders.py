"""Box coders (counterpart of ``detmatch_tpu/core/coders.py``): the 7-dof
residual coder that PV-RCNN uses, PointRCNN's point-anchored coder, the
2D delta coder of Faster R-CNN and the xyxy / cxcywh conversions."""
from __future__ import annotations

import numpy as np
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


class DeltaXYWHCoder:
    """mmdet ``DeltaXYWHBBoxCoder``: xyxy boxes ↔ (dx, dy, dw, dh) deltas,
    normalised by ``target_means``/``target_stds``; decoding clamps the
    log sizes at ``|log(wh_ratio_clip)|``."""

    def __init__(self, target_means=(0., 0., 0., 0.),
                 target_stds=(1., 1., 1., 1.), wh_ratio_clip=16 / 1000):
        self.means = np.asarray(target_means, np.float32)
        self.stds = np.asarray(target_stds, np.float32)
        self.wh_ratio_clip = wh_ratio_clip

    def encode(self, proposals, gt):
        """proposals, gt (..., 4) xyxy → (..., 4) deltas; widths and
        heights clamped at 1e-6."""
        px = (proposals[..., 0] + proposals[..., 2]) * 0.5
        py = (proposals[..., 1] + proposals[..., 3]) * 0.5
        pw = torch.clamp(proposals[..., 2] - proposals[..., 0], min=1e-6)
        ph = torch.clamp(proposals[..., 3] - proposals[..., 1], min=1e-6)
        gx = (gt[..., 0] + gt[..., 2]) * 0.5
        gy = (gt[..., 1] + gt[..., 3]) * 0.5
        gw = gt[..., 2] - gt[..., 0]
        gh = gt[..., 3] - gt[..., 1]
        deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                              torch.log(torch.clamp(gw, min=1e-6) / pw),
                              torch.log(torch.clamp(gh, min=1e-6) / ph)],
                             dim=-1)
        means = torch.as_tensor(self.means, device=deltas.device)
        stds = torch.as_tensor(self.stds, device=deltas.device)
        return (deltas - means) / stds

    def decode(self, proposals, deltas, max_shape=None):
        """proposals, deltas (..., 4) → (..., 4) xyxy, clipped to
        ``[0, (w, h, w, h)]`` if ``max_shape``, an (h, w) tensor, is
        given."""
        stds = torch.as_tensor(self.stds, device=deltas.device)
        means = torch.as_tensor(self.means, device=deltas.device)
        deltas = deltas * stds + means
        max_ratio = abs(float(np.log(self.wh_ratio_clip)))
        dx, dy = deltas[..., 0], deltas[..., 1]
        dw = torch.clamp(deltas[..., 2], -max_ratio, max_ratio)
        dh = torch.clamp(deltas[..., 3], -max_ratio, max_ratio)
        px = (proposals[..., 0] + proposals[..., 2]) * 0.5
        py = (proposals[..., 1] + proposals[..., 3]) * 0.5
        pw = proposals[..., 2] - proposals[..., 0]
        ph = proposals[..., 3] - proposals[..., 1]
        gx = px + pw * dx
        gy = py + ph * dy
        gw = pw * torch.exp(dw)
        gh = ph * torch.exp(dh)
        out = torch.stack([gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5,
                           gy + gh * 0.5], dim=-1)
        if max_shape is not None:
            h, w = max_shape[0], max_shape[1]
            lim = torch.stack([w, h, w, h]).to(out.dtype)
            out = torch.minimum(torch.clamp(out, min=0), lim)
        return out


def xyxy_to_cxcywh(boxes):
    return torch.stack([(boxes[..., 0] + boxes[..., 2]) * 0.5,
                        (boxes[..., 1] + boxes[..., 3]) * 0.5,
                        boxes[..., 2] - boxes[..., 0],
                        boxes[..., 3] - boxes[..., 1]], dim=-1)


def cxcywh_to_xyxy(boxes):
    cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5,
                        cy + h * 0.5], dim=-1)


class PointResidualCoder:
    """Point-anchored 8-code coder (pcdet ``PointResidualCoder``): offsets
    normalised by per-class mean sizes, log sizes, cos / sin heading.
    PointRCNN's point head."""

    code_size = 8

    def __init__(self, mean_size=((3.9, 1.6, 1.56), (0.8, 0.6, 1.73),
                                  (1.76, 0.6, 1.73)), use_mean_size=True):
        self.use_mean_size = use_mean_size
        self.mean_size = np.asarray(mean_size, np.float32)

    def _anchor_dims(self, classes, like):
        """(...) 1-based classes → (..., 3) mean sizes (ones without
        ``use_mean_size``)."""
        if not self.use_mean_size:
            return torch.ones(like.shape[:-1] + (3,), dtype=like.dtype,
                              device=like.device)
        ms = torch.as_tensor(self.mean_size, device=like.device)
        return ms[torch.clamp(classes.long() - 1, 0, ms.shape[0] - 1)]

    def encode(self, gt_boxes, points, gt_classes=None):
        """gt_boxes (..., 7), points (..., 3) → (..., 8)."""
        dims = torch.clamp(gt_boxes[..., 3:6], min=1e-5)
        a = self._anchor_dims(gt_classes, gt_boxes)
        diag = torch.sqrt(a[..., 0] ** 2 + a[..., 1] ** 2)
        return torch.stack([
            (gt_boxes[..., 0] - points[..., 0]) / diag,
            (gt_boxes[..., 1] - points[..., 1]) / diag,
            (gt_boxes[..., 2] - points[..., 2]) / a[..., 2],
            torch.log(dims[..., 0] / a[..., 0]),
            torch.log(dims[..., 1] / a[..., 1]),
            torch.log(dims[..., 2] / a[..., 2]),
            torch.cos(gt_boxes[..., 6]), torch.sin(gt_boxes[..., 6])], -1)

    def decode(self, encodings, points, pred_classes=None):
        """encodings (..., 8), points (..., 3) → (..., 7)."""
        a = self._anchor_dims(pred_classes, encodings)
        diag = torch.sqrt(a[..., 0] ** 2 + a[..., 1] ** 2)
        xyz = torch.stack([encodings[..., 0] * diag + points[..., 0],
                           encodings[..., 1] * diag + points[..., 1],
                           encodings[..., 2] * a[..., 2] + points[..., 2]],
                          -1)
        dims = torch.exp(encodings[..., 3:6]) * a
        rg = torch.atan2(encodings[..., 7], encodings[..., 6])
        return torch.cat([xyz, dims, rg[..., None]], -1)
