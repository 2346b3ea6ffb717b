"""The 2D RoI head, inference half (counterpart of
``detmatch_tpu/models/frcnn/roi_head2d.py``; mmdet ``StandardRoIHead`` +
``Shared2FCBBoxHead``): 7x7 RoIAlign features through two shared
1024-wide FCs to C + 1 sigmoid logits (the background is its own
channel, last) and class-specific deltas (stds 0.1/0.1/0.2/0.2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core import nms as nms_mod
from ...core.coders import DeltaXYWHCoder

BBOX_STDS = (0.1, 0.1, 0.2, 0.2)


class Shared2FCBBoxHead(nn.Module):
    """mmdet names: ``shared_fcs.{0,1}``, ``fc_cls``, ``fc_reg``. The first
    FC reads the pooled (C, 7, 7) features flattened channel-major, as
    mmdet does (the JAX head flattens (7, 7, C); ``convert.from_jax_frcnn``
    permutes its input rows)."""

    def __init__(self, num_classes=3, in_channels=256, roi_size=7,
                 fc_dim=1024):
        super().__init__()
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_size * roi_size, fc_dim),
            nn.Linear(fc_dim, fc_dim)])
        self.fc_cls = nn.Linear(fc_dim, num_classes + 1)
        self.fc_reg = nn.Linear(fc_dim, num_classes * 4)

    def forward(self, roi_feats):
        """(R, C, 7, 7) → (cls (R, C+1), reg (R, 4C))."""
        x = roi_feats.flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)


def decode_rcnn(rois, cls_logits, reg_preds, num_classes, img_shape):
    """(R, 4) rois → per-class boxes (R, C, 4) clipped to ``img_shape``
    and sigmoid scores (R, C + 1)."""
    coder = DeltaXYWHCoder(target_stds=BBOX_STDS)
    r = rois.shape[0]
    reg = reg_preds.reshape(r, num_classes, 4)
    boxes = coder.decode(rois[:, None, :].expand(r, num_classes, 4), reg,
                         max_shape=img_shape)
    return boxes, torch.sigmoid(cls_logits)


def multiclass_nms_2d(boxes_per_cls, scores, score_thr, iou_thr, max_num):
    """mmdet multiclass NMS over per-class boxes that keeps each
    survivor's whole score row (DetMatch ``modified_multiclass_nms``).

    Args:
        boxes_per_cls: (R, C, 4); scores: (R, C + 1), background last.
    Returns:
        dict(boxes (max_num, 4), scores (max_num,), labels (max_num,),
        scores_full (max_num, C + 1), valid (max_num,)).
    """
    r, c = boxes_per_cls.shape[:2]
    dev = scores.device
    flat_boxes = boxes_per_cls.reshape(r * c, 4)
    flat_scores = scores[:, :c].reshape(r * c)
    flat_labels = torch.arange(c, dtype=torch.int32, device=dev).repeat(r)
    flat_rows = torch.arange(r, device=dev).repeat_interleave(c)
    masked = torch.where(flat_scores > score_thr, flat_scores,
                         nms_mod.NEG_INF)
    idx, valid = nms_mod.batched_nms_2d(flat_boxes, masked, flat_labels,
                                        iou_thr, max_num)
    idx = idx.long()
    return dict(
        boxes=torch.where(valid[:, None], flat_boxes[idx], 0.0),
        scores=torch.where(valid, flat_scores[idx], 0.0),
        labels=torch.where(valid, flat_labels[idx], 0),
        scores_full=torch.where(valid[:, None], scores[flat_rows[idx]], 0.0),
        valid=valid)
