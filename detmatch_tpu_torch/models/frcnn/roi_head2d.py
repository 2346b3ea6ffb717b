"""The 2D RoI head (counterpart of
``detmatch_tpu/models/frcnn/roi_head2d.py``; mmdet ``StandardRoIHead`` +
``Shared2FCBBoxHead``): 7x7 RoIAlign features through two shared
1024-wide FCs to C + 1 sigmoid logits (the background is its own
channel, last) and class-specific deltas (stds 0.1/0.1/0.2/0.2).
Training assigns proposals (the gt boxes appended) at IoU 0.5, samples
512 of them (a quarter positive at most) and takes a focal loss
(alpha 0.5, gamma 2) over the C + 1 channels and a class-specific L1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core import losses, nms as nms_mod
from ...core.coders import DeltaXYWHCoder
from ...parallel import global_sum
from ..init import PRIOR_BIAS
from ..layers import linear
from . import rpn

BBOX_STDS = (0.1, 0.1, 0.2, 0.2)


class Shared2FCBBoxHead(nn.Module):
    """mmdet names: ``shared_fcs.{0,1}``, ``fc_cls``, ``fc_reg``. The first
    FC reads the pooled (C, 7, 7) features flattened channel-major, as
    mmdet does (the JAX head flattens (7, 7, C); ``convert.from_jax_frcnn``
    permutes its input rows)."""

    def __init__(self, num_classes=3, in_channels=256, roi_size=7,
                 fc_dim=1024, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_size * roi_size, fc_dim),
            nn.Linear(fc_dim, fc_dim)])
        self.fc_cls = nn.Linear(fc_dim, num_classes + 1)
        self.fc_reg = nn.Linear(fc_dim, num_classes * 4)

    def init_explicit(self):
        """JAX's prior class bias and N(0, 0.001) box weights
        (``roi_head2d.py:44,47`` there)."""
        nn.init.constant_(self.fc_cls.bias, PRIOR_BIAS)
        nn.init.normal_(self.fc_reg.weight, std=0.001)

    def forward(self, roi_feats):
        """(R, C, 7, 7) → (cls (R, C+1), reg (R, 4C)); the shared FCs in
        ``dtype``, the two outputs in float32 (JAX ``roi_head2d.py:32-47``)."""
        x = roi_feats.flatten(1)
        for fc in self.shared_fcs:
            x = F.relu(linear(x, fc.weight, fc.bias, self.dtype))
        x = x.float()
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


def sample_rcnn_targets(generator, proposals, prop_valid, gt_boxes,
                        gt_labels, gt_valid, num=512, pos_fraction=0.25):
    """Assign and sample the RoIs of one image, the gt boxes appended as
    proposals; no gradient flows out.

    Returns:
        dict(rois (num, 4), labels (num,) int64 (-1 where not positive),
        reg_targets (num, 4), is_pos (num,), slot_valid (num,)).
    """
    coder = DeltaXYWHCoder(target_stds=BBOX_STDS)
    with torch.no_grad():
        cand = torch.cat([gt_boxes, proposals], 0)
        cand_valid = torch.cat([gt_valid, prop_valid], 0)
        assigned, _, _ = rpn.max_iou_assign(cand, cand_valid, gt_boxes,
                                            gt_valid, 0.5, 0.5, 0.5, False)
        idx, is_pos, slot_valid = rpn.random_sample(generator, assigned,
                                                    num, pos_fraction)
        rois = cand[idx]
        gt_idx = torch.clamp(assigned[idx] - 1, 0, gt_boxes.shape[0] - 1)
        labels = torch.where(is_pos, gt_labels[gt_idx].long(), -1)
        reg_targets = torch.where(is_pos[:, None],
                                  coder.encode(rois, gt_boxes[gt_idx]), 0.0)
    return dict(rois=rois, labels=labels, reg_targets=reg_targets,
                is_pos=is_pos, slot_valid=slot_valid)


def rcnn_loss(cls_logits, reg_preds, targets, num_classes=3,
              focal_gamma=2.0, focal_alpha=0.5):
    """Focal loss over the C + 1 sigmoid channels (the background a
    channel of its own) and class-specific L1 on the positives, both
    divided by the global batch's sample count.

    Args:
        cls_logits: (B, R, C+1); reg_preds: (B, R, 4C); targets: the
            batched :func:`sample_rcnn_targets`.
    """
    labels = torch.where(targets["is_pos"], targets["labels"], num_classes)
    valid = targets["slot_valid"].to(torch.float32)
    avg = torch.clamp(global_sum(valid.sum()), min=1.0)
    onehot = F.one_hot(labels, num_classes + 1).to(torch.float32)
    p = torch.sigmoid(cls_logits)
    pt = (1 - p) * onehot + p * (1 - onehot)
    fw = (focal_alpha * onehot + (1 - focal_alpha) * (1 - onehot)
          ) * pt ** focal_gamma
    cls_l = (losses.sigmoid_ce_with_logits(cls_logits, onehot) * fw).sum(-1)
    loss_cls = (cls_l * valid).sum() / avg
    b, r = labels.shape
    reg = reg_preds.reshape(b, r, num_classes, 4)
    cls_idx = torch.clamp(labels, 0, num_classes - 1)
    reg_sel = torch.gather(reg, 2, cls_idx[..., None, None].expand(
        b, r, 1, 4))[:, :, 0]
    reg_l = (reg_sel - targets["reg_targets"]).abs().sum(-1)
    loss_bbox = (reg_l * targets["is_pos"]).sum() / avg
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)
