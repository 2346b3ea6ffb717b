"""PV-RCNN loss functions and the DETR-style match costs of the fusion
matching (counterpart of ``detmatch_tpu/core/losses.py``; pcdet
``loss_utils.py``, mmdet ``match_cost.py``). Nothing is reduced here: the
callers mask and normalise, as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry, iou as iou_mod
from .coders import cxcywh_to_xyxy


def sigmoid_ce_with_logits(logits, targets):
    """Numerically stable sigmoid binary cross entropy."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def sigmoid_focal_loss(logits, targets, weights, gamma=2.0, alpha=0.25):
    """pcdet SigmoidFocalClassificationLoss.

    Args:
        logits, targets: (..., C), one-hot targets; weights: (...).
    Returns:
        unreduced (..., C).
    """
    p = torch.sigmoid(logits)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1.0 - p) + (1.0 - targets) * p
    focal_w = alpha_w * torch.pow(pt, gamma)
    return focal_w * sigmoid_ce_with_logits(logits, targets) * weights[..., None]


def smooth_l1(diff, beta):
    if beta < 1e-5:
        return torch.abs(diff)
    n = torch.abs(diff)
    return torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)


def weighted_smooth_l1(pred, target, weights=None, beta=1.0 / 9.0,
                       code_weights=None):
    """pcdet WeightedSmoothL1Loss; nan targets are ignored. Returns
    unreduced (..., #codes)."""
    target = torch.where(torch.isnan(target), pred, target)
    diff = pred - target
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype,
                                      device=diff.device)
    loss = smooth_l1(diff, beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_cross_entropy(logits, targets_onehot, weights):
    """pcdet WeightedCrossEntropyLoss: (..., C) logits → (...)."""
    target = torch.argmax(targets_onehot, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, target[..., None])[..., 0] * weights


def corner_loss_lidar(pred_boxes, gt_boxes):
    """Heading-flip-invariant corner smooth-L1 (beta 1), (N, 7) each →
    (N,)."""
    pred_c = geometry.boxes_to_corners_3d(pred_boxes)
    gt_c = geometry.boxes_to_corners_3d(gt_boxes)
    gt_flip = torch.cat([gt_boxes[:, :6], gt_boxes[:, 6:7] + np.pi], dim=-1)
    gt_c_flip = geometry.boxes_to_corners_3d(gt_flip)
    d = torch.linalg.norm(pred_c - gt_c, dim=2)
    d_flip = torch.linalg.norm(pred_c - gt_c_flip, dim=2)
    return smooth_l1(torch.minimum(d, d_flip), 1.0).mean(dim=1)


# ---- match costs (FusionHungarianMatching) ----

def focal_loss_cost(logits, labels, weight=1.0, alpha=0.25, gamma=2.0,
                    eps=1e-12):
    """mmdet ``FocalLossCost``: (N, C) logits × (M,) labels → (N, M)."""
    p = torch.sigmoid(logits)
    neg = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    return (pos[:, labels] - neg[:, labels]) * weight


def double_sided_focal_cost(logits1, logits2, weight=1.0, alpha=0.25,
                            gamma=2.0):
    """(FL(p1, argmax p2) + FL(p2, argmax p1)^T) / 2 → (N1, N2)
    (DetMatch ``modified_match_cost.py``); argmax takes the first
    maximum."""
    lbl1 = torch.argmax(torch.sigmoid(logits1), dim=1)
    lbl2 = torch.argmax(torch.sigmoid(logits2), dim=1)
    c12 = focal_loss_cost(logits1, lbl2, weight, alpha, gamma)
    c21 = focal_loss_cost(logits2, lbl1, weight, alpha, gamma)
    return (c12 + c21.T) / 2.0


def bbox_l1_cost(pred_cxcywh_norm, gt_xyxy_norm, weight=1.0):
    """mmdet ``BBoxL1Cost`` (box_format xyxy): L1 distance of the
    normalised predictions, as xyxy, to the normalised targets → (N, M)."""
    pred = cxcywh_to_xyxy(pred_cxcywh_norm)
    return (pred[:, None, :] - gt_xyxy_norm[None, :, :]).abs().sum(-1) \
        * weight


def giou_cost(pred_xyxy, gt_xyxy, weight=1.0):
    """mmdet ``IoUCost(iou_mode="giou")``: -GIoU → (N, M)."""
    return -iou_mod.iou2d(pred_xyxy, gt_xyxy, mode="giou") * weight
