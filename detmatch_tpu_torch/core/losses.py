"""PV-RCNN loss functions (counterpart of ``detmatch_tpu/core/losses.py``,
the 3D losses; pcdet ``loss_utils.py``). Nothing is reduced here: the
callers mask and normalise, as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import geometry


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
