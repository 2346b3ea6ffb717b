"""RPN head, anchors, proposals and the training targets and loss
(counterpart of ``detmatch_tpu/models/frcnn/rpn.py``; mmdet ``RPNHead``,
``MaxIoUAssigner``, ``RandomSampler``): anchor scale 8, ratios
(0.5, 1, 2), strides 4-64; proposals are each level's top ``nms_pre``
anchors, decoded, then a level-aware NMS at IoU 0.7 keeps
``max_per_img``. Training assigns anchors at IoU 0.7 / 0.3 with
low-quality matches, samples 256 anchors (half positive at most) and
takes sigmoid BCE on their objectness and L1 on the positives' deltas.

Sampling draws its random numbers through :func:`sample_uniforms` from a
``torch.Generator``; the tests replace that function to hand over the
JAX package's draws. Under several processes the draws are made for
every global image, in global order, each process keeping its own, and
the batch mean is over the global batch (``parallel``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core import iou as iou_mod, losses, nms as nms_mod
from ...core.coders import DeltaXYWHCoder
from ...parallel import for_each_global_row, global_count
from ..layers import conv


def base_anchors(stride, scales=(8,), ratios=(0.5, 1.0, 2.0)):
    """mmdet ``AnchorGenerator`` base anchors (center offset 0), (A0, 4)."""
    out = []
    for r in ratios:
        for s in scales:
            h = stride * s * np.sqrt(r)
            w = stride * s * np.sqrt(1.0 / r)
            out.append([-w / 2, -h / 2, w / 2, h / 2])
    return np.asarray(out, np.float32)


def grid_anchors(feat_h, feat_w, stride, scales=(8,),
                 ratios=(0.5, 1.0, 2.0)):
    """(feat_h * feat_w * A0, 4) anchors of one level, (H, W, A0) order."""
    base = base_anchors(stride, scales, ratios)
    xs = np.arange(feat_w, dtype=np.float32) * stride
    ys = np.arange(feat_h, dtype=np.float32) * stride
    shift = np.stack(np.meshgrid(xs, ys), axis=-1)
    shift = np.concatenate([shift, shift], axis=-1)
    return (shift[:, :, None, :] + base[None, None, :, :]).reshape(-1, 4)


class RPNHead(nn.Module):
    """3x3 conv + ReLU shared over the levels, then 1x1 convs to A
    objectness logits and A * 4 deltas."""

    def __init__(self, in_channels=256, feat_channels=256,
                 num_base_anchors=3, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_base_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_base_anchors * 4, 1)

    def forward(self, feats):
        """NCHW levels → per level (cls (B, H, W, A), reg (B, H, W, 4A)),
        channels last as the anchors are laid out. The shared conv runs
        in ``dtype``, the two heads in float32 (JAX ``rpn.py:113-128``)."""
        outs = []
        for f in feats:
            x = F.relu(conv(self.rpn_conv, f, self.dtype)).float()
            outs.append((self.rpn_cls(x).permute(0, 2, 3, 1),
                         self.rpn_reg(x).permute(0, 2, 3, 1)))
        return outs


def rpn_proposals(rpn_outs, anchors_per_level, img_shape, nms_pre,
                  max_per_img, iou_thr=0.7):
    """Proposals of ONE image.

    Args:
        rpn_outs: per level (cls (H, W, A), reg (H, W, 4A)).
        anchors_per_level: per level (N_l, 4).
        img_shape: (2,) tensor (h, w) for clipping.
    Returns:
        (proposals (max_per_img, 4), scores (max_per_img,) NEG_INF
        padded).
    """
    coder = DeltaXYWHCoder()
    boxes, scores, ids = [], [], []
    for lvl, ((cls, reg), anchors) in enumerate(zip(rpn_outs,
                                                    anchors_per_level)):
        s = torch.sigmoid(cls.reshape(-1))
        deltas = reg.reshape(-1, 4)
        k = min(nms_pre, s.shape[0])
        # top-k with ties to the lower index, as jax.lax.top_k
        top_s, top_i = torch.sort(s, descending=True, stable=True)
        top_s, top_i = top_s[:k], top_i[:k]
        boxes.append(coder.decode(anchors[top_i], deltas[top_i],
                                  max_shape=img_shape))
        scores.append(top_s)
        ids.append(torch.full((k,), lvl, dtype=torch.int32,
                              device=s.device))
    boxes, scores, ids = torch.cat(boxes), torch.cat(scores), torch.cat(ids)
    idx, valid = nms_mod.batched_nms_2d(
        boxes, torch.where(scores > 0, scores, nms_mod.NEG_INF), ids,
        iou_thr, max_per_img)
    idx = idx.long()
    props = torch.where(valid[:, None], boxes[idx], 0.0)
    pscores = torch.where(valid, scores[idx], nms_mod.NEG_INF)
    return props, pscores


def max_iou_assign(boxes, valid, gt_boxes, gt_valid, pos_thr, neg_thr,
                   min_pos_iou, match_low_quality):
    """mmdet ``MaxIoUAssigner``, vectorised, on IoUs snapped to a 2^-20
    grid (``iou.quantize``) so that the force-match ``==`` and the argmax
    ties do not depend on last-ulp noise.

    Args:
        boxes: (N, 4) xyxy; valid: (N,); gt_boxes: (G, 4); gt_valid: (G,).
    Returns:
        (assigned (N,) int64: -1 ignore / 0 background / 1-based gt,
        max_iou (N,), argmax (N,)).
    """
    ious = iou_mod.quantize(iou_mod.iou2d(boxes, gt_boxes))
    ious = torch.where(gt_valid[None, :], ious, -1.0)
    ious = torch.where(valid[:, None], ious, -1.0)
    max_iou = ious.amax(1)
    argmax = torch.argmax(ious, 1)
    assigned = torch.full_like(argmax, -1)
    assigned = torch.where((max_iou >= 0) & (max_iou < neg_thr), 0, assigned)
    assigned = torch.where(max_iou >= pos_thr, argmax + 1, assigned)
    if match_low_quality:
        gt_max = ious.amax(0)
        force = ((ious == gt_max[None, :]) & (gt_max[None, :] >= min_pos_iou)
                 & gt_valid[None, :])
        force_gt = torch.argmax(force.to(torch.uint8), 1)
        assigned = torch.where(force.any(1), force_gt + 1, assigned)
    return torch.where(valid, assigned, -1), max_iou, argmax


def sample_uniforms(generator, n, device):
    """The two (n,) uniform draws of one :func:`random_sample` call."""
    return (torch.rand(n, generator=generator, device=device),
            torch.rand(n, generator=generator, device=device))


def random_sample(generator, assigned, num, pos_fraction):
    """mmdet ``RandomSampler`` without replacement, static shape: up to
    ``num * pos_fraction`` positives in a random order, then negatives.

    Returns:
        (idx (num,) int64, is_pos (num,), slot_valid (num,)).
    """
    n = assigned.shape[0]
    dev = assigned.device
    r1, r2 = sample_uniforms(generator, n, dev)
    pos_mask, neg_mask = assigned > 0, assigned == 0
    pos_order = torch.argsort(torch.where(pos_mask, r1, 2.0), stable=True)
    neg_order = torch.argsort(torch.where(neg_mask, r2, 2.0), stable=True)
    pos_take = torch.clamp(pos_mask.sum(), max=int(num * pos_fraction))
    neg_take = torch.minimum(num - pos_take, neg_mask.sum())
    slots = torch.arange(num, device=dev)
    is_pos = slots < pos_take
    idx = torch.where(is_pos, pos_order[torch.clamp(slots, max=n - 1)],
                      neg_order[torch.clamp(slots - pos_take, 0, n - 1)])
    slot_valid = slots < pos_take + neg_take
    return idx, is_pos & slot_valid, slot_valid


def rpn_loss(generator, rpn_outs, anchors_per_level, gt_boxes, gt_valid,
             num_samples=256, pos_fraction=0.5):
    """RPN training loss of a batch: per image, sigmoid BCE over the
    sampled anchors and L1 over the positives' deltas, both divided by
    the sample count; then the mean over the global batch (the samples
    of another process's images drawn and dropped).

    Args:
        rpn_outs: per level (cls (B, H, W, A), reg (B, H, W, 4A)).
        gt_boxes: (B, G, 4); gt_valid: (B, G).
    """
    coder = DeltaXYWHCoder()
    b = gt_boxes.shape[0]
    cls_flat = torch.cat([c.reshape(b, -1) for c, _ in rpn_outs], 1)
    reg_flat = torch.cat([r.reshape(b, -1, 4) for _, r in rpn_outs], 1)
    anchors = torch.cat(list(anchors_per_level), 0)
    valid = torch.ones(anchors.shape[0], dtype=torch.bool,
                       device=anchors.device)

    @torch.no_grad()
    def sample(i):
        gb = gt_boxes[i]
        assigned, _, _ = max_iou_assign(anchors, valid, gb, gt_valid[i], 0.7,
                                        0.3, 0.3, True)
        idx, is_pos, slot_valid = random_sample(generator, assigned,
                                                num_samples, pos_fraction)
        gt_idx = torch.clamp(assigned[idx] - 1, 0, gb.shape[0] - 1)
        return idx, is_pos, slot_valid, coder.encode(anchors[idx], gb[gt_idx])

    cls_losses, reg_losses = [], []
    for cls, reg, (idx, is_pos, slot_valid, reg_t) in zip(
            cls_flat, reg_flat, for_each_global_row(b, sample)):
        n_total = torch.clamp(slot_valid.sum().to(torch.float32), min=1.0)
        cls_l = losses.sigmoid_ce_with_logits(cls[idx],
                                              is_pos.to(torch.float32))
        cls_losses.append((cls_l * slot_valid).sum() / n_total)
        reg_l = (reg[idx] - reg_t).abs().sum(-1)
        reg_losses.append((reg_l * is_pos).sum() / n_total)
    n = global_count(b)
    return dict(loss_rpn_cls=torch.stack(cls_losses).sum() / n,
                loss_rpn_bbox=torch.stack(reg_losses).sum() / n)
