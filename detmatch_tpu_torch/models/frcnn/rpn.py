"""RPN head, anchors and proposals, the inference half (counterpart of
``detmatch_tpu/models/frcnn/rpn.py``; mmdet ``RPNHead``): anchor scale 8,
ratios (0.5, 1, 2), strides 4-64; proposals are each level's top
``nms_pre`` anchors, decoded, then a level-aware NMS at IoU 0.7 keeps
``max_per_img``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core import nms as nms_mod
from ...core.coders import DeltaXYWHCoder


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
                 num_base_anchors=3):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_base_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_base_anchors * 4, 1)

    def forward(self, feats):
        """NCHW levels → per level (cls (B, H, W, A), reg (B, H, W, 4A)),
        channels last as the anchors are laid out."""
        outs = []
        for f in feats:
            x = F.relu(self.rpn_conv(f))
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
