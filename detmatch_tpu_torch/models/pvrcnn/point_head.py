"""PointHeadSimple (counterpart of
``detmatch_tpu/models/pvrcnn/point_head.py``; pcdet
``point_head_simple.py`` and ``point_head_template.py``): keypoint
foreground logits, and for training the point-in-box targets and the
focal loss.

Parameter names ``cls_layers.{0,1,3,4,6}`` as pcdet's ``make_fc_layers``
(Linear, BatchNorm1d, ReLU per hidden layer, then a Linear with bias).
"""
from __future__ import annotations

import torch
from torch import nn

from ...core import geometry, losses
from ...parallel import global_sum
from ..layers import bn_pairs, mlp


class PointHeadSimple(nn.Module):
    def __init__(self, input_channels, cls_fc=(256, 256),
                 extra_width=(0.2, 0.2, 0.2)):
        super().__init__()
        self.extra_width = tuple(extra_width)
        layers, cin = [], input_channels
        for c in cls_fc:
            layers += [nn.Linear(cin, c, bias=False),
                       nn.BatchNorm1d(c, momentum=0.01), nn.ReLU()]
            cin = c
        layers.append(nn.Linear(cin, 1))
        self.cls_layers = nn.Sequential(*layers)

    def forward(self, point_features, kp_valid):
        """(B, M, C) before-fusion features → (B, M, 1) logits."""
        return self.cls_layers[-1](mlp(bn_pairs(self.cls_layers),
                                       point_features, kp_valid))

    def targets(self, keypoints, kp_valid, gt_boxes):
        """(B, M) float targets: 1 inside a gt box, -1 (ignored) inside
        the box enlarged by ``extra_width`` but outside the box or at an
        invalid keypoint, 0 elsewhere."""
        out = []
        for kp, kpv, gb in zip(keypoints, kp_valid, gt_boxes):
            valid_gt = (gb[:, 7] > 0)[:, None]
            in_box = geometry.points_in_boxes(kp, gb[:, :7]) & valid_gt
            enlarged = geometry.enlarge_boxes(gb[:, :7], self.extra_width)
            in_ext = geometry.points_in_boxes(kp, enlarged) & valid_gt
            fg = in_box.any(dim=0)
            ign = in_ext.any(dim=0) & ~fg
            t = torch.where(fg, 1.0, torch.where(ign, -1.0, 0.0))
            out.append(torch.where(kpv, t, -1.0))
        return torch.stack(out)

    @staticmethod
    def loss_terms(logits, targets):
        """Per-sample (focal-loss sum, positive count), each (B,)."""
        positives = targets > 0
        cared = (targets >= 0).to(torch.float32)
        raw = losses.sigmoid_focal_loss(
            logits, positives.to(torch.float32)[..., None], cared)
        return raw.sum(dim=(1, 2)), positives.to(torch.float32).sum(dim=1)

    @staticmethod
    def loss(logits, targets, weight=1.0):
        """Focal loss normalised by the global batch's positive count."""
        numer, pos = PointHeadSimple.loss_terms(logits, targets)
        return (numer.sum() / torch.clamp(global_sum(pos.sum()), min=1.0)
                * weight)
