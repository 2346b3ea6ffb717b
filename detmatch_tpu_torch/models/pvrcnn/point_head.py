"""PointHeadSimple, forward (counterpart of
``detmatch_tpu/models/pvrcnn/point_head.py``; pcdet
``point_head_simple.py``): keypoint foreground logits.

Parameter names ``cls_layers.{0,1,3,4,6}`` as pcdet's ``make_fc_layers``
(Linear, BatchNorm1d, ReLU per hidden layer, then a Linear with bias).
"""
from __future__ import annotations

from torch import nn

from ..layers import bn_pairs, mlp


class PointHeadSimple(nn.Module):
    def __init__(self, input_channels, cls_fc=(256, 256)):
        super().__init__()
        layers, cin = [], input_channels
        for c in cls_fc:
            layers += [nn.Linear(cin, c, bias=False), nn.BatchNorm1d(c),
                       nn.ReLU()]
            cin = c
        layers.append(nn.Linear(cin, 1))
        self.cls_layers = nn.Sequential(*layers)

    def forward(self, point_features, kp_valid):
        """(B, M, C) before-fusion features → (B, M, 1) logits."""
        return self.cls_layers[-1](mlp(bn_pairs(self.cls_layers),
                                       point_features, kp_valid))
