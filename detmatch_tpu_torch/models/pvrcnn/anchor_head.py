"""AnchorHeadSingle, inference half (counterpart of
``detmatch_tpu/models/pvrcnn/anchor_head.py``; pcdet
``anchor_head_single.py``): dense anchors, 1×1 conv predictions and the
box decode with the direction-classifier snap.

Per-anchor outputs are flat in (H, W, class, rotation) order, as the JAX
head and pcdet (conv output permuted to NHWC before the reshape).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core import geometry
from ...core.coders import ResidualCoder


def generate_anchors(point_cloud_range, grid_size, anchor_configs):
    """(H*W*C*R, 7) float32 numpy anchors in the head's flat order
    (non-aligned centers spanning the range with stride range/(n-1)),
    computed with the same float32 steps as the JAX reference."""
    pcr = np.asarray(point_cloud_range, np.float32)
    strides = {cfg.get("feature_map_stride", 8) for cfg in anchor_configs}
    if len(strides) != 1:
        raise ValueError("anchors assume one feature-map stride")
    stride = strides.pop()
    nx = int(grid_size[0] // stride)
    ny = int(grid_size[1] // stride)
    rots = anchor_configs[0]["anchor_rotations"]
    for cfg in anchor_configs:
        if tuple(cfg["anchor_rotations"]) != tuple(rots):
            raise ValueError("anchors assume one rotation set")
        if cfg.get("align_center", False):
            raise ValueError("align_center anchors are not supported")
    c, r = len(anchor_configs), len(rots)
    xs = pcr[0] + np.arange(nx, dtype=np.float32) * (
        (pcr[3] - pcr[0]) / (nx - 1))
    ys = pcr[1] + np.arange(ny, dtype=np.float32) * (
        (pcr[4] - pcr[1]) / (ny - 1))
    sizes = np.asarray([cfg["anchor_sizes"][0] for cfg in anchor_configs],
                       np.float32)
    zc = np.asarray([cfg["anchor_bottom_heights"][0] + s[2] / 2.0
                     for cfg, s in zip(anchor_configs, sizes)], np.float32)
    a = np.empty((ny, nx, c, r, 7), np.float32)
    a[..., 0] = xs[None, :, None, None]
    a[..., 1] = ys[:, None, None, None]
    a[..., 2] = zc[None, None, :, None]
    a[..., 3:6] = sizes[None, None, :, None, :]
    a[..., 6] = np.asarray(rots, np.float32)
    return a.reshape(-1, 7)


class AnchorHeadSingle(nn.Module):
    def __init__(self, input_channels, num_classes=3, anchor_configs=(),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1),
                 grid_size=(1408, 1600, 40), num_dir_bins=2,
                 dir_offset=0.78539, dir_limit_offset=0.0):
        super().__init__()
        self.num_classes = num_classes
        self.num_dir_bins = num_dir_bins
        self.dir_offset = dir_offset
        self.dir_limit_offset = dir_limit_offset
        self.coder = ResidualCoder()
        anchors = generate_anchors(point_cloud_range, grid_size,
                                   list(anchor_configs))
        self.register_buffer("anchors", torch.from_numpy(anchors),
                             persistent=False)
        na = len(anchor_configs) * len(anchor_configs[0]["anchor_rotations"])
        self.conv_cls = nn.Conv2d(input_channels, na * num_classes, 1)
        self.conv_box = nn.Conv2d(input_channels, na * self.coder.code_size,
                                  1)
        self.conv_dir_cls = nn.Conv2d(input_channels, na * num_dir_bins, 1)
        nn.init.constant_(self.conv_cls.bias, -np.log((1 - 0.01) / 0.01))
        nn.init.normal_(self.conv_box.weight, std=0.001)

    def forward(self, bev_features):
        """(B, C, H, W) → dict of flat per-anchor predictions."""
        b = bev_features.shape[0]

        def flat(conv, width):
            return conv(bev_features).permute(0, 2, 3, 1).reshape(b, -1,
                                                                  width)

        return dict(cls_preds=flat(self.conv_cls, self.num_classes),
                    box_preds=flat(self.conv_box, self.coder.code_size),
                    dir_preds=flat(self.conv_dir_cls, self.num_dir_bins))

    def decode_boxes(self, preds):
        """Decode every anchor and snap the heading to the direction bin.

        Returns (batch_box_preds (B, A, 7), batch_cls_preds (B, A, C))."""
        boxes = self.coder.decode(preds["box_preds"], self.anchors[None])
        dir_labels = torch.argmax(preds["dir_preds"], dim=-1)
        period = 2 * np.pi / self.num_dir_bins
        dir_rot = geometry.limit_period(boxes[..., 6] - self.dir_offset,
                                        self.dir_limit_offset, period)
        heading = (dir_rot + self.dir_offset
                   + period * dir_labels.to(boxes.dtype))
        return (torch.cat([boxes[..., :6], heading[..., None]], dim=-1),
                preds["cls_preds"])
