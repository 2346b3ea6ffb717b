"""Part-A2 (counterpart of ``detmatch_tpu/models/pvrcnn/parta2.py``;
pcdet ``PartA2_net.py``, ``point_intra_part_head.py`` and
``partA2_head.py``): the UNet backbone → HeightCompression → BEV →
AnchorHeadSingle, a point head on the UNet's level-1 features (class
scores and intra-object part locations), and a RoI head that pools the
part locations and the point features into 12³ grids per RoI
(``ops.roiaware_pool.roiaware_pool_capped``, average and max), runs two
dense 3D conv towers on them, merges, max-pools 2× and refines.

The point-wise tensors are the fixed-capacity (B, N0, C) buffers on the
level-1 voxel keys; point coordinates are voxel centers. The head's
convs over the pooled grids are dense ``F.conv3d`` with the occupancy
re-applied (JAX's ``Conv3DBlock``, no Pallas kernel there either); the
grids stay NDHWC around them, so the flattened RoI feature has JAX's
(6, 6, 6, C) order.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ...core import geometry, losses
from ...ops.roiaware_pool import roiaware_pool_capped
from ..init import init_like_jax
from ..layers import bn_pairs, masked_bn, mlp
from .roi_head import (decode_roi_boxes, proposal_layer, roi_head_loss,
                       second_stage_rois)
from .second import (PCR, AnchorDetector, DEFAULT_ANCHOR_CONFIGS, TEST_NMS,
                     TRAIN_NMS, check_mode, total)
from .unet import UNetBackbone
from .voxelrcnn import FCHeads
from .vsa import voxel_centers


def mlp_stack(cin, channels):
    """(Linear, BatchNorm1d, ReLU) per layer — JAX's ``MLP`` (eps 1e-3)."""
    layers = []
    for c in channels:
        layers += [nn.Linear(cin, c, bias=False),
                   nn.BatchNorm1d(c, eps=1e-3, momentum=0.01), nn.ReLU()]
        cin = c
    return nn.Sequential(*layers)


def fc_stack(cin, channels, cout):
    """pcdet ``make_fc_layers``: :func:`mlp_stack`, then a Linear with
    bias to ``cout``."""
    return nn.Sequential(*mlp_stack(cin, channels),
                         nn.Linear(channels[-1], cout))


def apply_fc_stack(seq, x, mask=None):
    return seq[-1](mlp(bn_pairs(seq), x, mask))


def point_box_targets(points, valid, gt_boxes, extra_width):
    """Per sample: (labels (N,) int64 1..C inside a gt box (the first
    that holds the point), -1 in the enlarged box or at an invalid
    point, 0 elsewhere; fg (N,) bool; the assigned gt box (N, 8))."""
    gt_cls = gt_boxes[:, 7].to(torch.int64)
    gt_valid = (gt_cls > 0)[:, None]
    in_box = geometry.points_in_boxes(points, gt_boxes[:, :7]) & gt_valid
    in_ext = geometry.points_in_boxes(
        points, geometry.enlarge_boxes(gt_boxes[:, :7], extra_width)
    ) & gt_valid
    fg = in_box.any(0)
    box_idx = torch.argmax(in_box.to(torch.uint8), 0)  # first holding box
    labels = torch.where(fg, gt_cls[box_idx],
                         torch.where(in_ext.any(0) & ~fg, -1, 0))
    return torch.where(valid, labels, -1), fg, gt_boxes[box_idx]


def focal_cls_loss(cls_logits, labels, num_classes):
    """Focal loss over the cared points, normalised by the positives."""
    positives = labels > 0
    pos_norm = torch.clamp(positives.sum().to(torch.float32), min=1.0)
    w = (labels >= 0).to(torch.float32) / pos_norm
    onehot = F.one_hot(torch.clamp(labels, min=0), num_classes + 1)[..., 1:]
    return losses.sigmoid_focal_loss(cls_logits, onehot.to(torch.float32),
                                     w).sum(), positives


class PointIntraPartOffsetHead(nn.Module):
    """Per-point class logits and part locations (canonical in-box
    position in [0, 1]³, BCE over the foreground)."""

    def __init__(self, input_channels, num_classes=3, cls_fc=(128, 128),
                 part_fc=(128, 128), extra_width=(0.2, 0.2, 0.2)):
        super().__init__()
        self.num_classes = num_classes
        self.extra_width = tuple(extra_width)
        self.cls_layers = fc_stack(input_channels, cls_fc, num_classes)
        self.part_reg_layers = fc_stack(input_channels, part_fc, 3)

    def forward(self, point_features, valid):
        return (apply_fc_stack(self.cls_layers, point_features, valid),
                apply_fc_stack(self.part_reg_layers, point_features, valid))

    def targets(self, points, valid, gt_boxes):
        """(labels (B, N), part offsets (B, N, 3))."""
        labels, parts = [], []
        for pts, pv, gb in zip(points, valid, gt_boxes):
            lab, fg, b = point_box_targets(pts, pv, gb, self.extra_width)
            local = geometry.rotate_points_z(
                (pts - b[:, 0:3])[:, None, :], -b[:, 6])[:, 0, :]
            part = torch.clamp(local / torch.clamp(b[:, 3:6], min=1e-4) + 0.5,
                               0.0, 1.0)
            labels.append(lab)
            parts.append(torch.where(fg[:, None], part, 0.0))
        return torch.stack(labels), torch.stack(parts)

    def loss(self, cls_logits, part_reg, labels, part_targets):
        """(focal cls loss, part BCE over the foreground)."""
        cls_loss, positives = focal_cls_loss(cls_logits, labels,
                                             self.num_classes)
        bce = losses.sigmoid_ce_with_logits(part_reg, part_targets)
        pos = positives.to(torch.float32)
        part_loss = ((bce.mean(-1) * pos).sum()
                     / torch.clamp(pos.sum(), min=1.0))
        return cls_loss, part_loss


class Conv3DBlock(nn.Module):
    """Dense 3 × 3 × 3 conv + BN over the occupied cells + ReLU on
    NDHWC grids, 0 in empty cells."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm1d(cout, eps=1e-3, momentum=0.01)

    def forward(self, x, occ):
        y = self.conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        return torch.relu(masked_bn(self.bn, y, occ))


class PartA2Head(FCHeads):
    """PartA2FCHead: RoI-aware average pool of (part location, seg
    score) and max pool of the point features, two conv towers, merge,
    2× max pool, fcs."""

    def __init__(self, point_channels, pool_size=12, num_features=128,
                 max_pts=128, seg_mask_thresh=0.3, shared_fc=(256, 512),
                 cls_fc=(256, 256), reg_fc=(256, 256), dp_ratio=0.3):
        c0 = num_features // 2
        super().__init__((pool_size // 2) ** 3 * 2 * c0, shared_fc, cls_fc,
                         reg_fc, dp_ratio)
        self.pool_size = pool_size
        self.max_pts = max_pts
        self.seg_mask_thresh = seg_mask_thresh
        self.conv_part = nn.ModuleList([Conv3DBlock(4, 64),
                                        Conv3DBlock(64, c0)])
        self.conv_rpn = nn.ModuleList([Conv3DBlock(point_channels, 64),
                                       Conv3DBlock(64, c0)])

    def forward(self, rois, point_coords, point_valid, point_features,
                point_cls_scores, point_part_offset, generator=None):
        b, r = rois.shape[:2]
        g = self.pool_size
        score = point_cls_scores.detach()
        part = torch.where((score >= self.seg_mask_thresh)[..., None],
                           point_part_offset, 0.0)
        part_feats = torch.cat([part, score[..., None]], -1)
        pooled_part = roiaware_pool_capped(rois, point_coords, part_feats,
                                           point_valid, g, self.max_pts,
                                           "avg")
        pooled_rpn = roiaware_pool_capped(rois, point_coords, point_features,
                                          point_valid, g, self.max_pts,
                                          "max")
        occ = (pooled_part != 0.0).any(-1).reshape(b * r, g, g, g)
        xp = pooled_part.reshape(b * r, g, g, g, -1)
        xr = pooled_rpn.reshape(b * r, g, g, g, -1)
        for blk in self.conv_part:
            xp = blk(xp, occ)
        for blk in self.conv_rpn:
            xr = blk(xr, occ)
        merged = torch.cat([xr, xp], -1).permute(0, 4, 1, 2, 3)
        merged = F.max_pool3d(merged, 2, 2).permute(0, 2, 3, 4, 1)
        return super().forward(merged.reshape(b, r, -1), generator)


class PartA2(AnchorDetector):
    def __init__(self, num_classes=3, point_cloud_range=PCR,
                 voxel_size=(0.05, 0.05, 0.1), grid_size=(1408, 1600, 40),
                 anchor_configs=DEFAULT_ANCHOR_CONFIGS,
                 backbone_caps=(24000, 16000, 10000, 10000),
                 train_nms: Dict = None, test_nms: Dict = None,
                 roi_head_cfg: Dict[str, Any] = None):
        super().__init__(num_classes, point_cloud_range, voxel_size,
                         grid_size, anchor_configs, backbone_caps,
                         backbone=UNetBackbone)
        self.train_nms = dict(train_nms or TRAIN_NMS)
        self.test_nms = dict(test_nms or TEST_NMS)
        c1b = self.backbone_3d.channels[1]
        self.point_head = PointIntraPartOffsetHead(c1b,
                                                   num_classes=num_classes)
        self.roi_head = PartA2Head(c1b, **(roi_head_cfg or {}))
        init_like_jax(self)

    def forward(self, batch, train=None, generator=None):
        train = check_mode(self, train, generator)
        out = self.rpn(batch)
        ms = out["backbone"]
        lv1 = ms["x_conv1"]
        out["point_coords"] = voxel_centers(lv1["keys"], lv1["shape"], 1,
                                            self.voxel_size,
                                            self.point_cloud_range)
        out["point_valid"] = lv1["mask"]
        pt_cls, pt_part = self.point_head(ms["point_features"], lv1["mask"])
        out.update(point_cls_logits=pt_cls, point_part_reg=pt_part)
        out["proposals"] = proposal_layer(
            out["batch_box_preds"], out["batch_cls_preds"],
            **(self.train_nms if train else self.test_nms))
        out.update(second_stage_rois(out["proposals"], batch.get("gt_boxes"),
                                     train, generator))
        out["rcnn_cls"], out["rcnn_reg"] = self.roi_head(
            out["rois"], out["point_coords"], lv1["mask"],
            ms["point_features"], torch.sigmoid(pt_cls).amax(-1),
            torch.sigmoid(pt_part), generator)
        out["batch_box_preds_rcnn"] = decode_roi_boxes(out["rois"],
                                                       out["rcnn_reg"])
        return out

    def loss(self, out, batch):
        """rpn + point (cls, part) + rcnn terms."""
        losses_d = self.rpn_loss(out, batch)
        labels, part_t = self.point_head.targets(
            out["point_coords"], out["point_valid"], batch["gt_boxes"])
        losses_d["point_loss_cls"], losses_d["point_loss_part"] = \
            self.point_head.loss(out["point_cls_logits"],
                                 out["point_part_reg"], labels, part_t)
        losses_d.update(roi_head_loss(out["rcnn_cls"], out["rcnn_reg"],
                                      out["roi_targets"]))
        return total(losses_d)
