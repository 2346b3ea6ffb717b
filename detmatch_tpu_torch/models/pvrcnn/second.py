"""SECOND and SECOND-IoU (counterpart of
``detmatch_tpu/models/pvrcnn/second.py``; pcdet ``second_net.py``,
``second_net_iou.py`` and ``second_head.py``): MeanVFE → VoxelBackbone8x
→ HeightCompression → BaseBEVBackbone → AnchorHeadSingle, and for
SECOND-IoU a RoI head that pools a 7 × 7 BEV grid over each proposal and
predicts its IoU (the boxes are not re-regressed).

:class:`AnchorDetector` is the one-stage stack that the zoo's voxel
detectors share (submodule names pcdet's: ``backbone_3d``,
``backbone_2d``, ``dense_head``). Every sparse conv runs through
``self.ops`` (the CUDA kernels; ``ops.cuda.PLAIN`` for verification).
Batch format as PV-RCNN's: voxel_features (B, V, 4), voxel_keys (B, V)
and for training gt_boxes (B, G, 8).

SECOND-IoU's ``voxel_size`` defaults to pcdet's (0.05, 0.05, 0.1)
(``second_iou.yaml``); the JAX default (0.5, 0.5, 0.1) would put the RoI
head's BEV cell at 4 m where the BEV map's is 0.4 m.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ...ops.cuda import KERNELS
from ..init import init_like_jax
from .anchor_head import AnchorHeadSingle
from .backbone3d import VoxelBackbone8x, level_shapes
from .bev import BaseBEVBackbone, height_compression
from .roi_head import (_apply_fc, _fc_layers, proposal_layer,
                       second_stage_rois)
from .pvrcnn import (DEFAULT_ANCHOR_CONFIGS, TEST_NMS, TRAIN_NMS,
                     nms_detections)
from .vsa import bilinear_interpolate_batched

PCR = (0, -40, -3, 70.4, 40, 1)


def check_mode(model, train, generator, needs_generator=True):
    """The forward's ``train`` (``model.training`` if None), checked
    against the module mode; a two-stage train forward needs a
    ``torch.Generator`` for its RoI picks and dropout masks."""
    train = model.training if train is None else train
    if train != model.training:
        raise ValueError(f"forward(train={train}) on a model in "
                         f"{'train' if model.training else 'eval'} mode: "
                         "call model.train() or model.eval()")
    if train and needs_generator and generator is None:
        raise ValueError("a train forward needs a torch.Generator")
    return train


class AnchorDetector(nn.Module):
    """The sparse backbone → BEV → anchor-head stack. ``backbone`` builds
    the 3D backbone from (spatial_shape, input_channels, caps)."""

    def __init__(self, num_classes=3, point_cloud_range=PCR,
                 voxel_size=(0.05, 0.05, 0.1), grid_size=(1408, 1600, 40),
                 anchor_configs=DEFAULT_ANCHOR_CONFIGS,
                 backbone_caps=(24000, 16000, 10000, 10000),
                 num_point_features=4, backbone=VoxelBackbone8x):
        super().__init__()
        self.ops = KERNELS
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        spatial_shape = (grid_size[2] + 1, grid_size[1], grid_size[0])
        self.backbone_3d = backbone(spatial_shape,
                                    input_channels=num_point_features,
                                    caps=backbone_caps)
        hc_z = level_shapes(spatial_shape)[-1][0]
        self.backbone_2d = BaseBEVBackbone(
            hc_z * self.backbone_3d.out_channels)
        self.dense_head = AnchorHeadSingle(
            self.backbone_2d.num_bev_features, num_classes=num_classes,
            anchor_configs=anchor_configs,
            point_cloud_range=point_cloud_range, grid_size=grid_size)

    def rpn(self, batch):
        """Backbone, BEV and dense head: the forward's first-stage
        outputs (``backbone`` the sparse levels, ``bev_features``
        (B, C, H, W), ``head_preds``, the decoded ``batch_box_preds``
        (B, A, 7) and ``batch_cls_preds`` (B, A, C) logits)."""
        ms = self.backbone_3d(batch["voxel_features"], batch["voxel_keys"],
                              self.ops)
        bev = self.backbone_2d(height_compression(ms["out"]))
        head_preds = self.dense_head(bev)
        boxes, cls = self.dense_head.decode_boxes(head_preds)
        return dict(backbone=ms, bev_features=bev, head_preds=head_preds,
                    batch_box_preds=boxes, batch_cls_preds=cls)

    def rpn_loss(self, out, batch):
        return self.dense_head.loss(
            out["head_preds"], self.dense_head.targets(batch["gt_boxes"]))


def total(losses):
    """``losses`` with their sum under ``loss``."""
    losses["loss"] = sum(losses.values())
    return losses


class SECOND(AnchorDetector):
    """One-stage SECOND; the forward's ``train`` as PV-RCNN's (batch
    norm follows the module mode)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        init_like_jax(self)

    def forward(self, batch, train=None, generator=None):
        check_mode(self, train, generator, needs_generator=False)
        return self.rpn(batch)

    def loss(self, out, batch):
        return total(self.rpn_loss(out, batch))


class SECONDHead(nn.Module):
    """IoU head of SECOND-IoU: a g × g grid over each RoI's rotated BEV
    footprint, bilinearly sampled from the stride-8 BEV map, flattened
    (g², C) cell-major as JAX's, shared fcs, then a one-output IoU
    stack. Dropout after every shared fc but the last and after the IoU
    stack's first, as JAX's (a rate of 0 draws no mask)."""

    def __init__(self, input_channels, grid_size=7, shared_fc=(256, 256),
                 iou_fc=(256, 256), dp_ratio=0.3, point_cloud_range=PCR,
                 voxel_size=(0.05, 0.05, 0.1), feature_stride=8):
        super().__init__()
        self.grid_size = grid_size
        self.point_cloud_range = tuple(point_cloud_range)
        self.cell = (voxel_size[0] * feature_stride,
                     voxel_size[1] * feature_stride)
        layers, c = _fc_layers(
            grid_size ** 2 * input_channels, shared_fc,
            lambda k: k != len(shared_fc) - 1, dp_ratio, eps=1e-3)
        self.shared_fc_layer = nn.Sequential(*layers)
        layers, c = _fc_layers(c, iou_fc, lambda k: k == 0, dp_ratio,
                               eps=1e-3)
        layers.append(nn.Conv1d(c, 1, 1, bias=True))
        self.iou_layers = nn.Sequential(*layers)

    def grid_points(self, rois):
        """(B, R, 7) → BEV pixel coords (fx, fy), each (B, R * g²)."""
        b, g = rois.shape[0], self.grid_size
        ar = torch.arange(g, dtype=torch.float32, device=rois.device)
        gx, gy = torch.meshgrid(ar, ar, indexing="ij")
        cell = torch.stack([gx, gy], -1).reshape(-1, 2)
        local = ((cell[None, None] + 0.5) / g - 0.5) * rois[..., None, 3:5]
        c = torch.cos(rois[..., 6])[..., None]
        s = torch.sin(rois[..., 6])[..., None]
        wx = local[..., 0] * c - local[..., 1] * s + rois[..., None, 0]
        wy = local[..., 0] * s + local[..., 1] * c + rois[..., None, 1]
        fx = (wx - self.point_cloud_range[0]) / self.cell[0]
        fy = (wy - self.point_cloud_range[1]) / self.cell[1]
        return fx.reshape(b, -1), fy.reshape(b, -1)

    def forward(self, rois, bev_features, generator=None):
        """rois (B, R, 7), bev_features (B, C, H, W) → IoU logits
        (B, R, 1)."""
        b, r = rois.shape[:2]
        fx, fy = self.grid_points(rois)
        pooled = bilinear_interpolate_batched(
            bev_features.permute(0, 2, 3, 1), fx, fy)
        x = _apply_fc(self.shared_fc_layer, pooled.reshape(b, r, -1),
                      generator)
        return _apply_fc(self.iou_layers, x, generator)


class SECONDIoU(AnchorDetector):
    """SECOND + :class:`SECONDHead`. Eval: ``rcnn_cls`` is the IoU logit
    that ``pvrcnn.post_processing`` scores, ``batch_box_preds_rcnn`` the
    RoIs themselves."""

    def __init__(self, num_classes=3, point_cloud_range=PCR,
                 voxel_size=(0.05, 0.05, 0.1), grid_size=(1408, 1600, 40),
                 anchor_configs=DEFAULT_ANCHOR_CONFIGS,
                 backbone_caps=(24000, 16000, 10000, 10000),
                 train_nms: Dict = None, test_nms: Dict = None,
                 roi_head_cfg: Dict[str, Any] = None):
        super().__init__(num_classes, point_cloud_range, voxel_size,
                         grid_size, anchor_configs, backbone_caps)
        self.train_nms = dict(train_nms or TRAIN_NMS)
        self.test_nms = dict(test_nms or TEST_NMS)
        self.roi_head = SECONDHead(
            self.backbone_2d.num_bev_features,
            point_cloud_range=point_cloud_range, voxel_size=voxel_size,
            **(roi_head_cfg or {}))
        init_like_jax(self)

    def forward(self, batch, train=None, generator=None):
        train = check_mode(self, train, generator)
        out = self.rpn(batch)
        out["proposals"] = proposal_layer(
            out["batch_box_preds"], out["batch_cls_preds"],
            **(self.train_nms if train else self.test_nms))
        out.update(second_stage_rois(out["proposals"], batch.get("gt_boxes"),
                                     train, generator))
        out["rcnn_iou"] = self.roi_head(out["rois"], out["bev_features"],
                                        generator)
        out["rcnn_cls"] = out["rcnn_iou"]
        out["batch_box_preds_rcnn"] = out["rois"]
        return out

    def loss(self, out, batch):
        """Anchor-head terms + BCE of the predicted IoU against the
        sampled RoIs' soft labels."""
        losses = self.rpn_loss(out, batch)
        labels = out["roi_targets"]["rcnn_cls_labels"]
        valid = (labels >= 0).to(torch.float32)
        p = torch.sigmoid(out["rcnn_iou"][..., 0])
        eps = 1e-7
        bce = -(labels * torch.log(torch.clamp(p, eps, 1.0))
                + (1 - labels) * torch.log(torch.clamp(1 - p, eps, 1.0)))
        losses["rcnn_loss_iou"] = ((bce * valid).sum()
                                   / torch.clamp(valid.sum(), min=1.0))
        return total(losses)


def second_post_processing(out, nms_pre=4096, nms_post=500, nms_thresh=0.01,
                           score_thresh=0.1):
    """One-stage post-processing: sigmoid class scores, class-agnostic
    NMS (``pvrcnn.nms_detections``) → ``pvrcnn.post_processing``'s
    dict."""
    probs = torch.sigmoid(out["batch_cls_preds"])
    scores, labels = probs.max(dim=-1)
    return nms_detections(out["batch_box_preds"], scores,
                          labels.to(torch.int32) + 1, probs, nms_pre,
                          nms_post, nms_thresh, score_thresh)
