"""Voxel R-CNN (counterpart of ``detmatch_tpu/models/pvrcnn/voxelrcnn.py``;
pcdet ``voxel_rcnn.py`` and ``voxelrcnn_head.py``): the SECOND stack,
then a second stage that pools 6³ RoI-grid points straight from the
sparse levels x_conv2/3/4 (no keypoints).

pcdet's ``voxel_query`` (a hash lookup of nearby voxels) becomes, as in
JAX, a ball query (kernel K2) over each level's voxel centers: one y-sort
and packed table a level, radii 0.4 / 0.8 / 1.6 m, 16 neighbours. The
grouped MLP is the VSA's :func:`~.vsa.group_mlp` and an empty ball pools
to 0 in train and eval mode alike.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ...ops import pointnet
from ...ops.cuda import KERNELS
from ...ops.cuda.ball_query import pack_table, sort_points_by_y
from ..init import init_like_jax
from ..layers import bn_pairs
from .roi_head import (_apply_fc, _fc_layers, decode_roi_boxes,
                       proposal_layer, roi_grid_points, roi_head_loss,
                       second_stage_rois)
from .second import (PCR, AnchorDetector, DEFAULT_ANCHOR_CONFIGS, TEST_NMS,
                     TRAIN_NMS, check_mode, total)
from .vsa import StackSAModuleMSG, group_mlp, voxel_centers


class FCHeads(nn.Module):
    """The zoo's RoI fc stacks over a flat per-RoI feature:
    ``shared_fc_layer`` (dropout after every layer but the last), then
    ``cls_layers`` → 1 and ``reg_layers`` → 7 (dropout after their first
    layer), batch norm eps 1e-3 as JAX's; a rate of 0 draws no mask."""

    def __init__(self, cin, shared_fc=(256, 256), cls_fc=(256, 256),
                 reg_fc=(256, 256), dp_ratio=0.3):
        super().__init__()
        layers, c = _fc_layers(
            cin, shared_fc, lambda k: k != len(shared_fc) - 1, dp_ratio,
            eps=1e-3)
        self.shared_fc_layer = nn.Sequential(*layers)
        for name, fcs, out in (("cls_layers", cls_fc, 1),
                               ("reg_layers", reg_fc, 7)):
            layers, cin_ = _fc_layers(c, fcs, lambda k: k == 0, dp_ratio,
                                      eps=1e-3)
            layers.append(nn.Conv1d(cin_, out, 1, bias=True))
            setattr(self, name, nn.Sequential(*layers))

    def init_explicit(self):
        """JAX's N(0, 0.001) weights of the box regressor's output
        layer (the class output keeps flax's LeCun default)."""
        nn.init.normal_(self.reg_layers[-1].weight, std=0.001)

    def forward(self, x, generator=None):
        """(B, R, C) → (rcnn_cls (B, R, 1), rcnn_reg (B, R, 7))."""
        shared = _apply_fc(self.shared_fc_layer, x, generator)
        return tuple(_apply_fc(seq, shared, generator)
                     for seq in (self.cls_layers, self.reg_layers))


class VoxelRCNNHead(FCHeads):
    """RoI-grid pooling from the sparse levels (pcdet
    ``voxel_rcnn_car.yaml``: x_conv2/3/4, radii 0.4/0.8/1.6, nsample 16,
    MLPs [32, 32], grid 6); the pooled (R, G³, C) grid is flattened
    G³-major, as JAX's."""

    def __init__(self, level_channels, grid_size=6,
                 features=("x_conv2", "x_conv3", "x_conv4"),
                 pool_radii=(0.4, 0.8, 1.6), pool_nsamples=(16, 16, 16),
                 pool_mlps=((32, 32), (32, 32), (32, 32)),
                 shared_fc=(256, 256), cls_fc=(256, 256), reg_fc=(256, 256),
                 dp_ratio=0.3, voxel_size=(0.05, 0.05, 0.1),
                 point_cloud_range=PCR):
        pools = [StackSAModuleMSG((r,), (ns,), (mlp,), level_channels[f])
                 for f, r, ns, mlp in zip(features, pool_radii,
                                          pool_nsamples, pool_mlps)]
        super().__init__(grid_size ** 3 * sum(p.out_channels for p in pools),
                         shared_fc, cls_fc, reg_fc, dp_ratio)
        self.grid_size = grid_size
        self.features = tuple(features)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.roi_grid_pool_layers = nn.ModuleList(pools)

    def forward(self, rois, ms, ops=KERNELS, generator=None):
        b, r = rois.shape[:2]
        grid = roi_grid_points(rois, self.grid_size)
        grid_valid = torch.ones(grid.shape[:2], dtype=torch.bool,
                                device=grid.device)
        outs = []
        for name, pool in zip(self.features, self.roi_grid_pool_layers):
            lv = ms[name]
            centers = voxel_centers(lv["keys"], lv["shape"], lv["stride"],
                                    self.voxel_size, self.point_cloud_range)
            c_s, v_s, perm = sort_points_by_y(centers, lv["mask"])
            ns = pool.nsamples[0]
            idx, cnt = ops.ball_query_batched(
                grid, grid_valid, c_s, v_s, pool.radii[0], ns,
                point_perm=perm, table=pack_table(c_s, v_s, perm))
            slot_valid = torch.arange(ns, device=idx.device) < cnt[..., None]
            x, _ = group_mlp(bn_pairs(pool.mlps[0]), grid, centers,
                             lv["feats"], idx, slot_valid)
            x = torch.where(slot_valid[..., None], x, -pointnet.BIG_DIST)
            outs.append(torch.where((cnt > 0)[..., None], x.amax(2), 0.0))
        pooled = torch.cat(outs, -1)
        return super().forward(pooled.reshape(b, r, -1), generator)


class VoxelRCNN(AnchorDetector):
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
        chans = self.backbone_3d.channels
        self.roi_head = VoxelRCNNHead(
            dict(x_conv1=chans[1], x_conv2=chans[2], x_conv3=chans[3],
                 x_conv4=chans[4]), voxel_size=voxel_size,
            point_cloud_range=point_cloud_range, **(roi_head_cfg or {}))
        init_like_jax(self)

    def forward(self, batch, train=None, generator=None):
        """Outputs as PV-RCNN's (``rcnn_cls``, ``rcnn_reg``,
        ``batch_box_preds_rcnn``, the RoIs and in train mode their
        ``roi_targets``)."""
        train = check_mode(self, train, generator)
        out = self.rpn(batch)
        out["proposals"] = proposal_layer(
            out["batch_box_preds"], out["batch_cls_preds"],
            **(self.train_nms if train else self.test_nms))
        out.update(second_stage_rois(out["proposals"], batch.get("gt_boxes"),
                                     train, generator))
        out["rcnn_cls"], out["rcnn_reg"] = self.roi_head(
            out["rois"], out["backbone"], self.ops, generator)
        out["batch_box_preds_rcnn"] = decode_roi_boxes(out["rois"],
                                                       out["rcnn_reg"])
        return out

    def loss(self, out, batch):
        losses = self.rpn_loss(out, batch)
        losses.update(roi_head_loss(out["rcnn_cls"], out["rcnn_reg"],
                                    out["roi_targets"]))
        return total(losses)
