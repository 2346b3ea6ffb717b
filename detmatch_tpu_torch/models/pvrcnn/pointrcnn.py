"""PointRCNN (counterpart of ``detmatch_tpu/models/pvrcnn/pointrcnn.py``;
pcdet ``point_rcnn.py``, ``pointnet2_backbone.py``, ``point_head_box.py``
and ``pointrcnn_head.py``): a PointNet++ MSG backbone over the raw
points, per-point boxes from a point head as proposals, and a RoI head
that pools each RoI's first 512 in-box points, moves them into the RoI's
frame and runs a three-level set-abstraction stack on them.

FPS (kernel K3) runs 4 times in the backbone (16,384 → 4,096 → 1,024 →
256 → 64 at pcdet's widths) and twice in the RoI head over B·R problems
of 512 → 128 → 32 points; the ball query (K2) twice a backbone level and
once a head level, the last one group-all (radius 100, 512 slots, one
center at the origin). An empty RoI's problem has no valid point: FPS
gives index 0 throughout and every ball is empty. The set-abstraction
levels are the VSA's :class:`~.vsa.StackSAModuleMSG` (eval: an empty
ball pools to the MLP stack of zero, as JAX's ``SABranch``).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...core import geometry, losses
from ...core.coders import PointResidualCoder
from ...ops import pointnet
from ...ops.cuda import KERNELS
from ...ops.roipoint_pool import roipoint_pool
from ..init import init_like_jax
from ..layers import bn_pairs, mlp
from .parta2 import (apply_fc_stack, fc_stack, focal_cls_loss, mlp_stack,
                     point_box_targets)
from .roi_head import (decode_roi_boxes, proposal_layer, roi_head_loss,
                       second_stage_rois)
from .second import TEST_NMS, TRAIN_NMS, check_mode, total
from .vsa import StackSAModuleMSG


def sample_centers(ops, xyz, valid, npoint):
    """FPS centers of a set-abstraction level: (new_xyz (B, npoint, 3),
    new_valid (B, npoint), every center valid where the problem has a
    valid point)."""
    idx = ops.fps_batched(xyz.contiguous(), valid, npoint)
    new_valid = valid.any(1, keepdim=True).expand(-1, npoint).contiguous()
    return pointnet.gather_rows(xyz, idx), new_valid


class PointNet2MSG(nn.Module):
    """4-level SA encoder + FP decoder (pcdet ``pointrcnn.yaml``)."""

    def __init__(self, input_channels=1, npoints=(4096, 1024, 256, 64),
                 radii=((0.1, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0)),
                 nsamples=((16, 32),) * 4,
                 mlps=(((16, 16, 32), (32, 32, 64)),
                       ((64, 64, 128), (64, 96, 128)),
                       ((128, 196, 256), (128, 196, 256)),
                       ((256, 256, 512), (256, 384, 512))),
                 fp_mlps=((128, 128), (256, 256), (512, 512), (512, 512))):
        super().__init__()
        self.npoints = tuple(npoints)
        self.SA_modules = nn.ModuleList()
        chans = [input_channels]
        for r, ns, m in zip(radii, nsamples, mlps):
            sa = StackSAModuleMSG(r, ns, m, chans[-1])
            self.SA_modules.append(sa)
            chans.append(sa.out_channels)
        self.FP_modules = nn.ModuleList()
        up = chans[-1]
        fps_in = []
        for lv in range(len(fp_mlps) - 1, -1, -1):
            fps_in.append(up + chans[lv])
            up = fp_mlps[lv][-1]
        for lv, spec in enumerate(fp_mlps):
            self.FP_modules.append(mlp_stack(fps_in[len(fp_mlps) - 1 - lv],
                                             spec))
        self.out_channels = fp_mlps[0][-1]

    def forward(self, points, points_valid, ops=KERNELS):
        """points (B, N, 3 + C) → per-point features (B, N, C')."""
        xyz, valid = [points[..., :3].contiguous()], [points_valid]
        feats = [points[..., 3:] if points.shape[-1] > 3 else None]
        for lv, sa in enumerate(self.SA_modules):
            new_xyz, new_valid = sample_centers(ops, xyz[lv], valid[lv],
                                                self.npoints[lv])
            feats.append(sa(new_xyz, new_valid, xyz[lv], valid[lv],
                            feats[lv], ops))
            xyz.append(new_xyz)
            valid.append(new_valid)
        up = feats[-1]
        for lv in range(len(self.FP_modules) - 1, -1, -1):
            dists, idx = pointnet.three_nn(xyz[lv], valid[lv], xyz[lv + 1],
                                           valid[lv + 1])
            x = pointnet.three_interpolate(up, idx, dists)
            if feats[lv] is not None:
                x = torch.cat([x, feats[lv]], -1)
            up = mlp(bn_pairs(self.FP_modules[lv]), x, valid[lv])
        return up


class PointHeadBox(nn.Module):
    """Per-point class logits and 8-code boxes (PointResidualCoder)."""

    def __init__(self, input_channels, num_classes=3, cls_fc=(256, 256),
                 reg_fc=(256, 256), extra_width=(0.2, 0.2, 0.2)):
        super().__init__()
        self.num_classes = num_classes
        self.extra_width = tuple(extra_width)
        self.coder = PointResidualCoder()
        self.cls_layers = fc_stack(input_channels, cls_fc, num_classes)
        self.box_layers = fc_stack(input_channels, reg_fc,
                                   self.coder.code_size)

    def forward(self, point_features, valid):
        return (apply_fc_stack(self.cls_layers, point_features, valid),
                apply_fc_stack(self.box_layers, point_features, valid))

    def targets(self, points, valid, gt_boxes):
        """(labels (B, N), encoded box targets (B, N, 8))."""
        labels, encs = [], []
        for pts, pv, gb in zip(points, valid, gt_boxes):
            lab, fg, b = point_box_targets(pts, pv, gb, self.extra_width)
            enc = self.coder.encode(b[:, :7], pts, b[:, 7].to(torch.int64))
            labels.append(lab)
            encs.append(torch.where(fg[:, None], enc, 0.0))
        return torch.stack(labels), torch.stack(encs)

    def loss(self, cls_logits, box_reg, labels, box_targets):
        """(focal cls loss, smooth-L1 box loss over the positives)."""
        cls_loss, positives = focal_cls_loss(cls_logits, labels,
                                             self.num_classes)
        pos = positives.to(torch.float32)
        reg = losses.weighted_smooth_l1(box_reg, box_targets)
        return cls_loss, ((reg.sum(-1) * pos).sum()
                          / torch.clamp(pos.sum(), min=1.0))

    def generate_boxes(self, points, cls_logits, box_reg):
        """Decoded per-point boxes (B, N, 7) of the argmax class."""
        pred = torch.argmax(cls_logits, -1) + 1
        return self.coder.decode(box_reg, points, pred)


class PointRCNNHead(nn.Module):
    """Canonical RoI refinement over pooled in-box points."""

    def __init__(self, input_channels, num_sampled=512,
                 depth_normalizer=70.0, xyz_up=(128, 128), merge_down=128,
                 sa_npoints=(128, 32, -1), sa_radii=(0.2, 0.4, 100.0),
                 sa_nsamples=(16, 16, 512),
                 sa_mlps=((128, 128, 128), (128, 128, 256),
                          (256, 256, 512)),
                 cls_fc=(256, 256), reg_fc=(256, 256)):
        super().__init__()
        self.num_sampled = num_sampled
        self.depth_normalizer = depth_normalizer
        self.sa_npoints = tuple(sa_npoints)
        self.xyz_up_layer = mlp_stack(5, xyz_up)
        self.merge_down_layer = mlp_stack(xyz_up[-1] + input_channels,
                                          (merge_down,))
        self.SA_modules = nn.ModuleList()
        c = merge_down
        for r, ns, m in zip(sa_radii, sa_nsamples, sa_mlps):
            sa = StackSAModuleMSG((r,), (ns,), (m,), c)
            self.SA_modules.append(sa)
            c = sa.out_channels
        self.cls_layers = fc_stack(c, cls_fc, 1)
        self.reg_layers = fc_stack(c, reg_fc, 7)

    def init_explicit(self):
        """JAX's N(0, 0.001) weights of the box regressor's output
        layer (the class output keeps flax's LeCun default)."""
        nn.init.normal_(self.reg_layers[-1].weight, std=0.001)

    def forward(self, rois, points, points_valid, point_features,
                point_scores, ops=KERNELS):
        """rois (B, R, 7); points (B, N, 3); point_features (B, N, C);
        point_scores (B, N) → (rcnn_cls (B, R, 1), rcnn_reg (B, R, 7))."""
        b, r = rois.shape[:2]
        k = self.num_sampled
        depth = torch.linalg.norm(points, dim=-1) / self.depth_normalizer \
            - 0.5
        extra = torch.cat([point_scores.detach()[..., None], depth[..., None],
                           point_features], -1)
        pooled, empty = roipoint_pool(rois, points, extra, points_valid, k)
        local = geometry.rotate_points_z(
            (pooled[..., 0:3] - rois[..., None, 0:3]).reshape(b * r, k, 3),
            -rois[..., 6].reshape(-1)).reshape(b, r, k, 3)
        pooled = torch.cat([local, pooled[..., 3:]], -1)
        pooled = torch.where(empty[..., None, None], 0.0, pooled)
        pooled = pooled.reshape(b * r, k, -1)
        pv = (~empty).reshape(b * r, 1).expand(-1, k).contiguous()

        xyz_feats = mlp(bn_pairs(self.xyz_up_layer), pooled[..., 0:5], pv)
        feats = mlp(bn_pairs(self.merge_down_layer),
                    torch.cat([xyz_feats, pooled[..., 5:]], -1), pv)
        xyz, valid = pooled[..., 0:3].contiguous(), pv
        for npoint, sa in zip(self.sa_npoints, self.SA_modules):
            if npoint > 0:
                new_xyz, new_valid = sample_centers(ops, xyz, valid, npoint)
            else:  # group-all: one ball at the origin
                new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
                new_valid = valid.any(1, keepdim=True)
            feats = sa(new_xyz, new_valid, xyz, valid, feats, ops)
            xyz, valid = new_xyz, new_valid
        shared = feats[:, 0].reshape(b, r, -1)
        return (apply_fc_stack(self.cls_layers, shared),
                apply_fc_stack(self.reg_layers, shared))


class PointRCNN(nn.Module):
    """Batch: points (B, N, 3 + C), points_valid (B, N) (+ gt_boxes in
    train mode). The forward's ``train`` as PV-RCNN's; its outputs the
    two-stage models' (``rcnn_cls``, ``rcnn_reg``,
    ``batch_box_preds_rcnn``, ``rois``, ``roi_labels``,
    ``roi_scores_full``)."""

    def __init__(self, num_classes=3, num_point_features=4,
                 train_nms: Dict = None, test_nms: Dict = None,
                 backbone_cfg=None, point_head_cfg=None, roi_head_cfg=None):
        super().__init__()
        self.ops = KERNELS
        self.num_classes = num_classes
        self.train_nms = dict(train_nms or TRAIN_NMS)
        self.test_nms = dict(test_nms or TEST_NMS)
        self.backbone_3d = PointNet2MSG(num_point_features - 3,
                                        **(backbone_cfg or {}))
        c = self.backbone_3d.out_channels
        self.point_head = PointHeadBox(c, num_classes=num_classes,
                                       **(point_head_cfg or {}))
        self.roi_head = PointRCNNHead(c, **(roi_head_cfg or {}))
        init_like_jax(self)

    def forward(self, batch, train=None, generator=None):
        train = check_mode(self, train, generator)
        points, valid = batch["points"], batch["points_valid"]
        feats = self.backbone_3d(points, valid, self.ops)
        pt_cls, pt_reg = self.point_head(feats, valid)
        pt_scores = torch.sigmoid(pt_cls).amax(-1)
        boxes = self.point_head.generate_boxes(points[..., :3], pt_cls,
                                               pt_reg)
        proposals = proposal_layer(
            boxes, torch.where(valid[..., None], pt_cls, -1e10),
            **(self.train_nms if train else self.test_nms))
        out = dict(point_features=feats, point_cls_logits=pt_cls,
                   point_box_reg=pt_reg, point_scores=pt_scores,
                   proposals=proposals)
        out.update(second_stage_rois(proposals, batch.get("gt_boxes"), train,
                                     generator))
        out["rcnn_cls"], out["rcnn_reg"] = self.roi_head(
            out["rois"], points[..., :3], valid, feats, pt_scores, self.ops)
        out["batch_box_preds_rcnn"] = decode_roi_boxes(out["rois"],
                                                       out["rcnn_reg"])
        return out

    def loss(self, out, batch):
        """point (cls, box) + rcnn terms."""
        labels, box_t = self.point_head.targets(
            batch["points"][..., :3], batch["points_valid"],
            batch["gt_boxes"])
        losses_d = {}
        losses_d["point_loss_cls"], losses_d["point_loss_box"] = \
            self.point_head.loss(out["point_cls_logits"],
                                 out["point_box_reg"], labels, box_t)
        losses_d.update(roi_head_loss(out["rcnn_cls"], out["rcnn_reg"],
                                      out["roi_targets"]))
        return total(losses_d)
