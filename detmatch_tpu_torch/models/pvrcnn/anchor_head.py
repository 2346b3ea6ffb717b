"""AnchorHeadSingle (counterpart of
``detmatch_tpu/models/pvrcnn/anchor_head.py``; pcdet
``anchor_head_single.py`` and ``axis_aligned_target_assigner.py``): dense
anchors, 1×1 conv predictions, the box decode with the
direction-classifier snap, and for training the vectorised
class-restricted target assignment and the losses (focal cls,
sin-difference smooth-L1 loc, direction-bin cross entropy).

Per-anchor outputs are flat in (H, W, class, rotation) order, as the JAX
head and pcdet (conv output permuted to NHWC before the reshape).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core import geometry, iou as iou_mod, losses
from ...core.coders import ResidualCoder
from ...ops.pointnet import gather_rows
from ...parallel import global_count
from ..init import PRIOR_BIAS

# the JAX head's default loss weights (``anchor_head.py:231-233``)
LOSS_WEIGHTS = dict(cls_weight=1.0, loc_weight=2.0, dir_weight=0.2,
                    code_weights=(1.0,) * 7)


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


def assign_targets(anchors, anchor_class, gt_boxes, match_thr, unmatch_thr):
    """Axis-aligned target assignment, vectorised over the batch.

    Args:
        anchors: (A, 7); anchor_class: (A,) 0-based class of each anchor;
        gt_boxes: (B, G, 8) zero-padded, last column the 1-based class;
        match_thr, unmatch_thr: (A,) per-anchor thresholds.
    Returns:
        (fg (B, A) bool, neg (B, A) bool, a2g (B, A) int64). Each anchor
        sees only its own class's gts; IoUs snap to the 2^-20 grid
        (``iou.quantize``) so the force-match ties (every anchor equal to
        a gt's best IoU) and the argmax break as in the JAX package.
    """
    gt_cls = gt_boxes[..., 7].to(torch.int64)
    gt_valid = gt_cls > 0
    ious = torch.stack([iou_mod.nearest_bev_iou(anchors, g[:, :7])
                        for g in gt_boxes])  # (B, A, G)
    ious = iou_mod.quantize(ious)
    same = (anchor_class[None, :, None] + 1) == gt_cls[:, None, :]
    ious = torch.where(same & gt_valid[:, None, :], ious, -1.0)
    a2g_max = ious.amax(dim=2)
    a2g = torch.argmax(ious, dim=2)  # first maximum, as jnp.argmax
    g2a_max = ious.amax(dim=1)[:, None, :]  # (B, 1, G)
    forced = ((ious == g2a_max) & (g2a_max > 0)
              & gt_valid[:, None, :]).any(dim=2)
    neg = (a2g_max < unmatch_thr) & ~forced
    fg = (a2g_max >= match_thr) | forced
    return fg, neg, a2g


class AnchorHeadSingle(nn.Module):
    def __init__(self, input_channels, num_classes=3, anchor_configs=(),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1),
                 grid_size=(1408, 1600, 40), num_dir_bins=2,
                 dir_offset=0.78539, dir_limit_offset=0.0):
        super().__init__()
        self.num_classes = num_classes
        num_rot = len(anchor_configs[0]["anchor_rotations"])
        self.num_dir_bins = num_dir_bins
        self.dir_offset = dir_offset
        self.dir_limit_offset = dir_limit_offset
        self.coder = ResidualCoder()
        anchors = generate_anchors(point_cloud_range, grid_size,
                                   list(anchor_configs))
        self.register_buffer("anchors", torch.from_numpy(anchors),
                             persistent=False)
        # flat (H, W, class, rotation) order → class = (a // R) % C
        anchor_class = (np.arange(len(anchors)) // num_rot) % len(
            anchor_configs)
        self.register_buffer("anchor_class", torch.from_numpy(anchor_class),
                             persistent=False)
        for name, key in (("match_thr", "matched_threshold"),
                          ("unmatch_thr", "unmatched_threshold")):
            thr = np.asarray([cfg[key] for cfg in anchor_configs],
                             np.float32)[anchor_class]
            self.register_buffer(name, torch.from_numpy(thr),
                                 persistent=False)
        na = len(anchor_configs) * num_rot
        self.conv_cls = nn.Conv2d(input_channels, na * num_classes, 1)
        self.conv_box = nn.Conv2d(input_channels, na * self.coder.code_size,
                                  1)
        self.conv_dir_cls = nn.Conv2d(input_channels, na * num_dir_bins, 1)

    def init_explicit(self):
        """JAX's prior class bias and N(0, 0.001) box weights
        (``anchor_head.py:180,184`` there)."""
        nn.init.constant_(self.conv_cls.bias, PRIOR_BIAS)
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

    def targets(self, gt_boxes):
        """(B, G, 8) gts → (labels (B, A) int64: class / 0 bg / -1 ignore,
        reg_targets (B, A, 7), fg weights (B, A) float)."""
        fg, neg, a2g = assign_targets(self.anchors, self.anchor_class,
                                      gt_boxes, self.match_thr,
                                      self.unmatch_thr)
        assigned = gather_rows(gt_boxes, a2g)  # (B, A, 8)
        labels = torch.where(fg, assigned[..., 7].to(torch.int64),
                             torch.where(neg, 0, -1))
        tgt = self.coder.encode(assigned[..., :7], self.anchors[None])
        reg_targets = torch.where(fg[..., None], tgt, 0.0)
        return labels, reg_targets, fg.to(torch.float32)

    def loss_per_sample(self, preds, targets):
        """Per-sample loss terms, each (B,); ``loss`` is their batch
        mean (pcdet ``anchor_head_template.get_loss``)."""
        labels, reg_targets, _ = targets
        lw = LOSS_WEIGHTS
        cared = labels >= 0
        positives = labels > 0
        pos_norm = torch.clamp(
            positives.sum(dim=1, keepdim=True).to(torch.float32), min=1.0)
        cls_w = cared.to(torch.float32) / pos_norm
        onehot = torch.nn.functional.one_hot(
            torch.where(cared, labels, 0), self.num_classes + 1)[..., 1:]
        cls_loss = losses.sigmoid_focal_loss(
            preds["cls_preds"], onehot.to(torch.float32), cls_w
        ).sum(dim=(1, 2)) * lw["cls_weight"]

        reg_w = positives.to(torch.float32) / pos_norm
        bp, rt = preds["box_preds"], reg_targets
        sin_p = torch.sin(bp[..., 6:7]) * torch.cos(rt[..., 6:7])
        sin_t = torch.cos(bp[..., 6:7]) * torch.sin(rt[..., 6:7])
        loc_loss = losses.weighted_smooth_l1(
            torch.cat([bp[..., :6], sin_p], dim=-1),
            torch.cat([rt[..., :6], sin_t], dim=-1), weights=reg_w,
            code_weights=lw["code_weights"]).sum(dim=(1, 2)) * lw["loc_weight"]

        rot_gt = reg_targets[..., 6] + self.anchors[None, :, 6]
        offset_rot = geometry.limit_period(rot_gt - self.dir_offset, 0,
                                           2 * np.pi)
        dir_t = torch.clamp(
            torch.floor(offset_rot / (2 * np.pi / self.num_dir_bins)),
            0, self.num_dir_bins - 1).to(torch.int64)
        dir_onehot = torch.nn.functional.one_hot(dir_t, self.num_dir_bins)
        dir_loss = losses.weighted_cross_entropy(
            preds["dir_preds"], dir_onehot, reg_w).sum(dim=1) * lw[
                "dir_weight"]
        return dict(rpn_loss_cls=cls_loss, rpn_loss_loc=loc_loss,
                    rpn_loss_dir=dir_loss)

    def loss(self, preds, targets):
        """Mean of :meth:`loss_per_sample` over the global batch (this
        process's samples' sum over the global sample count)."""
        return {k: v.sum() / global_count(v.shape[0]) for k, v in
                self.loss_per_sample(preds, targets).items()}
