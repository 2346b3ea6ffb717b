"""Faster R-CNN R50-FPN, the 2D detector of DetMatch (counterpart of
``detmatch_tpu/models/frcnn/faster_rcnn.py``).

Images are NCHW on a fixed padded canvas, caffe-normalised by the data
layer; ``img_shapes`` (B, 2) gives each image's true (h, w) for
clipping. Test path: 1,000 RPN proposals → RoIAlign → two shared FCs →
sigmoid scores over C + 1 channels → (optionally) multiclass NMS that
keeps full score rows. Train path: 2,000 / 1,000 RPN proposals
(detached: RoIAlign backpropagates to the features only) → RPN loss on
256 sampled anchors + RoI loss on 512 sampled proposals. The model has
no train-mode layers (its batch norms are frozen), so ``train`` only
picks the proposal sizes. Module names follow mmdet's state dict
(``backbone``, ``neck``, ``rpn_head``, ``roi_head.bbox_head``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ...ops.roialign import multilevel_roi_align
from ...parallel import for_each_global_row
from ..init import init_like_jax
from .resnet import FPN, ResNet50
from .roi_head2d import (Shared2FCBBoxHead, decode_rcnn, multiclass_nms_2d,
                         rcnn_loss, sample_rcnn_targets)
from .rpn import RPNHead, grid_anchors, rpn_loss, rpn_proposals

STRIDES = (4, 8, 16, 32, 64)


class _RoIHead(nn.Module):
    """Holds the bbox head under mmdet's ``roi_head.bbox_head`` key."""

    def __init__(self, num_classes, dtype=None):
        super().__init__()
        self.bbox_head = Shared2FCBBoxHead(num_classes=num_classes,
                                           dtype=dtype)


class FasterRCNN(nn.Module):

    def __init__(self, num_classes: int = 3,
                 canvas: Tuple[int, int] = (384, 1280),
                 train_rpn_nms_pre: int = 2000, train_rpn_max: int = 1000,
                 test_rpn_nms_pre: int = 1000, test_rpn_max: int = 1000,
                 rcnn_num_samples: int = 512,
                 backbone_cfg: Dict = None,
                 compute_dtype: torch.dtype = None):
        """``compute_dtype`` (``torch.bfloat16`` or None): the compute
        dtype of the backbone, FPN and RPN convs and the RoI head's shared
        FCs (JAX ``faster_rcnn.py:38-52``); parameters, frozen batch-norm
        constants, the RPN and RoI logits, losses and box math stay
        float32."""
        super().__init__()
        self.num_classes = num_classes
        self.canvas = tuple(canvas)
        self.train_rpn_nms_pre = train_rpn_nms_pre
        self.train_rpn_max = train_rpn_max
        self.test_rpn_nms_pre = test_rpn_nms_pre
        self.test_rpn_max = test_rpn_max
        self.rcnn_num_samples = rcnn_num_samples
        self.backbone = ResNet50(dtype=compute_dtype, **(backbone_cfg or {}))
        self.neck = FPN(dtype=compute_dtype)
        self.rpn_head = RPNHead(dtype=compute_dtype)
        self.roi_head = _RoIHead(num_classes, compute_dtype)
        h, w = self.canvas
        for lvl, s in enumerate(STRIDES):
            a = grid_anchors(int(np.ceil(h / s)), int(np.ceil(w / s)), s)
            self.register_buffer(f"anchors{lvl}", torch.from_numpy(a),
                                 persistent=False)
        init_like_jax(self)

    @property
    def anchors(self):
        return [getattr(self, f"anchors{lvl}") for lvl in
                range(len(STRIDES))]

    def extract_feat(self, images):
        return self.neck(self.backbone(images))

    def forward(self, images, img_shapes, train=False):
        """Features and proposals (the train sizes if ``train``).

        Args:
            images: (B, 3, H, W) float32 on the canvas; img_shapes: (B, 2)
                float32 true (h, w).
        Returns:
            dict(feats (P2..P6, NCHW), rpn_outs (per level (cls (B, H, W,
            A), reg (B, H, W, 4A))), proposals (B, P, 4),
            proposal_scores (B, P) NEG_INF padded).
        """
        feats = self.extract_feat(images)
        rpn_outs = self.rpn_head(feats)
        nms_pre = self.train_rpn_nms_pre if train else self.test_rpn_nms_pre
        max_img = self.train_rpn_max if train else self.test_rpn_max
        props, scores = [], []
        # proposals are RoI coordinates, not a prediction to differentiate
        with torch.no_grad():
            for b in range(images.shape[0]):
                p, s = rpn_proposals([(c[b], r[b]) for c, r in rpn_outs],
                                     self.anchors, img_shapes[b], nms_pre,
                                     max_img)
                props.append(p)
                scores.append(s)
        return dict(feats=feats, rpn_outs=rpn_outs,
                    proposals=torch.stack(props),
                    proposal_scores=torch.stack(scores))

    def roi_forward(self, feats, rois_batched):
        """(B, R, 4) rois → (cls (B, R, C+1), reg (B, R, 4C)); gradients
        reach the features, never the rois."""
        b, r = rois_batched.shape[:2]
        rois_batched = rois_batched.detach()
        pooled = torch.cat([
            multilevel_roi_align([f[i] for f in feats[:4]], rois_batched[i],
                                 strides=STRIDES[:4]) for i in range(b)])
        cls, reg = self.roi_head.bbox_head(pooled)
        return cls.reshape(b, r, -1), reg.reshape(b, r, -1)

    def loss(self, generator, fwd, gt_boxes, gt_labels, gt_valid):
        """Training losses (RPN + RoI) of a ``forward(train=True)``.

        Args:
            generator: the ``torch.Generator`` the samplers draw from
                (the RPN's images in order, then the RoI head's; every
                global image's, each process keeping its own).
            gt_boxes: (B, G, 4); gt_labels: (B, G) 0-based; gt_valid:
                (B, G).
        Returns:
            dict(loss_rpn_cls, loss_rpn_bbox, loss_cls, loss_bbox).
        """
        out = rpn_loss(generator, fwd["rpn_outs"], self.anchors, gt_boxes,
                       gt_valid)
        props, pscores = fwd["proposals"], fwd["proposal_scores"]
        per = for_each_global_row(
            props.shape[0], lambda i: sample_rcnn_targets(
                generator, props[i], pscores[i] > -1e9, gt_boxes[i],
                gt_labels[i], gt_valid[i], num=self.rcnn_num_samples))
        targets = {k: torch.stack([t[k] for t in per]) for k in per[0]}
        cls_logits, reg_preds = self.roi_forward(fwd["feats"],
                                                 targets["rois"])
        out.update(rcnn_loss(cls_logits, reg_preds, targets,
                             num_classes=self.num_classes))
        return out

    def simple_test(self, images, img_shapes, score_thr=0.05, iou_thr=0.5,
                    max_per_img=100, with_nms=True):
        """The eval path. With NMS: per image dict(boxes (M, 4), scores,
        labels, scores_full (M, C+1), valid) stacked over the batch;
        without (the teacher's SimpleTest_2D): boxes (B, P, C, 4), scores
        (B, P, C+1) and valid (B, P) of every proposal."""
        fwd = self(images, img_shapes)
        cls_logits, reg_preds = self.roi_forward(fwd["feats"],
                                                 fwd["proposals"])
        res = []
        for b in range(images.shape[0]):
            boxes, scores = decode_rcnn(fwd["proposals"][b], cls_logits[b],
                                        reg_preds[b], self.num_classes,
                                        img_shapes[b])
            if with_nms:
                res.append(multiclass_nms_2d(boxes, scores, score_thr,
                                             iou_thr, max_per_img))
            else:
                res.append(dict(boxes=boxes, scores=scores,
                                valid=fwd["proposal_scores"][b] > -1e9))
        return {k: torch.stack([r[k] for r in res]) for k in res[0]}
