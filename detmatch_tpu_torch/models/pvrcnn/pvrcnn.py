"""PV-RCNN detector: forward (eval and train), training loss and
post-processing (counterpart of ``detmatch_tpu/models/pvrcnn/pvrcnn.py``;
pcdet ``pv_rcnn.py``): VoxelBackbone8x → HeightCompression →
BaseBEVBackbone → AnchorHeadSingle → VoxelSetAbstraction →
PointHeadSimple → PVRCNNHead, then class-agnostic NMS.

Submodule names are pcdet's (``backbone_3d``, ``backbone_2d``,
``dense_head``, ``pfe``, ``point_head``, ``roi_head``), so a reference
state dict loads with ``load_state_dict``. Batch format as the JAX
model: points (B, P, 4), points_valid (B, P), voxel_features (B, V, 4),
voxel_keys (B, V), and for training gt_boxes (B, G, 8) zero-padded, the
last column the 1-based class.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from ...core import nms as nms_mod
from ...ops.cuda import KERNELS
from ...parallel import global_sum
from ..init import init_like_jax
from .anchor_head import AnchorHeadSingle
from .backbone3d import VoxelBackbone8x, level_shapes
from .bev import BaseBEVBackbone, height_compression
from .point_head import PointHeadSimple
from .roi_head import (PVRCNNHead, proposal_layer, roi_head_loss_terms,
                       second_stage_rois)
from .vsa import VoxelSetAbstraction

# DetMatch PV-RCNN anchor config (``split_0.py:132-160``)
DEFAULT_ANCHOR_CONFIGS = (
    dict(class_name="Pedestrian", anchor_sizes=[[0.8, 0.6, 1.73]],
         anchor_rotations=[0, 1.57], anchor_bottom_heights=[-0.6],
         align_center=False, feature_map_stride=8,
         matched_threshold=0.5, unmatched_threshold=0.35),
    dict(class_name="Cyclist", anchor_sizes=[[1.76, 0.6, 1.73]],
         anchor_rotations=[0, 1.57], anchor_bottom_heights=[-0.6],
         align_center=False, feature_map_stride=8,
         matched_threshold=0.5, unmatched_threshold=0.35),
    dict(class_name="Car", anchor_sizes=[[3.9, 1.6, 1.56]],
         anchor_rotations=[0, 1.57], anchor_bottom_heights=[-1.78],
         align_center=False, feature_map_stride=8,
         matched_threshold=0.6, unmatched_threshold=0.45),
)

TRAIN_NMS = dict(nms_pre=9000, nms_post=512, nms_thresh=0.8)
TEST_NMS = dict(nms_pre=1024, nms_post=100, nms_thresh=0.7)


class PVRCNN(nn.Module):
    """Batch norm follows the module mode (``model.train()`` /
    ``model.eval()``); the forward's ``train`` must agree with it."""

    def __init__(self, num_classes: int = 3,
                 point_cloud_range: Tuple[float, ...] = (0, -40, -3, 70.4,
                                                         40, 1),
                 voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.1),
                 grid_size: Tuple[int, int, int] = (1408, 1600, 40),
                 anchor_configs=DEFAULT_ANCHOR_CONFIGS,
                 num_keypoints: int = 2048,
                 backbone_caps=(24000, 16000, 10000, 10000),
                 num_point_features: int = 4,
                 train_nms: Dict = None, test_nms: Dict = None,
                 roi_head_cfg: Dict[str, Any] = None,
                 backbone3d_cfg: Dict[str, Any] = None,
                 bev_cfg: Dict[str, Any] = None,
                 compute_dtype: torch.dtype = None):
        """``compute_dtype`` (``torch.bfloat16`` or None): the compute
        dtype of the BEV convs, the set-abstraction and RoI-grid MLPs and
        the RoI head's fc stacks (JAX ``pvrcnn.py:63,83-98``); parameters,
        batch-norm statistics, the sparse backbone, the anchor and point
        heads, losses and box math stay float32."""
        super().__init__()
        # the three kernel ops the forward calls; a verification run swaps
        # in ``ops.cuda.PLAIN`` to hold the kernels against their twins
        self.ops = KERNELS
        self.train_nms = dict(train_nms or TRAIN_NMS)
        self.test_nms = dict(test_nms or TEST_NMS)
        spatial_shape = (grid_size[2] + 1, grid_size[1], grid_size[0])
        self.backbone_3d = VoxelBackbone8x(
            spatial_shape, input_channels=num_point_features,
            caps=backbone_caps, **(backbone3d_cfg or {}))
        hc_z = level_shapes(spatial_shape)[-1][0]
        num_bev_in = hc_z * self.backbone_3d.out_channels
        self.backbone_2d = BaseBEVBackbone(num_bev_in, dtype=compute_dtype,
                                           **(bev_cfg or {}))
        self.dense_head = AnchorHeadSingle(
            self.backbone_2d.num_bev_features, num_classes=num_classes,
            anchor_configs=anchor_configs,
            point_cloud_range=point_cloud_range, grid_size=grid_size)
        self.pfe = VoxelSetAbstraction(
            num_bev_in, self.backbone_3d.channels[1:],
            num_rawpoint_features=num_point_features - 3,
            num_keypoints=num_keypoints, voxel_size=voxel_size,
            point_cloud_range=point_cloud_range, dtype=compute_dtype)
        self.point_head = PointHeadSimple(
            self.pfe.num_point_features_before_fusion)
        self.roi_head = PVRCNNHead(
            self.pfe.vsa_point_feature_fusion[0].out_features,
            num_classes=num_classes, dtype=compute_dtype,
            **(roi_head_cfg or {}))
        init_like_jax(self)

    def forward(self, batch, train=None, generator=None, row_groups=1):
        """Forward pass.

        Args:
            batch: the batch dict (``gt_boxes`` needed in train mode).
            train: train mode (batch statistics, train NMS, RoI sampling,
                dropout); defaults to ``self.training`` and must agree
                with it.
            generator: a ``torch.Generator`` on the model's device, the
                source of the RoI picks and dropout masks (train only).
            row_groups: the batch's parts, each this process's shard of
                a global part: their number if equal, else their sizes
                (the SSL student's labeled + unlabeled views); under
                several processes it places the rows' draws in the global
                batch (``parallel.global_rows``).
        Returns:
            The JAX model's outputs plus the intermediates ``backbone``
            (sparse levels), ``spatial_features`` (B, C*Z, H, W),
            ``bev_features`` (B, C, H, W) and the VSA ``point_features``
            / ``point_features_before_fusion``. In train mode ``rois``,
            ``roi_labels`` and ``roi_scores_full`` are the sampled RoIs'
            and ``roi_targets`` holds their targets.
        """
        train = self.training if train is None else train
        if train != self.training:
            raise ValueError(f"forward(train={train}) on a model in "
                             f"{'train' if self.training else 'eval'} "
                             "mode: call model.train() or model.eval()")
        if train and generator is None:
            raise ValueError("a train forward needs a torch.Generator")
        ms = self.backbone_3d(batch["voxel_features"], batch["voxel_keys"],
                              self.ops)
        spatial = height_compression(ms["out"])
        bev = self.backbone_2d(spatial)
        # the anchor head has no compute dtype: a bfloat16 BEV map enters
        # it in float32, as flax promotes it
        head_preds = self.dense_head(bev.float())
        box_preds, cls_preds = self.dense_head.decode_boxes(head_preds)
        vsa = self.pfe(batch["points"], batch["points_valid"], spatial, ms,
                       self.ops)
        point_logits = self.point_head(vsa["point_features_before_fusion"],
                                       vsa["kp_valid"])
        point_scores = torch.sigmoid(point_logits[..., 0])
        proposals = proposal_layer(
            box_preds, cls_preds,
            **(self.train_nms if train else self.test_nms))
        out = dict(
            backbone=ms, spatial_features=spatial, bev_features=bev,
            head_preds=head_preds, batch_box_preds=box_preds,
            batch_cls_preds=cls_preds, point_logits=point_logits,
            point_scores=point_scores, keypoints=vsa["keypoints"],
            kp_valid=vsa["kp_valid"], point_features=vsa["point_features"],
            point_features_before_fusion=vsa["point_features_before_fusion"],
            proposals=proposals)
        out.update(second_stage_rois(proposals, batch.get("gt_boxes"), train,
                                     generator, self.roi_head.target_cfg,
                                     row_groups))
        rois = out["rois"]
        rcnn_cls, rcnn_reg = self.roi_head(
            rois, vsa["keypoints"], vsa["kp_valid"], vsa["point_features"],
            point_scores, self.ops, generator, row_groups)
        out.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg,
                   batch_box_preds_rcnn=PVRCNNHead.decode_boxes(rois,
                                                                rcnn_reg))
        return out

    def loss(self, out, batch):
        """Training loss = rpn + point + rcnn terms (``pv_rcnn.py:24-31``);
        ``out`` is a train forward's output. Returns the terms and their
        sum under ``loss``."""
        gt = batch["gt_boxes"]
        rpn = self.dense_head.loss(out["head_preds"],
                                   self.dense_head.targets(gt))
        pt_targets = self.point_head.targets(out["keypoints"],
                                             out["kp_valid"], gt)
        losses = dict(rpn, point_loss_cls=PointHeadSimple.loss(
            out["point_logits"], pt_targets))
        losses.update(PVRCNNHead.loss(out["rcnn_cls"], out["rcnn_reg"],
                                      out["roi_targets"]))
        losses["loss"] = sum(losses.values())
        return losses

    def loss_grouped(self, out, batch, groups):
        """Training loss of a concatenated batch, regrouped by sub-batch:
        for each ``name -> (mask (B,) bool, weight)`` the terms over the
        masked samples are normalised as a forward over those samples
        alone would normalise them (per-sample means for the anchor head,
        the group's positive counts for the point and RoI heads), the
        counts taken over every process's samples (one collective).

        Returns:
            ``{f"{name}.{term}": scalar, ..., "loss": weighted total}``.
        """
        gt = batch["gt_boxes"]
        rpn_per = self.dense_head.loss_per_sample(
            out["head_preds"], self.dense_head.targets(gt))
        pt_numer, pt_pos = PointHeadSimple.loss_terms(
            out["point_logits"], self.point_head.targets(
                out["keypoints"], out["kp_valid"], gt))
        rcnn_terms = roi_head_loss_terms(out["rcnn_cls"], out["rcnn_reg"],
                                         out["roi_targets"])
        # per group: sample count, positive keypoints, each RoI term's
        denoms = torch.clamp(global_sum(torch.stack([torch.stack(
            [mask.to(torch.float32).sum(),
             (pt_pos * mask.to(torch.float32)).sum()]
            + [(de * mask.to(torch.float32)).sum()
               for _, de in rcnn_terms.values()])
            for mask, _ in groups.values()])), min=1.0)
        result, total = {}, 0.0
        for (name, (mask, weight)), den in zip(groups.items(), denoms):
            m = mask.to(torch.float32)
            sub = {k: (v * m).sum() / den[0] for k, v in rpn_per.items()}
            sub["point_loss_cls"] = (pt_numer * m).sum() / den[1]
            for (k, (nu, _)), d in zip(rcnn_terms.items(), den[2:]):
                sub[k] = (nu * m).sum() / d
            result.update({f"{name}.{k}": v for k, v in sub.items()})
            total = total + weight * sum(sub.values())
        result["loss"] = total
        return result


def post_processing(out, nms_pre=4096, nms_post=500, nms_thresh=0.1,
                    score_thresh=0.1, no_nms=False):
    """Class-agnostic final NMS over the refined boxes (pcdet
    ``detector3d_template.py`` post-processing with DetMatch's
    ``sem_scores_full``).

    Returns a fixed-size per-frame dict: boxes (B, K, 7), scores (B, K),
    labels (B, K) 1-based, sem_scores_full (B, K, C) sigmoid, valid (B, K).
    With ``no_nms`` every RoI comes back (K = the RoI count), in RoI
    order, valid where its score reaches ``score_thresh``.
    """
    cls = torch.sigmoid(out["rcnn_cls"][..., 0])
    full = torch.sigmoid(out["roi_scores_full"])
    if no_nms:
        return dict(boxes=out["batch_box_preds_rcnn"], scores=cls,
                    labels=out["roi_labels"], sem_scores_full=full,
                    valid=cls >= score_thresh)
    return nms_detections(out["batch_box_preds_rcnn"], cls,
                          out["roi_labels"], full, nms_pre, nms_post,
                          nms_thresh, score_thresh)


def nms_detections(boxes, scores, labels, sem_full, nms_pre, nms_post,
                   nms_thresh, score_thresh):
    """Per frame: the ``nms_pre`` best boxes at or above ``score_thresh``
    (stable descending sort = ``lax.top_k``'s order), class-agnostic BEV
    NMS to ``nms_post`` slots, invalid slots zero → the dict of
    :func:`post_processing`."""
    res = {k: [] for k in ("boxes", "scores", "labels", "sem_scores_full",
                           "valid")}
    for b, s, lab, f in zip(boxes, scores, labels, sem_full):
        masked = torch.where(s >= score_thresh, s, nms_mod.NEG_INF)
        k = min(nms_pre, masked.shape[0])
        top_s, top_i = torch.sort(masked, descending=True, stable=True)
        top_s, top_i = top_s[:k], top_i[:k]
        idx, valid = nms_mod.nms_bev(b[top_i].detach(), top_s.detach(),
                                     nms_thresh, nms_post)
        sel = top_i[idx.long()]
        res["boxes"].append(torch.where(valid[:, None], b[sel], 0.0))
        res["scores"].append(torch.where(valid, s[sel], 0.0))
        res["labels"].append(torch.where(valid, lab[sel], 0))
        res["sem_scores_full"].append(torch.where(valid[:, None], f[sel],
                                                  0.0))
        res["valid"].append(valid)
    return {k: torch.stack(v) for k, v in res.items()}
