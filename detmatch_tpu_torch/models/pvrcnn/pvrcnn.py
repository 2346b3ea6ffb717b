"""PV-RCNN detector, eval forward and post-processing (counterpart of
``detmatch_tpu/models/pvrcnn/pvrcnn.py``; pcdet ``pv_rcnn.py``):
VoxelBackbone8x → HeightCompression → BaseBEVBackbone → AnchorHeadSingle
→ VoxelSetAbstraction → PointHeadSimple → PVRCNNHead, then
class-agnostic NMS.

Submodule names are pcdet's (``backbone_3d``, ``backbone_2d``,
``dense_head``, ``pfe``, ``point_head``, ``roi_head``), so a reference
state dict loads with ``load_state_dict``. Batch format as the JAX
model: points (B, P, 4), points_valid (B, P), voxel_features (B, V, 4),
voxel_keys (B, V).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from ...core import nms as nms_mod
from ...ops.cuda import KERNELS
from .anchor_head import AnchorHeadSingle
from .backbone3d import VoxelBackbone8x, level_shapes
from .bev import BaseBEVBackbone, height_compression
from .point_head import PointHeadSimple
from .roi_head import PVRCNNHead, proposal_layer
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

TEST_NMS = dict(nms_pre=1024, nms_post=100, nms_thresh=0.7)


class PVRCNN(nn.Module):
    """``train_nms`` and the RoI head's ``target_cfg`` are accepted so the
    JAX configs load unchanged; they belong to the training slice, which
    is not ported yet."""

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
                 bev_cfg: Dict[str, Any] = None):
        super().__init__()
        # the three kernel ops the forward calls; a verification run swaps
        # in ``ops.cuda.PLAIN`` to hold the kernels against their twins
        self.ops = KERNELS
        self.train_nms = train_nms
        self.test_nms = dict(test_nms or TEST_NMS)
        spatial_shape = (grid_size[2] + 1, grid_size[1], grid_size[0])
        self.backbone_3d = VoxelBackbone8x(
            spatial_shape, input_channels=num_point_features,
            caps=backbone_caps, **(backbone3d_cfg or {}))
        hc_z = level_shapes(spatial_shape)[-1][0]
        num_bev_in = hc_z * self.backbone_3d.out_channels
        self.backbone_2d = BaseBEVBackbone(num_bev_in, **(bev_cfg or {}))
        self.dense_head = AnchorHeadSingle(
            self.backbone_2d.num_bev_features, num_classes=num_classes,
            anchor_configs=anchor_configs,
            point_cloud_range=point_cloud_range, grid_size=grid_size)
        self.pfe = VoxelSetAbstraction(
            num_bev_in, self.backbone_3d.channels[1:],
            num_rawpoint_features=num_point_features - 3,
            num_keypoints=num_keypoints, voxel_size=voxel_size,
            point_cloud_range=point_cloud_range)
        self.point_head = PointHeadSimple(
            self.pfe.num_point_features_before_fusion)
        self.roi_head = PVRCNNHead(
            self.pfe.vsa_point_feature_fusion[0].out_features,
            num_classes=num_classes, **(roi_head_cfg or {}))

    def forward(self, batch):
        """Eval forward. Returns the JAX model's eval outputs plus the
        intermediates ``backbone`` (sparse levels), ``spatial_features``
        (B, C*Z, H, W), ``bev_features`` (B, C, H, W) and the VSA
        ``point_features`` / ``point_features_before_fusion``."""
        ms = self.backbone_3d(batch["voxel_features"], batch["voxel_keys"],
                              self.ops)
        spatial = height_compression(ms["out"])
        bev = self.backbone_2d(spatial)
        head_preds = self.dense_head(bev)
        box_preds, cls_preds = self.dense_head.decode_boxes(head_preds)
        vsa = self.pfe(batch["points"], batch["points_valid"], spatial, ms,
                       self.ops)
        point_logits = self.point_head(vsa["point_features_before_fusion"],
                                       vsa["kp_valid"])
        point_scores = torch.sigmoid(point_logits[..., 0])
        proposals = proposal_layer(box_preds, cls_preds, **self.test_nms)
        rois = proposals["rois"]
        rcnn_cls, rcnn_reg = self.roi_head(
            rois, vsa["keypoints"], vsa["kp_valid"], vsa["point_features"],
            point_scores, self.ops)
        return dict(
            backbone=ms, spatial_features=spatial, bev_features=bev,
            head_preds=head_preds, batch_box_preds=box_preds,
            batch_cls_preds=cls_preds, point_logits=point_logits,
            point_scores=point_scores, keypoints=vsa["keypoints"],
            kp_valid=vsa["kp_valid"], point_features=vsa["point_features"],
            point_features_before_fusion=vsa["point_features_before_fusion"],
            proposals=proposals, rois=rois,
            roi_labels=proposals["roi_labels"],
            roi_scores=proposals["roi_scores"],
            roi_scores_full=proposals["roi_scores_full"],
            rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg,
            batch_box_preds_rcnn=PVRCNNHead.decode_boxes(rois, rcnn_reg))


def post_processing(out, nms_pre=4096, nms_post=500, nms_thresh=0.1,
                    score_thresh=0.1):
    """Class-agnostic final NMS over the refined boxes (pcdet
    ``detector3d_template.py`` post-processing with DetMatch's
    ``sem_scores_full``).

    Returns a fixed-size per-frame dict: boxes (B, K, 7), scores (B, K),
    labels (B, K) 1-based, sem_scores_full (B, K, C) sigmoid, valid (B, K).
    """
    cls = torch.sigmoid(out["rcnn_cls"][..., 0])
    full = torch.sigmoid(out["roi_scores_full"])
    res = {k: [] for k in ("boxes", "scores", "labels", "sem_scores_full",
                           "valid")}
    for b, s, lab, f in zip(out["batch_box_preds_rcnn"], cls,
                            out["roi_labels"], full):
        masked = torch.where(s >= score_thresh, s, nms_mod.NEG_INF)
        k = min(nms_pre, masked.shape[0])
        top_s, top_i = torch.sort(masked, descending=True, stable=True)
        top_s, top_i = top_s[:k], top_i[:k]
        idx, valid = nms_mod.nms_bev(b[top_i], top_s, nms_thresh, nms_post)
        sel = top_i[idx.long()]
        res["boxes"].append(torch.where(valid[:, None], b[sel], 0.0))
        res["scores"].append(torch.where(valid, s[sel], 0.0))
        res["labels"].append(torch.where(valid, lab[sel], 0))
        res["sem_scores_full"].append(torch.where(valid[:, None], f[sel],
                                                  0.0))
        res["valid"].append(valid)
    return {k: torch.stack(v) for k, v in res.items()}
