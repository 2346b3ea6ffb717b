"""DetMatch SSL detector, the teacher phase (counterpart of
``detmatch_tpu/ssl/detector.py``): a student and a teacher, each a
PV-RCNN and a Faster R-CNN, and the unlabeled teacher pipeline that
turns the teacher's detections into pseudo-labels — teacher inference
(3D post-NMS, 2D NMS'd), de-augmentation to the clean frame, score
filters, fusion Hungarian matching with a cost threshold, and
re-augmentation into the student frame. No gradients: call it under
``torch.inference_mode()``.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Tuple

from torch import nn

from ..models.frcnn.faster_rcnn import FasterRCNN
from ..models.pvrcnn.pvrcnn import PVRCNN, post_processing
from ..ops.cuda import KERNELS
from . import boxset, modules


@dataclass(frozen=True)
class SSLConfig:
    """DetMatch ``train_cfg.ssl`` and the module parameters of
    ``configs/detmatch/001/detmatch/split_0.py`` (the JAX ``SSLConfig``)."""
    ema_decay: float = 0.999
    true_avg_rampup: bool = True
    rampup_start_decay: float = 0.99
    use_student_bn_stats_for_teacher: bool = False
    ssl_weight: float = 1.0
    ssl_weight_rampup_start_iter: int = 0
    ssl_weight_rampup_num_iter: int = 0
    score_filter_3d: float = 0.1
    score_filter_2d: float = 0.1
    nms_2d_cfg: Tuple[float, float, int] = (0.05, 0.5, 100)
    proj_nms_2d_cfg: Tuple[float, float, int] = (0.1, 0.5, 100)
    cost_thr: float = -1.5
    pseudo_score_thr_3d: float = 0.1
    pseudo_score_thr_2d: float = 0.1
    hard_pseudo_2d_weight: float = 4.0
    consistency_weights: Tuple[float, float, float] = (2.0, 20.0, 2.0)
    max_pseudo_gt: int = 64
    stu_boxes_nms: Tuple[int, int] = (128, 128)
    # full DetMatch = all True; the ConfThr baselines turn off the fusion
    # and one modality, thresholding the teacher's boxes directly
    enable_3d: bool = True
    enable_2d: bool = True
    fusion: bool = True
    consistency: bool = True
    concat_student_batch: bool = True


class SSLDetector(nn.Module):
    """Student and teacher (``student.det3d``, ``student.det2d``,
    ``teacher.det3d``, ``teacher.det2d``). The teacher is its own copy of
    the student's weights, not an alias, and takes no gradients."""

    def __init__(self, pvrcnn: PVRCNN, frcnn: FasterRCNN,
                 cfg: SSLConfig = SSLConfig()):
        super().__init__()
        self.cfg = cfg
        self.student = nn.ModuleDict(dict(det3d=pvrcnn, det2d=frcnn))
        self.teacher = copy.deepcopy(self.student)
        for p in self.teacher.parameters():
            p.requires_grad_(False)
        self.ops = KERNELS

    @property
    def ops(self):
        """The kernel ops of every model and of the fusion matching; a
        verification run sets ``ops.cuda.PLAIN``."""
        return self._ops

    @ops.setter
    def ops(self, ops):
        self._ops = ops
        for half in (self.student, self.teacher):
            half["det3d"].ops = ops

    def _det3d_teacher_boxes(self, view):
        post = post_processing(self.teacher["det3d"](view))
        return dict(boxes=post["boxes"], scores=post["sem_scores_full"],
                    valid=post["valid"])

    def _det2d_teacher_boxes(self, view, nms_cfg):
        """SimpleTest_2D + BboxesNMS_2D; the background score column is
        stripped after the NMS."""
        score_thr, iou_thr, max_num = nms_cfg
        res = self.teacher["det2d"].simple_test(
            view["img"], view["img_shape"], score_thr, iou_thr, max_num,
            True)
        return dict(boxes=res["boxes"], scores=res["scores_full"][..., :-1],
                    valid=res["valid"])

    def teacher_pseudo_labels(self, batch):
        """The unlabeled teacher phase.

        Args:
            batch: ``{"unlab": {"tea": view, "stu": view}}``, each view
                voxelized (``train.ssl_step.voxelize_views``) with points,
                points_valid, voxel_features, voxel_keys, img (B, 3, H, W),
                img_shape, ori_shape (B, 2), lidar2img (B, 4, 4), aug3d
                (``Aug3D``) and aug2d (``Aug2D``).
        Returns:
            dict(m3d_stu, m2d_stu, m2d_clean, logs): detached BoxSets (the
            3D and 2D pseudo-labels in the student frame, and the 2D ones
            in the clean frame), each present when its modality is on.
        """
        cfg = self.cfg
        u_tea, u_stu = batch["unlab"]["tea"], batch["unlab"]["stu"]
        logs = {}
        tea3d_noaug = tea2d_noaug = None
        if cfg.enable_3d:
            tea3d_noaug = modules.transform_3d(
                self._det3d_teacher_boxes(u_tea), u_tea["aug3d"],
                reverse=True)
        if cfg.enable_2d:
            tea2d_noaug = modules.transform_2d(
                self._det2d_teacher_boxes(u_tea, cfg.nms_2d_cfg),
                u_tea["aug2d"], reverse=True)
        if cfg.fusion:
            m3d, m2d, _ = modules.fusion_hungarian_matching(
                boxset.max_score_filter(tea3d_noaug, cfg.score_filter_3d),
                boxset.max_score_filter(tea2d_noaug, cfg.score_filter_2d),
                u_stu["lidar2img"], u_stu["ori_shape"],
                cost_thr=cfg.cost_thr, solve=self.ops.solve_masked_batched)
            logs["metrics.num_tea_hung"] = boxset.num_valid(m3d)
        else:
            m3d, m2d = tea3d_noaug, tea2d_noaug
        out = dict(logs=logs)
        if cfg.enable_3d:
            out["m3d_stu"] = boxset.detach(
                modules.transform_3d(m3d, u_stu["aug3d"], reverse=False))
        if cfg.enable_2d:
            out["m2d_stu"] = boxset.detach(
                modules.transform_2d(m2d, u_stu["aug2d"], reverse=False))
            out["m2d_clean"] = boxset.detach(m2d)
        return out
