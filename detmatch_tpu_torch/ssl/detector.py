"""DetMatch SSL detector (counterpart of ``detmatch_tpu/ssl/detector.py``;
reference ``mmdet3d/models/detectors/ssl.py`` and the DetMatch module
pipeline): a student and a teacher, each a PV-RCNN and a Faster R-CNN.

* The teacher phase (:meth:`SSLDetector.teacher_pseudo_labels`, no
  gradients): teacher inference (3D post-NMS, 2D NMS'd),
  de-augmentation to the clean frame, score filters, fusion Hungarian
  matching with a cost threshold, re-augmentation into the student frame.
* The student losses, one function per branch: the 3D branch runs the
  labeled and unlabeled student views as ONE concatenated PV-RCNN
  forward with per-group losses (supervised on real gt, hard pseudo-label
  on the teacher's 3D boxes) plus the 2D consistency loss of the
  projected student boxes against the teacher's 2D boxes (the second
  fusion matching, kernel K4's second call); the 2D branch is the
  supervised Faster R-CNN loss plus its classification-only pseudo-label
  loss (weight 4).
* The teacher's EMA with the true-average rampup, and the SSL weight
  rampup.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Tuple

import torch
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


def ema_decay_at(it, cfg: SSLConfig):
    """The EMA decay of iteration ``it`` (``ssl.py:129-144``):
    min(1 - 1 / (it + round(1 / (1 - rampup_start_decay))), ema_decay),
    float32 as JAX computes it; a () float32 tensor."""
    d_max = torch.tensor(cfg.ema_decay, dtype=torch.float32)
    if not cfg.true_avg_rampup:
        return d_max
    start = max(round(1.0 / (1.0 - cfg.rampup_start_decay)), 2)
    ramp = 1.0 - 1.0 / torch.tensor(it + start, dtype=torch.float32)
    return torch.minimum(ramp, d_max)


def ssl_weight_at(it, cfg: SSLConfig):
    """The unlabeled-loss weight of iteration ``it`` (``ssl.py:165-181``):
    an exp(-5 (1 - t)^2) rampup over ``ssl_weight_rampup_num_iter``
    iterations after ``ssl_weight_rampup_start_iter``; a () float32
    tensor."""
    w = torch.tensor(cfg.ssl_weight, dtype=torch.float32)
    if cfg.ssl_weight_rampup_num_iter == 0:
        return w
    if it < cfg.ssl_weight_rampup_start_iter:
        return torch.zeros((), dtype=torch.float32)
    current = torch.tensor(min(it - cfg.ssl_weight_rampup_start_iter,
                               cfg.ssl_weight_rampup_num_iter),
                           dtype=torch.float32)
    phase = 1.0 - current / cfg.ssl_weight_rampup_num_iter
    return w * torch.exp(-5.0 * phase * phase)


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module, decay,
               use_student_bn_stats=False):
    """teacher = teacher * decay + student * (1 - decay), in place, over
    every floating-point parameter and buffer (batch-norm running
    statistics and frozen batch-norm constants included; the integer
    ``num_batches_tracked`` left alone) — ``ssl.py:146-163``. With
    ``use_student_bn_stats`` the running statistics of the trainable
    batch norms are copied from the student instead."""
    t_sd, s_sd = teacher.state_dict(), student.state_dict()
    copied = set()
    if use_student_bn_stats:
        for name, mod in student.named_modules():
            if isinstance(mod, nn.modules.batchnorm._BatchNorm):
                copied |= {f"{name}.running_mean", f"{name}.running_var"}
    keys = [k for k, t in t_sd.items() if t.is_floating_point()]
    for k in copied:
        t_sd[k].copy_(s_sd[k])
    ts = [t_sd[k] for k in keys if k not in copied]
    d = torch.as_tensor(decay, dtype=torch.float32).to(ts[0].device)
    torch._foreach_mul_(ts, d)
    torch._foreach_add_(ts, torch._foreach_mul(
        [s_sd[k] for k in keys if k not in copied], 1.0 - d))


def pseudo_gt_from_boxset(bs, score_thr, max_gt):
    """A BoxSet → (B, min(K, max_gt), 8) zero-padded gt boxes for PV-RCNN:
    the slots that are valid and score above ``score_thr``, in slot
    order, with the 1-based top class in the last column
    (Opd_HardPseudoLabel_3D)."""
    keep = bs["valid"] & (bs["scores"].amax(-1) > score_thr)
    order = torch.argsort((~keep).to(torch.uint8), dim=1,
                          stable=True)[:, :max_gt]
    kk = keep.gather(1, order)
    boxes = bs["boxes"].gather(1, order[..., None].expand(
        *order.shape, bs["boxes"].shape[-1]))
    lab = (torch.argmax(bs["scores"], -1).to(boxes.dtype) + 1.0).gather(
        1, order)
    gt = torch.cat([boxes, lab[..., None]], -1)
    return torch.where(kk[..., None], gt, 0.0)


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

    def train(self, mode=True):
        """Set the student's mode; the teacher always stays in eval
        mode (it only ever runs inference)."""
        super().train(mode)
        self.teacher.eval()
        return self

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

    # ---- the student half ----

    def _det3d_student_boxes(self, out_train):
        """The student's 3D boxes from its train forward (the
        Opd_HardPseudoLabel_3D output path, with NMS)."""
        pre, post = self.cfg.stu_boxes_nms
        p = post_processing(out_train, nms_pre=pre, nms_post=post)
        return dict(boxes=p["boxes"], scores=p["sem_scores_full"],
                    valid=p["valid"])

    def _consistency_branch(self, out3d_sub, u_stu, m2d_clean):
        """HungarianConsistency: the student's 3D boxes, de-augmented,
        projected to the image and 2D-NMS'd, matched against the clean
        teacher 2D boxes (the second fusion matching: K4's second call),
        both re-augmented into the student's image frame, and the
        focal / L1 / GIoU loss of the pairs. Returns (loss dict, the mean
        number of matched pairs per frame)."""
        cfg = self.cfg
        stu3d = modules.transform_3d(self._det3d_student_boxes(out3d_sub),
                                     u_stu["aug3d"], reverse=True)
        proj = modules.nms_2d_boxset(
            modules.boxes_3d_to_2d(stu3d, u_stu["lidar2img"],
                                   u_stu["ori_shape"]),
            *cfg.proj_nms_2d_cfg)
        s3d_m, t2d_m, _ = modules.fusion_hungarian_matching(
            proj, m2d_clean, u_stu["lidar2img"], u_stu["ori_shape"],
            cost_thr=cfg.cost_thr, project_3d_to_2d=False,
            solve=self.ops.solve_masked_batched)
        cw, lw, iw = cfg.consistency_weights
        cons = modules.hungarian_consistency_loss(
            modules.transform_2d(s3d_m, u_stu["aug2d"], reverse=False),
            modules.transform_2d(boxset.detach(t2d_m), u_stu["aug2d"],
                                 reverse=False),
            u_stu["img_shape"], cls_w=cw, l1_w=lw, iou_w=iw)
        return cons, boxset.num_valid(s3d_m)

    def _concat_student_batch(self, batch, pseudo):
        """The labeled student view (real gt) and the unlabeled one (the
        pseudo gt) as one PV-RCNN batch; returns (batch, labeled count)."""
        cfg = self.cfg
        lab, u_stu = batch["lab"]["stu"], batch["unlab"]["stu"]
        pgt = pseudo_gt_from_boxset(pseudo["m3d_stu"],
                                    cfg.pseudo_score_thr_3d,
                                    cfg.max_pseudo_gt)
        g = max(lab["gt_boxes"].shape[1], pgt.shape[1])

        def pad(x):
            return torch.nn.functional.pad(x, (0, 0, 0, g - x.shape[1]))

        cat = {k: torch.cat([lab[k], u_stu[k]], 0)
               for k in ("points", "points_valid", "voxel_features",
                         "voxel_keys")}
        cat["gt_boxes"] = torch.cat([pad(lab["gt_boxes"]), pad(pgt)], 0)
        return cat, lab["points"].shape[0]

    def _stu3d_grouped_losses(self, out, cat, bl, batch, pseudo, it):
        """Per-group losses of the concatenated forward plus the
        consistency loss; returns (total, logs)."""
        cfg = self.cfg
        w = ssl_weight_at(it, cfg).to(out["rcnn_cls"].device)
        mask_lab = torch.arange(cat["points"].shape[0],
                                device=w.device) < bl
        logs = self.student["det3d"].loss_grouped(
            out, cat, {"sup.3d": (mask_lab, 1.0),
                       "ssl.unlab.hard_pseudo_3d": (~mask_lab, w)})
        total = logs.pop("loss")
        if cfg.consistency and cfg.fusion and cfg.enable_2d:
            sub = {k: out[k][bl:] for k in ("batch_box_preds_rcnn",
                                            "rcnn_cls", "roi_labels",
                                            "roi_scores_full")}
            cons, n_match = self._consistency_branch(
                sub, batch["unlab"]["stu"], pseudo["m2d_clean"])
            logs["metrics.num_2D_to_3D_hung"] = n_match
            for k, v in cons.items():
                logs[f"ssl.unlab.2D_to_3D_hung.{k}"] = v
                total = total + w * v
        return total, logs

    def student_losses_3d_concat(self, batch, pseudo, it, generator):
        """The 3D branch's losses through ONE concatenated (labeled +
        unlabeled) train forward of the student PV-RCNN, which updates
        its batch-norm statistics over the union batch. ``generator``
        draws the RoI samples and dropout masks. Returns (total, logs)."""
        if not self.cfg.concat_student_batch:
            raise NotImplementedError(
                "the two-pass student 3D losses (concat_student_batch="
                "False) are not ported")
        cat, bl = self._concat_student_batch(batch, pseudo)
        out = self.student["det3d"](cat, train=True, generator=generator)
        return self._stu3d_grouped_losses(out, cat, bl, batch, pseudo, it)

    def student_losses_2d(self, batch, pseudo, it, generator):
        """The 2D branch's losses: supervised Faster R-CNN losses on the
        labeled view, and the unlabeled view's RPN and RoI classification
        losses on the hard 2D pseudo-labels, times
        ``hard_pseudo_2d_weight``. ``generator`` draws the anchor and RoI
        samples (labeled first). Returns (total, logs)."""
        cfg = self.cfg
        det2d = self.student["det2d"]
        lab, u_stu = batch["lab"]["stu"], batch["unlab"]["stu"]
        sup = det2d.loss(generator, det2d(lab["img"], lab["img_shape"],
                                          train=True),
                         lab["gt_boxes2d"], lab["gt_labels2d"],
                         lab["gt2d_valid"])
        m2d = pseudo["m2d_stu"]
        max2d, _ = m2d["scores"].max(-1)
        keep2d = m2d["valid"] & (max2d > cfg.pseudo_score_thr_2d)
        pl = det2d.loss(generator, det2d(u_stu["img"], u_stu["img_shape"],
                                         train=True),
                        m2d["boxes"], torch.argmax(m2d["scores"], -1),
                        keep2d)
        logs = {f"sup.2d.{k}": v for k, v in sup.items()}
        ssl_losses = {f"ssl.unlab.hard_pseudo_2d.{k}":
                      pl[k] * cfg.hard_pseudo_2d_weight
                      for k in ("loss_rpn_cls", "loss_cls")}
        w = ssl_weight_at(it, cfg).to(m2d["boxes"].device)
        total = sum(logs.values()) + w * sum(ssl_losses.values())
        logs.update(ssl_losses)
        return total, logs
