"""SSL processors (counterpart of ``detmatch_tpu/ssl/modules.py``): box
transforms between the teacher and student frames, 3D → 2D projection,
2D NMS over a BoxSet, the DetMatch fusion Hungarian matching (batched
and shape-static, the assignment solved on the device by kernel K4) and
the Hungarian consistency loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import geometry, hungarian, iou as iou_mod, losses, nms as nms_mod
from ..core import transforms
from ..core.coders import xyxy_to_cxcywh
from . import boxset


def transform_3d(bs, aug3d: transforms.Aug3D, reverse: bool):
    """BboxesTransform_3D: apply or reverse each frame's recorded 3D
    augmentation on a 3D BoxSet."""
    fn = (transforms.reverse_aug3d_boxes if reverse
          else transforms.apply_aug3d_boxes)
    boxes = torch.where(bs["valid"][..., None], fn(bs["boxes"], aug3d), 0.0)
    return dict(boxes=boxes, scores=bs["scores"], valid=bs["valid"])


def transform_2d(bs, aug2d: transforms.Aug2D, reverse: bool):
    """BboxesTransform_2D."""
    fn = (transforms.reverse_aug2d_boxes if reverse
          else transforms.apply_aug2d_boxes)
    boxes = torch.where(bs["valid"][..., None], fn(bs["boxes"], aug2d), 0.0)
    return dict(boxes=boxes, scores=bs["scores"], valid=bs["valid"])


def boxes_3d_to_2d(bs, lidar2img, ori_shape, min_depth=0.5, min_corners=3):
    """Bboxes3DTo2D: project a 3D BoxSet to a 2D xyxy BoxSet (same slots
    and scores).

    Args:
        lidar2img: (B, 4, 4); ori_shape: (B, 2) per-frame (h, w), or None
            to skip the clip and the inside-image test.
    """
    out, ok = [], []
    for b in range(bs["boxes"].shape[0]):
        box2d, valid = geometry.boxes_3d_to_2d(
            bs["boxes"][b], lidar2img[b],
            None if ori_shape is None else ori_shape[b],
            min_depth=min_depth, min_corners=min_corners)
        out.append(box2d)
        ok.append(valid)
    valid = bs["valid"] & torch.stack(ok)
    return dict(boxes=torch.where(valid[..., None], torch.stack(out), 0.0),
                scores=bs["scores"], valid=valid)


def nms_2d_boxset(bs, score_thr, iou_thr, max_num):
    """BboxesNMS_2D on a (possibly projected) 2D BoxSet: class-aware NMS
    over every (box, class) score above ``score_thr``; the survivors keep
    their whole score rows, in descending score order. The keeps are
    found without gradients; the gathered boxes and scores keep theirs."""
    b, k, c = bs["scores"].shape
    dev = bs["scores"].device
    labels = torch.arange(c, dtype=torch.int32, device=dev).repeat(k)
    rows, oks = [], []
    with torch.no_grad():
        for boxes, scores, valid in zip(bs["boxes"], bs["scores"],
                                        bs["valid"]):
            flat_scores = scores.reshape(-1)
            keep = valid.repeat_interleave(c) & (flat_scores > score_thr)
            idx, ok = nms_mod.batched_nms_2d(
                boxes.repeat_interleave(c, 0),
                torch.where(keep, flat_scores, nms_mod.NEG_INF), labels,
                iou_thr, max_num)
            rows.append(idx.long() // c)
            oks.append(ok)
    return boxset.gather(bs, torch.stack(rows), torch.stack(oks))


def _logit(s, eps=1e-6):
    s = torch.clamp(s, eps, 1 - eps)
    return torch.log(s / (1 - s))


def fusion_hungarian_matching(bs3d, bs2d, lidar2img, ori_shape,
                              cost_thr=-1.5, cls_weight=2.0, l1_weight=5.0,
                              iou_weight=2.0, project_3d_to_2d=True,
                              max_match=128,
                              solve=hungarian.solve_masked_batched):
    """FusionHungarianMatching: project the 3D boxes to the image, build
    the DETR-style cost (double-sided focal + normalised L1 + GIoU),
    solve the assignment in one batched JV call, reject matches costing
    more than ``cost_thr``, and return slot-aligned matched 3D and 2D
    BoxSets (matched pairs first, in row order) with each slot's cost.

    Args:
        bs3d: 3D BoxSet (boxes (B, K3, 7), or already projected (B, K3, 4)
            with ``project_3d_to_2d=False``); bs2d: 2D BoxSet.
        ori_shape: (B, 2) per-frame un-augmented (h, w), the L1 scale.
        max_match: each set is first compacted to its top ``max_match``
            slots, exact while no more survive the score filters.
        solve: the batched JV solver (``Ops.solve_masked_batched``).
    """
    if max_match is not None:
        if bs3d["boxes"].shape[1] > max_match:
            bs3d = boxset.topk(bs3d, max_match)
        if bs2d["boxes"].shape[1] > max_match:
            bs2d = boxset.topk(bs2d, max_match)
    if project_3d_to_2d:
        # the projection's own validity is discarded, as the reference does
        boxes3d_2d = boxes_3d_to_2d(
            dict(boxes=bs3d["boxes"], scores=bs3d["scores"],
                 valid=torch.ones_like(bs3d["valid"])),
            lidar2img, None)["boxes"]
    else:
        boxes3d_2d = bs3d["boxes"]
    b, k3 = bs3d["valid"].shape
    k2 = bs2d["valid"].shape[1]
    kk = max(k3, k2)
    dev = bs3d["valid"].device
    cost_sq = torch.full((b, kk, kk), hungarian.BIG, dtype=torch.float32,
                         device=dev)
    for i in range(b):
        h, w = ori_shape[i, 0], ori_shape[i, 1]
        factor = torch.stack([w, h, w, h]).to(bs2d["boxes"].dtype)
        p3n = xyxy_to_cxcywh(boxes3d_2d[i]) / factor
        cost = (losses.double_sided_focal_cost(
                    _logit(bs3d["scores"][i]), _logit(bs2d["scores"][i]),
                    weight=cls_weight)
                + losses.bbox_l1_cost(p3n, bs2d["boxes"][i] / factor,
                                      weight=l1_weight)
                + losses.giou_cost(boxes3d_2d[i], bs2d["boxes"][i],
                                   weight=iou_weight))
        cost_sq[i, :k3, :k2] = cost.detach()
    rv = torch.zeros((b, kk), dtype=torch.bool, device=dev)
    cv = torch.zeros((b, kk), dtype=torch.bool, device=dev)
    rv[:, :k3] = bs3d["valid"]
    cv[:, :k2] = bs2d["valid"]
    col4row, mcost = hungarian.assign_batched(cost_sq, rv, cv, solve=solve)
    col4row, mcost = col4row[:, :k3], mcost[:, :k3]
    keep = col4row >= 0
    if cost_thr is not None:
        keep = keep & (mcost <= cost_thr)
    # matched rows to the front, stably
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    ok = keep.gather(1, order)
    cols = torch.where(ok, col4row.gather(1, order), 0)
    out3d = boxset.gather(bs3d, order, ok)
    out2d = boxset.gather(bs2d, cols, ok)
    return out3d, out2d, torch.where(ok, mcost.gather(1, order), torch.inf)


def hungarian_consistency_loss(bs_in, bs_target, img_shape, cls_w=2.0,
                               l1_w=20.0, iou_w=2.0, focal_alpha=0.25,
                               focal_gamma=2.0):
    """HungarianConsistency: slot-aligned student (projected 3D) boxes
    toward the teacher's 2D boxes. Focal loss of the student's scores
    against the teacher's top class, L1 of the boxes normalised by the
    image size (mean over the 4 coordinates), and 1 - GIoU; each a mean
    over an image's matched pairs, then a mean over the images with at
    least one pair.

    Args:
        img_shape: (B, 2) per-image (h, w) in the student's frame.
    Returns:
        dict(cls_loss, l1_loss, iou_loss), already weighted.
    """
    pv = (bs_in["valid"] & bs_target["valid"]).to(torch.float32)
    n_pairs = pv.sum(1)
    img_has = (n_pairs > 0).to(torch.float32)
    denom_img = torch.clamp(img_has.sum(), min=1.0)
    per_pair = torch.clamp(n_pairs, min=1.0)

    def reduce(per_slot):
        return ((per_slot * pv).sum(1) / per_pair * img_has).sum() / denom_img

    logits = _logit(bs_in["scores"])
    c = logits.shape[-1]
    onehot = F.one_hot(torch.argmax(bs_target["scores"], -1), c).to(
        logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1 - p) * onehot + p * (1 - onehot)
    fw = (focal_alpha * onehot + (1 - focal_alpha) * (1 - onehot)
          ) * pt ** focal_gamma
    focal = (losses.sigmoid_ce_with_logits(logits, onehot) * fw).sum(-1)

    hw = img_shape.to(bs_in["boxes"].dtype)
    factor = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]],
                         -1)[:, None, :]
    l1 = (bs_in["boxes"] / factor - bs_target["boxes"] / factor).abs().mean(-1)
    g = iou_mod.iou2d(bs_in["boxes"].reshape(-1, 4),
                      bs_target["boxes"].reshape(-1, 4), mode="giou",
                      aligned=True).reshape(pv.shape)
    return dict(cls_loss=reduce(focal) * cls_w, l1_loss=reduce(l1) * l1_w,
                iou_loss=reduce(1.0 - g) * iou_w)
