"""Fixed-shape collation: pipeline results dicts → model-ready batches
(counterpart of ``detmatch_tpu/data/collate.py``).

Every buffer is padded to a static capacity with a validity mask; the
device voxelizes (``ops/voxelize.py``), so the host only pads and stacks.
The augmentation records ``aug3d`` / ``aug2d`` are dicts of numpy arrays
with the fields of ``core.transforms.Aug3D`` / ``Aug2D`` (the JAX package
collates those NamedTuples themselves): ``train.ssl_step.to_device_views``
turns them into the NamedTuples of tensors, as it does for
``utils.synth_kitti.ssl_view``'s views.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .pipelines import build_aug_records


def collate_view(samples: Sequence[Dict], max_points=18000, max_gt=40,
                 with_gt=True) -> Dict[str, np.ndarray]:
    """Collate one view (stu or tea) into fixed-shape arrays: points (B,
    max_points, 4) and points_valid, img (B, H, W, 3), img_shape,
    ori_shape (B, 2), lidar2img (B, 4, 4), aug3d / aug2d; with ``with_gt``
    (and gt in the samples) gt_boxes (B, max_gt, 8) with 1-based classes
    in the last column, gt_boxes2d (B, max_gt, 4), 0-based gt_labels2d
    and gt2d_valid."""
    b = len(samples)
    out: Dict[str, np.ndarray] = {}

    pts = np.zeros((b, max_points, 4), np.float32)
    pts_valid = np.zeros((b, max_points), bool)
    for i, s in enumerate(samples):
        p = s["points"][:max_points]
        pts[i, :len(p)] = p
        pts_valid[i, :len(p)] = True
    out["points"] = pts
    out["points_valid"] = pts_valid

    out["img"] = np.stack([s["img"] for s in samples]).astype(np.float32)
    out["img_shape"] = np.stack(
        [np.asarray(s["img_shape"], np.float32) for s in samples])
    out["ori_shape"] = np.stack(
        [np.asarray(s["ori_shape"][:2], np.float32) for s in samples])
    out["lidar2img"] = np.stack(
        [np.asarray(s["lidar2img"], np.float32) for s in samples])

    recs3d, recs2d = zip(*[build_aug_records(s) for s in samples])
    out["aug3d"] = {k: np.stack([r[k] for r in recs3d])
                    for k in ("flip_x", "rot", "scale", "trans")}
    out["aug2d"] = {k: np.stack([r[k] for r in recs2d])
                    for k in ("scale", "flip", "img_w")}

    if with_gt and "gt_bboxes_3d" in samples[0]:
        gt = np.zeros((b, max_gt, 8), np.float32)
        for i, s in enumerate(samples):
            boxes = np.asarray(s["gt_bboxes_3d"], np.float32)[:max_gt]
            labels = np.asarray(s["gt_labels_3d"], np.int32)[:max_gt]
            n = len(boxes)
            gt[i, :n, :7] = boxes
            gt[i, :n, 7] = labels + 1  # 1-based classes, 0 = padding
        out["gt_boxes"] = gt

        g2 = np.zeros((b, max_gt, 4), np.float32)
        l2 = np.zeros((b, max_gt), np.int32)
        v2 = np.zeros((b, max_gt), bool)
        for i, s in enumerate(samples):
            bb = np.asarray(s.get("gt_bboxes",
                                  np.zeros((0, 4))), np.float32)[:max_gt]
            ll = np.asarray(s.get("gt_labels",
                                  np.zeros((0,))), np.int32)[:max_gt]
            g2[i, :len(bb)] = bb
            l2[i, :len(ll)] = ll
            v2[i, :len(bb)] = True
        out["gt_boxes2d"] = g2
        out["gt_labels2d"] = l2
        out["gt2d_valid"] = v2
    return out


def collate_ts(samples: Sequence[Dict], **kw):
    """Collate TSDataset outputs: {'stu': view with gt, 'tea': view}."""
    kw.pop("with_gt", None)
    return dict(
        stu=collate_view([s["stu"] for s in samples], with_gt=True, **kw),
        tea=collate_view([s["tea"] for s in samples], with_gt=False, **kw),
    )
