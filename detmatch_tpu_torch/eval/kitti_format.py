"""KITTI-format result conversion + submission writer (counterpart of
``detmatch_tpu/eval/kitti_format.py``).

Reference parity: ``KittiDataset.bbox2result_kitti`` / ``bbox2result_kitti2d``
(``mmdet3d/datasets/kitti_dataset.py:441-620``) convert network outputs to
KITTI anno dicts (camera-frame boxes, observation angle alpha) and dump the
official per-frame ``<idx>.txt`` submission files. Here the same conversion
runs from this repo's internal detection dicts (LiDAR-frame boxes, 0-based
labels), and a reader inverts it so round-tripping through the KITTI format
is testable (internal → annos → txt → re-read → same AP).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data import kitti
from ..data import np_geometry as geometry
from .kitti_eval import CLASSES


def det_to_kitti_anno(det: Dict, calib: kitti.Calib,
                      image_shape: Optional[Sequence[float]] = None):
    """One internal det dict → a KITTI anno dict.

    Args:
        det: dict(labels (M,) int 0-based, scores (M,), bbox (M, 4),
            boxes3d (M, 7) internal LiDAR convention).
        calib: frame calibration (drives the lidar→rect transform).
        image_shape: optional (h, w) to clip 2D boxes, as the reference
            does (``kitti_dataset.py:495-497``).
    Returns:
        dict(name, truncated, occluded, alpha, bbox, dimensions (l, h, w),
        location (camera bottom-center), rotation_y, score).
    """
    boxes = np.asarray(det["boxes3d"], np.float32)
    m = len(boxes)
    if m == 0:
        return dict(name=np.array([]), truncated=np.array([]),
                    occluded=np.array([]), alpha=np.array([]),
                    bbox=np.zeros((0, 4)), dimensions=np.zeros((0, 3)),
                    location=np.zeros((0, 3)), rotation_y=np.array([]),
                    score=np.array([]))
    cam = np.asarray(geometry.boxes_lidar_to_camera(
        boxes, calib.lidar_to_rect))
    bbox = np.asarray(det["bbox"], np.float32).copy()
    if image_shape is not None:
        h, w = float(image_shape[0]), float(image_shape[1])
        bbox[:, 2:] = np.minimum(bbox[:, 2:], [w, h])
        bbox[:, :2] = np.maximum(bbox[:, :2], [0.0, 0.0])
    # observation angle (reference kitti_dataset.py:500-501)
    alpha = -np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6]
    return dict(
        name=np.array([CLASSES[int(c)] for c in det["labels"]]),
        truncated=np.zeros(m, np.float32),
        occluded=np.zeros(m, np.int32),
        alpha=alpha.astype(np.float32),
        bbox=bbox,
        dimensions=cam[:, 3:6].astype(np.float32),  # (l, h, w)
        location=cam[:, :3].astype(np.float32),
        rotation_y=cam[:, 6].astype(np.float32),
        score=np.asarray(det["scores"], np.float32),
    )


def write_kitti_txt(anno: Dict, path: str):
    """Write one frame's anno as an official KITTI result txt
    (reference submission dump, ``kitti_dataset.py:525-541``:
    ``name -1 -1 alpha bbox(4) h w l x y z ry score``)."""
    with open(path, "w") as f:
        for i in range(len(anno["name"])):
            b = anno["bbox"][i]
            d = anno["dimensions"][i]  # (l, h, w) → file order h w l
            loc = anno["location"][i]
            print("{} -1 -1 {:.4f} {:.4f} {:.4f} {:.4f} {:.4f} "
                  "{:.4f} {:.4f} {:.4f} {:.4f} {:.4f} {:.4f} {:.4f} "
                  "{:.4f}".format(
                      anno["name"][i], anno["alpha"][i],
                      b[0], b[1], b[2], b[3], d[1], d[2], d[0],
                      loc[0], loc[1], loc[2], anno["rotation_y"][i],
                      anno["score"][i]), file=f)


def read_kitti_txt(path: str) -> Dict:
    """Read a result txt back into a KITTI anno dict (inverse of
    :func:`write_kitti_txt`; 16th column = score)."""
    anno = kitti.read_label(path)
    scores = []
    with open(path) as f:
        for line in f:
            p = line.strip().split(" ")
            if len(p) >= 16:
                scores.append(float(p[15]))
    if scores:
        anno["score"] = np.array(scores, np.float32)
    return anno


def kitti_anno_to_internal(anno: Dict, calib: kitti.Calib) -> Dict:
    """KITTI anno dict → internal det dict (inverse conversion, for
    consuming external KITTI-format results / round-trip tests)."""
    boxes, labels, keep = kitti.annos_to_lidar_boxes(anno, calib)
    alpha = np.asarray(anno["alpha"], np.float32)[keep] \
        if "alpha" in anno else np.zeros(len(boxes), np.float32)
    return dict(labels=labels.astype(np.int32),
                scores=np.asarray(anno["score"], np.float32)[keep],
                bbox=np.asarray(anno["bbox"], np.float32)[keep],
                boxes3d=boxes, alpha=alpha)


def write_submission(det_annos: List[Dict], infos: List[Dict],
                     out_dir: str):
    """Dump a full KITTI submission directory: one ``<frame>.txt`` per
    image (reference ``submission_prefix`` path,
    ``kitti_dataset.py:525-541``). Returns the list of written paths."""
    os.makedirs(out_dir, exist_ok=True)
    if len(det_annos) != len(infos):
        raise ValueError(f"{len(det_annos)} detection sets for "
                         f"{len(infos)} frames")
    paths = []
    for det, info in zip(det_annos, infos):
        calib = kitti.calib_from_info(info)
        shape = info.get("image", {}).get("image_shape")
        anno = det_to_kitti_anno(det, calib, image_shape=shape)
        idx = info.get("image", {}).get("image_idx", len(paths))
        p = os.path.join(out_dir, f"{int(idx):06d}.txt")
        write_kitti_txt(anno, p)
        paths.append(p)
    return paths
