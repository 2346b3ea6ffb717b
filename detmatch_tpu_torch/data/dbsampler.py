"""GT-database sampling (counterpart of ``detmatch_tpu/data/dbsampler.py``;
reference ``datasets/pipelines/dbsampler.py:83-387``
and ``tools/data_converter/create_gt_database.py``).

Offline: crop per-object point clouds into a database with info pickles.
Online (ObjectSample): paste per-class samples into a scene with BEV
collision rejection and optional road-plane height snapping.
"""
from __future__ import annotations

import copy
import os
import pickle

import numpy as np
import torch

from ..core.iou import rotated_overlap_block
from . import np_geometry as geometry


def create_gt_database(root, infos, classes, out_dir="kitti_gt_database",
                       db_info_path="kitti_dbinfos_train.pkl",
                       pts_prefix="velodyne_reduced"):
    """Crop per-object points from each frame into .bin files + info pkl."""
    from .kitti import calib_from_info, annos_to_lidar_boxes, load_points
    os.makedirs(os.path.join(root, out_dir), exist_ok=True)
    db_infos = {c: [] for c in classes}
    for info in infos:
        annos = info.get("annos")
        if annos is None:
            continue
        calib = calib_from_info(info)
        idx = info["image"]["image_idx"]
        pc = dict(info["point_cloud"])
        pc["velodyne_path"] = pc["velodyne_path"].replace(
            "velodyne", pts_prefix)
        pts = load_points(root, {"point_cloud": pc})
        boxes, labels, keep = annos_to_lidar_boxes(annos, calib)
        names = annos["name"][keep]
        diffs = annos["difficulty"][keep]
        in_box = np.asarray(geometry.points_in_boxes(pts[:, :3], boxes))
        for i, name in enumerate(names):
            if name not in db_infos:
                continue
            obj_pts = pts[in_box[i]]
            obj_pts = obj_pts.copy()
            obj_pts[:, :3] -= boxes[i, :3]  # center-relative
            fname = f"{idx}_{name}_{i}.bin"
            obj_pts.astype(np.float32).tofile(
                os.path.join(root, out_dir, fname))
            db_infos[name].append(dict(
                name=name, path=os.path.join(out_dir, fname),
                image_idx=idx, gt_idx=i,
                box3d_lidar=boxes[i].astype(np.float32),
                num_points_in_gt=int(in_box[i].sum()),
                difficulty=int(diffs[i]), group_id=i, score=0.0))
    with open(os.path.join(root, db_info_path), "wb") as f:
        pickle.dump(db_infos, f)
    return db_infos


def _bev_corners(boxes):
    return np.asarray(geometry.boxes_to_corners_bev(boxes))


def _boxes_collide(corners_a, corners_b):
    """Pairwise BEV overlap test by the exact rotated-overlap math of
    ``core/iou.py`` on CPU tensors (the reference uses a numba
    box_collision_test, ``data_augment_utils.py``; the JAX package its
    jitted jnp kernel). It runs once per candidate of every training
    sample, on a handful of boxes: the host is the right place."""
    na, nb = len(corners_a), len(corners_b)
    if na == 0 or nb == 0:
        return np.zeros((na, nb), bool)
    areas = rotated_overlap_block(
        torch.from_numpy(np.asarray(corners_a, np.float32)),
        torch.from_numpy(np.asarray(corners_b, np.float32)))
    return areas.numpy() > 1e-6


class DataBaseSampler:
    """Per-class sampling with difficulty/min-points filters and BEV
    collision rejection (reference ``dbsampler.py:83-387``)."""

    def __init__(self, root, info_path, classes,
                 sample_groups=dict(Car=15, Pedestrian=10, Cyclist=10),
                 filter_by_difficulty=(-1,),
                 filter_by_min_points=dict(Car=5, Pedestrian=5, Cyclist=5),
                 use_road_plane=False, rng=None):
        self.root = root
        self.classes = list(classes)
        self.sample_groups = sample_groups
        self.use_road_plane = use_road_plane
        self.rng = rng or np.random
        with open(os.path.join(root, info_path)
                  if not os.path.isabs(info_path) else info_path, "rb") as f:
            db_infos = pickle.load(f)
        for name, lst in list(db_infos.items()):
            lst = [x for x in lst
                   if x["difficulty"] not in filter_by_difficulty]
            minp = filter_by_min_points.get(name, 0)
            lst = [x for x in lst if x["num_points_in_gt"] >= minp]
            db_infos[name] = lst
        self.db_infos = db_infos

    def _sample_class(self, name, num):
        pool = self.db_infos.get(name, [])
        if not pool or num <= 0:
            return []
        idx = self.rng.choice(len(pool), size=min(num, len(pool)),
                              replace=False)
        return [copy.deepcopy(pool[i]) for i in idx]

    def sample_all(self, gt_boxes, gt_labels, plane=None,
                   rect_to_lidar=None):
        """Sample per class up to group size minus existing count; reject
        colliders. Returns (boxes (S,7), labels (S,), points list)."""
        sampled_infos = []
        existing = [gt_boxes]
        for name, group in self.sample_groups.items():
            cls_id = self.classes.index(name)
            n_exist = int((gt_labels == cls_id).sum())
            cands = self._sample_class(name, group - n_exist)
            if not cands:
                continue
            cand_boxes = np.stack([c["box3d_lidar"] for c in cands])
            if self.use_road_plane and plane is not None:
                cand_boxes = put_on_plane(cand_boxes, plane, rect_to_lidar)
                for c, b in zip(cands, cand_boxes):
                    c["box3d_lidar"] = b
            all_prev = np.concatenate(existing, axis=0) if existing else \
                np.zeros((0, 7), np.float32)
            keep = self._reject_colliders(cand_boxes, all_prev)
            kept = [c for c, k in zip(cands, keep) if k]
            if kept:
                existing.append(np.stack([c["box3d_lidar"] for c in kept]))
                sampled_infos.extend(kept)
        if not sampled_infos:
            return (np.zeros((0, 7), np.float32),
                    np.zeros((0,), np.int32), [])
        boxes = np.stack([c["box3d_lidar"] for c in sampled_infos])
        labels = np.array([self.classes.index(c["name"])
                           for c in sampled_infos], np.int32)
        pts = []
        for c in sampled_infos:
            p = np.fromfile(os.path.join(self.root, c["path"]),
                            np.float32).reshape(-1, 4)
            p = p.copy()
            p[:, :3] += c["box3d_lidar"][:3]
            pts.append(p)
        return boxes.astype(np.float32), labels, pts

    def _reject_colliders(self, cand_boxes, prev_boxes):
        """Greedy: candidate kept if it doesn't overlap previous boxes or
        already-kept candidates (BEV)."""
        corners_prev = _bev_corners(prev_boxes) if len(prev_boxes) else \
            np.zeros((0, 4, 2), np.float32)
        corners_c = _bev_corners(cand_boxes)
        keep = []
        kept_corners = list(corners_prev)
        for i in range(len(cand_boxes)):
            coll = False
            if kept_corners:
                c = _boxes_collide(corners_c[i:i + 1],
                                   np.stack(kept_corners))
                coll = bool(c.any())
            keep.append(not coll)
            if not coll:
                kept_corners.append(corners_c[i])
        return keep


def put_on_plane(boxes, plane, rect_to_lidar):
    """Snap sampled boxes onto the road plane
    (reference ``dbsampler.py:197-247``): the plane is given in the rect
    camera frame (a, b, c, d with a*x+b*y+c*z+d=0); solve the camera-y at
    each box center and shift z accordingly in LiDAR frame."""
    a, b, c, d = plane
    centers = boxes[:, :3].copy()
    ones = np.ones((len(boxes), 1), np.float32)
    cam = (np.concatenate([centers, ones], 1)
           @ np.linalg.inv(rect_to_lidar).T)[:, :3]
    cam_y = -(a * cam[:, 0] + c * cam[:, 2] + d) / b
    delta_y = cam_y - cam[:, 1]
    out = boxes.copy()
    # camera y points down ⇒ lidar z decreases as cam y increases
    out[:, 2] -= delta_y
    return out


class ObjectSample:
    """Pipeline transform wrapping the sampler (``transforms_3d.py:248-367``):
    paste sampled objects, remove scene points inside sampled boxes, append
    object points, and (for the joint 2D branch) project sampled boxes to 2D.
    """

    def __init__(self, sampler: DataBaseSampler, sample_2d=True):
        self.sampler = sampler
        self.sample_2d = sample_2d

    def __call__(self, results):
        gt_boxes = results.get("gt_bboxes_3d", np.zeros((0, 7), np.float32))
        gt_labels = results.get("gt_labels_3d", np.zeros((0,), np.int32))
        boxes, labels, pts_list = self.sampler.sample_all(
            gt_boxes, gt_labels, plane=results.get("plane"),
            rect_to_lidar=results.get("rect_to_lidar"))
        if len(boxes) == 0:
            return results
        pts = results["points"]
        inside = np.asarray(geometry.points_in_boxes(pts[:, :3], boxes))
        pts = pts[~inside.any(axis=0)]
        results["points"] = np.concatenate([pts] + pts_list, axis=0)
        results["gt_bboxes_3d"] = np.concatenate([gt_boxes, boxes], axis=0)
        results["gt_labels_3d"] = np.concatenate([gt_labels, labels])
        if self.sample_2d and "gt_bboxes" in results:
            bb2d, valid = geometry.boxes_3d_to_2d(
                boxes, results["lidar2img"],
                img_shape=results["ori_shape"])
            bb2d = np.asarray(bb2d)
            results["gt_bboxes"] = np.concatenate(
                [results["gt_bboxes"], bb2d], axis=0).astype(np.float32)
            results["gt_labels"] = np.concatenate(
                [results["gt_labels"], labels])
        return results
