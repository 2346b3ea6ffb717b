"""KITTI raw-file parsing, info records, and the info-driven dataset
(counterpart of ``detmatch_tpu/data/kitti.py``, numpy as there, so its
infos and samples equal the JAX package's on the same files).

Replaces the reference's offline converters + dataset
(``tools/data_converter/kitti_data_utils.py``, ``kitti_converter.py``,
``mmdet3d/datasets/kitti_dataset.py``). The on-disk info format matches the
reference's pickles (a list of per-frame dicts with 'image', 'point_cloud',
'calib', 'annos') so existing mmdet3d-style info files — including the
released ssl_splits — load directly.

All box math goes through the single internal convention
(:mod:`.np_geometry`); camera-frame boxes appear only here, at
the I/O boundary.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict

import numpy as np

from . import np_geometry as geometry

CLASS_NAMES = ("Pedestrian", "Cyclist", "Car")


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@dataclass
class Calib:
    P2: np.ndarray           # (4, 4)
    R0: np.ndarray           # (4, 4) rect rotation (padded)
    V2C: np.ndarray          # (4, 4) Tr_velo_to_cam (padded)

    @property
    def lidar2img(self):
        """P2 @ R0 @ Tr_velo_to_cam (reference ``kitti_dataset.py:130-133``)."""
        return (self.P2 @ self.R0 @ self.V2C).astype(np.float32)

    @property
    def rect_to_lidar(self):
        """(4, 4) inverse mapping rect-cam → lidar."""
        return np.linalg.inv(self.R0 @ self.V2C).astype(np.float32)

    @property
    def lidar_to_rect(self):
        return (self.R0 @ self.V2C).astype(np.float32)


def _pad44(m):
    out = np.eye(4, dtype=np.float32)
    out[:m.shape[0], :m.shape[1]] = m
    return out


def read_calib(path) -> Calib:
    """Parse a KITTI calib txt."""
    vals = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            vals[k.strip()] = np.array(
                [float(x) for x in v.split()], np.float32)
    P2 = _pad44(vals["P2"].reshape(3, 4))
    R0 = _pad44(vals["R0_rect"].reshape(3, 3))
    V2C = _pad44(vals["Tr_velo_to_cam"].reshape(3, 4))
    return Calib(P2=P2, R0=R0, V2C=V2C)


def calib_from_info(info) -> Calib:
    c = info["calib"]
    return Calib(P2=_pad44(np.asarray(c["P2"], np.float32)[:3, :4]),
                 R0=_pad44(np.asarray(c["R0_rect"], np.float32)[:3, :3]),
                 V2C=_pad44(np.asarray(c["Tr_velo_to_cam"],
                                       np.float32)[:3, :4]))


# ---------------------------------------------------------------------------
# label parsing + difficulty (reference kitti_data_utils.py semantics)
# ---------------------------------------------------------------------------

def read_label(path) -> Dict[str, np.ndarray]:
    """KITTI label_2 txt → annos dict (dimensions reordered h,w,l → l,h,w
    as in the reference converter)."""
    names, trunc, occ, alpha, bbox, dims, loc, rot = ([] for _ in range(8))
    with open(path) as f:
        for line in f:
            p = line.strip().split(" ")
            if len(p) < 15:
                continue
            names.append(p[0])
            trunc.append(float(p[1]))
            occ.append(int(float(p[2])))
            alpha.append(float(p[3]))
            bbox.append([float(x) for x in p[4:8]])
            h, w, l = (float(p[8]), float(p[9]), float(p[10]))
            dims.append([l, h, w])
            loc.append([float(x) for x in p[11:14]])
            rot.append(float(p[14]))
    n = len(names)
    annos = dict(
        name=np.array(names),
        truncated=np.array(trunc, np.float32),
        occluded=np.array(occ, np.int32),
        alpha=np.array(alpha, np.float32),
        bbox=np.array(bbox, np.float32).reshape(n, 4),
        dimensions=np.array(dims, np.float32).reshape(n, 3),
        location=np.array(loc, np.float32).reshape(n, 3),
        rotation_y=np.array(rot, np.float32),
        index=np.concatenate([
            np.arange(int(np.sum(np.array(names) != "DontCare")), dtype=np.int32),
            -np.ones(int(np.sum(np.array(names) == "DontCare")), np.int32)]) if n
        else np.zeros((0,), np.int32),
        group_ids=np.arange(n, dtype=np.int32),
        score=np.zeros((n,), np.float32),
    )
    annos["difficulty"] = compute_difficulty(annos)
    return annos


# thresholds from the KITTI devkit (reference add_difficulty_to_annos)
_MIN_HEIGHTS = (40.0, 25.0, 25.0)
_MAX_OCCLUSION = (0, 1, 2)
_MAX_TRUNCATION = (0.15, 0.3, 0.5)


def compute_difficulty(annos) -> np.ndarray:
    """0 easy / 1 moderate / 2 hard / -1 beyond-hard."""
    h = annos["bbox"][:, 3] - annos["bbox"][:, 1]
    occ = annos["occluded"]
    tr = annos["truncated"]
    n = len(h)
    diff = np.full((n,), -1, np.int32)
    for level in (2, 1, 0):
        ok = ((h >= _MIN_HEIGHTS[level]) & (occ <= _MAX_OCCLUSION[level])
              & (tr <= _MAX_TRUNCATION[level]))
        diff[ok] = level
    return diff


# ---------------------------------------------------------------------------
# info creation (tools/create_data.py equivalent)
# ---------------------------------------------------------------------------

def create_infos(root, split_file, training=True, num_features=4,
                 count_points=True):
    """Build the per-frame info list for the given image-set split."""
    with open(split_file) as f:
        idxs = [line.strip() for line in f if line.strip()]
    infos = []
    sub = "training" if training else "testing"
    for idx in idxs:
        info = {
            "image": {
                "image_idx": int(idx),
                "image_path": f"{sub}/image_2/{idx}.png",
                "image_shape": _image_shape(
                    os.path.join(root, sub, "image_2", f"{idx}.png")),
            },
            "point_cloud": {
                "num_features": num_features,
                "velodyne_path": f"{sub}/velodyne/{idx}.bin",
            },
        }
        calib = read_calib(os.path.join(root, sub, "calib", f"{idx}.txt"))
        info["calib"] = {
            "P2": calib.P2, "R0_rect": calib.R0,
            "Tr_velo_to_cam": calib.V2C,
        }
        label_path = os.path.join(root, sub, "label_2", f"{idx}.txt")
        if training and os.path.exists(label_path):
            annos = read_label(label_path)
            if count_points:
                annos["num_points_in_gt"] = _count_points_in_gt(
                    root, info, annos, calib, num_features)
            info["annos"] = annos
        infos.append(info)
    return infos


def _image_shape(path):
    from PIL import Image
    with Image.open(path) as im:
        w, h = im.size
    return np.array([h, w], np.int32)


def load_points(root, info):
    path = os.path.join(root, info["point_cloud"]["velodyne_path"])
    nf = info["point_cloud"]["num_features"]
    return np.fromfile(path, np.float32).reshape(-1, nf)


def annos_to_lidar_boxes(annos, calib: Calib):
    """Camera-frame annos → internal LiDAR boxes (N, 7) + labels.

    Reference ``get_ann_info`` (``kitti_dataset.py:153-217``) converts
    camera boxes via the rect→lidar transform; DontCare rows are dropped.
    """
    keep = annos["name"] != "DontCare"
    loc = annos["location"][keep]
    dims = annos["dimensions"][keep]  # (l, h, w)
    rots = annos["rotation_y"][keep]
    cam = np.concatenate(
        [loc, dims, rots[:, None]], axis=1).astype(np.float32)
    boxes = geometry.boxes_camera_to_lidar(cam, calib.rect_to_lidar)
    labels = np.array(
        [CLASS_NAMES.index(n) if n in CLASS_NAMES else -1
         for n in annos["name"][keep]], np.int32)
    return np.asarray(boxes, np.float32), labels, keep


def _count_points_in_gt(root, info, annos, calib, num_features):
    pts = load_points(root, info)
    boxes, _, keep = annos_to_lidar_boxes(annos, calib)
    n_all = len(annos["name"])
    out = -np.ones((n_all,), np.int32)
    if len(boxes):
        mask = np.asarray(geometry.points_in_boxes(pts[:, :3], boxes))
        out[:len(boxes)] = mask.sum(axis=1)
    return out


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

class KittiDataset:
    """Info-pkl-driven dataset (reference ``kitti_dataset.py:20-``).

    Produces a results dict consumed by the pipeline transforms
    (:mod:`.pipelines`).
    """

    def __init__(self, root, info_path, pipeline=None,
                 classes=CLASS_NAMES, test_mode=False,
                 pts_prefix="velodyne_reduced",
                 completely_remove_other_classes=False,
                 load_interval=1, repeat=1, filter_empty_gt=True):
        self.root = root
        with open(info_path, "rb") as f:
            self.infos = pickle.load(f)[::load_interval]
        self.pipeline = pipeline
        self.classes = list(classes)
        self.test_mode = test_mode
        self.pts_prefix = pts_prefix
        self.remove_other = completely_remove_other_classes
        self.repeat = repeat
        self.filter_empty_gt = filter_empty_gt

    def __len__(self):
        return len(self.infos) * self.repeat

    def _pts_path(self, info):
        p = info["point_cloud"]["velodyne_path"]
        return os.path.join(self.root,
                            p.replace("velodyne", self.pts_prefix))

    def get_ann_info(self, index):
        info = self.infos[index % len(self.infos)]
        calib = calib_from_info(info)
        annos = info["annos"]
        boxes, labels, keep = annos_to_lidar_boxes(annos, calib)
        bbox2d = annos["bbox"][keep].astype(np.float32)
        if self.remove_other:
            sel = labels >= 0
            boxes, labels, bbox2d = boxes[sel], labels[sel], bbox2d[sel]
        return dict(gt_bboxes_3d=boxes, gt_labels_3d=labels,
                    gt_bboxes=bbox2d, gt_labels=labels,
                    plane=info.get("plane", None))

    def __getitem__(self, index):
        info = self.infos[index % len(self.infos)]
        calib = calib_from_info(info)
        results = dict(
            sample_idx=info["image"]["image_idx"],
            pts_filename=self._pts_path(info),
            img_filename=os.path.join(self.root,
                                      info["image"]["image_path"]),
            lidar2img=calib.lidar2img,
            rect_to_lidar=calib.rect_to_lidar,
            ori_shape=np.asarray(info["image"]["image_shape"], np.int32),
            num_pts_feats=info["point_cloud"]["num_features"],
        )
        if not self.test_mode:
            results.update(self.get_ann_info(index))
        if self.pipeline is not None:
            results = self.pipeline(results)
        return results


def export_2d_annotation(root, info_path, mono3d=True, out_path=None):
    """Export COCO-format 2D annotations from an info pkl.

    Reference ``tools/data_converter/kitti_converter.py:331-486``
    (``export_2d_annotation`` + ``get_2d_boxes``): per non-DontCare
    annotation (occluded state 0-3), the 2D box is the min/max of the
    3D box's camera-frame corners projected through P2, clipped to the
    image canvas (annotations whose projection misses the canvas are
    dropped). ``mono3d`` adds the camera-frame 3D box (gravity-centered)
    and the projected center+depth, dropping depth<=0 records.

    Writes ``<info_path without .pkl>.coco.json`` (or ``out_path``) and
    returns the COCO dict.
    """
    import json

    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    categories = [dict(id=i, name=n) for i, n in enumerate(CLASS_NAMES)]
    coco = dict(annotations=[], images=[], categories=categories)
    ann_id = 0
    for info in infos:
        h, w = [int(x) for x in info["image"]["image_shape"][:2]]
        P2 = np.asarray(info["calib"]["P2"], np.float64)[:3, :4]
        coco["images"].append(dict(
            file_name=info["image"]["image_path"],
            id=int(info["image"]["image_idx"]),
            Trv2c=np.asarray(info["calib"]["Tr_velo_to_cam"]).tolist(),
            rect=np.asarray(info["calib"]["R0_rect"]).tolist(),
            cam_intrinsic=P2.tolist(), width=w, height=h))
        annos = info.get("annos")
        if annos is None:
            continue
        for i in range(len(annos["name"])):
            name = str(annos["name"][i])
            if name == "DontCare" or int(annos["occluded"][i]) not in (
                    0, 1, 2, 3):
                continue
            loc = np.asarray(annos["location"][i], np.float64)
            l, hh, ww = [float(x) for x in annos["dimensions"][i]]
            ry = float(annos["rotation_y"][i])
            # gravity center (KITTI label loc is the bottom center)
            ctr = loc + np.array([0.0, -hh / 2.0, 0.0])
            # camera-frame corners: x right (l), y down (h), z forward (w)
            dx, dy, dz = l / 2.0, hh / 2.0, ww / 2.0
            sx = np.array([1, 1, 1, 1, -1, -1, -1, -1]) * dx
            sy = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * dy
            sz = np.array([1, -1, 1, -1, 1, -1, 1, -1]) * dz
            c, s = np.cos(ry), np.sin(ry)
            rx = c * sx + s * sz
            rz = -s * sx + c * sz
            corners = np.stack([ctr[0] + rx, ctr[1] + sy, ctr[2] + rz], 1)
            # As the JAX package: the 2D box is the clipped extent of the
            # projected front corners, where the reference intersects
            # their convex hull with the canvas (ADVICE.md, kitti.py:357).
            # The two differ only on boxes cut by the canvas; kept so the
            # export equals the JAX package's.
            front = corners[corners[:, 2] > 0]
            if not len(front):
                continue
            uvw = front @ P2[:, :3].T + P2[:, 3]
            uv = uvw[:, :2] / uvw[:, 2:3]
            x1, y1 = uv.min(0)
            x2, y2 = uv.max(0)
            x1, x2 = np.clip([x1, x2], 0, w)
            y1, y2 = np.clip([y1, y2], 0, h)
            if x2 <= x1 or y2 <= y1:
                continue  # projection misses the canvas
            # As the JAX package: classes outside CLASS_NAMES (Van, Tram,
            # ...) are kept with category_id -1, where the reference drops
            # them (ADVICE.md, kitti.py:366). A COCO consumer filters
            # them by category.
            rec = dict(
                file_name=info["image"]["image_path"],
                image_id=int(info["image"]["image_idx"]),
                area=float((x2 - x1) * (y2 - y1)),
                category_name=name,
                category_id=CLASS_NAMES.index(name)
                if name in CLASS_NAMES else -1,
                bbox=[float(x1), float(y1), float(x2 - x1),
                      float(y2 - y1)],
                iscrowd=0, segmentation=[], id=ann_id)
            if mono3d:
                # reference offsets x by (P2-P0) baseline; P0 has zero
                # translation in KITTI, so offset = P2[0,3]/fx
                loc3d = ctr + np.array([P2[0, 3] / P2[0, 0], 0.0, 0.0])
                rec["bbox_cam3d"] = [*loc3d.tolist(), l, hh, ww, ry]
                rec["velo_cam3d"] = -1
                c3 = ctr @ P2[:, :3].T + P2[:, 3]
                if c3[2] <= 0:
                    continue
                rec["center2d"] = [float(c3[0] / c3[2]),
                                   float(c3[1] / c3[2]), float(c3[2])]
                rec["attribute_name"] = -1
                rec["attribute_id"] = -1
            coco["annotations"].append(rec)
            ann_id += 1
    if out_path is None:
        # reference naming (kitti_converter.py:371-375)
        base = info_path[:-4] if info_path.endswith(".pkl") else info_path
        out_path = base + ("_mono3d.coco.json" if mono3d
                           else ".coco.json")
    with open(out_path, "w") as f:
        json.dump(coco, f)
    return coco
