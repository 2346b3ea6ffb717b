"""Synthetic KITTI LiDAR frames (counterpart of
``detmatch_tpu/utils/synth_kitti.py``; the same seed gives the same
frames, bit for bit).

Uniform-random points understate real voxel load: 16k uniform points
over the KITTI range fill ~16k distinct 5 cm voxels scattered in 3D,
while a real HDL-64 frame puts its voxels on 2D surfaces (ground plane
and object faces). This module ray-casts the HDL-64 beam geometry
(64 elevation rings x ~0.18 deg azimuth) against a ground plane and
randomly placed boxes (cars, pedestrians, walls), so the points lie on
surfaces as in a real scan. :func:`gt_boxes` draws GT boxes as the JAX
benchmark does, and :func:`ssl_view` a whole multimodal SSL view (the
JAX benchmark's ``make_view``). :func:`write_kitti_tree` writes such
scans as a KITTI tree on disk (velodyne, calib, label_2, image_2), the
labels derived from the scene's boxes through the calibration. Used by
``chip_smoke.py`` and the port's tests; not part of the training path.
"""
from __future__ import annotations

import os

import numpy as np

from .visualize import CAFFE_MEAN, write_png

LIDAR_HEIGHT = 1.73  # KITTI velodyne height above ground (m)


def _ray_dirs(fov_deg=(-45.0, 45.0), n_azimuth=500, n_beams=64,
              elev_deg=(-24.8, 2.0)):
    az = np.radians(np.linspace(fov_deg[0], fov_deg[1], n_azimuth))
    el = np.radians(np.linspace(elev_deg[0], elev_deg[1], n_beams))
    azg, elg = np.meshgrid(az, el)
    d = np.stack([np.cos(elg) * np.cos(azg),
                  np.cos(elg) * np.sin(azg),
                  np.sin(elg)], axis=-1).reshape(-1, 3)
    return d.astype(np.float64)


def _box_hits(dirs, centers, sizes, yaws):
    """First-hit distance of each ray against each oriented box (slab
    method in the box frame). Returns (R,) min positive t (inf = miss)."""
    t_min = np.full((dirs.shape[0],), np.inf)
    for c, s, yaw in zip(centers, sizes, yaws):
        cos, sin = np.cos(-yaw), np.sin(-yaw)
        rot = np.array([[cos, -sin, 0.0], [sin, cos, 0.0], [0.0, 0.0, 1.0]])
        o = rot @ (-c)                      # ray origin in box frame
        d = dirs @ rot.T
        half = s / 2.0
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (-half - o) / d
            t2 = (half - o) / d
        near = np.nanmax(np.minimum(t1, t2), axis=1)
        far = np.nanmin(np.maximum(t1, t2), axis=1)
        hit = (near <= far) & (far > 0.1) & (near > 0.1)
        t_min = np.where(hit & (near < t_min), near, t_min)
    return t_min


def lidar_scene(rng, num_points, point_cloud_range,
                num_cars=14, num_peds=8, num_walls=3, max_range=72.0):
    """One synthetic HDL-64 frame.

    Returns (points (num_points, 4) float32, valid (num_points,) bool) —
    padded / subsampled to exactly num_points, xyz + reflectance, points
    inside ``point_cloud_range``.
    """
    return lidar_scene_objects(rng, num_points, point_cloud_range, num_cars,
                               num_peds, num_walls, max_range)[:2]


def lidar_scene_objects(rng, num_points, point_cloud_range,
                        num_cars=14, num_peds=8, num_walls=3,
                        max_range=72.0, n_azimuth=500):
    """:func:`lidar_scene` (the same ``rng`` calls in the same order),
    also returning the scene's objects: (points, valid, boxes
    (num_cars + num_peds, 7) float32 in the internal convention (gravity
    center, dx, dy, dz, heading), names), the walls left out.
    ``n_azimuth`` rays a beam over the 90 degrees in front."""
    dirs = _ray_dirs(n_azimuth=n_azimuth)

    # ground-plane hits (z = -LIDAR_HEIGHT, rays pointing down)
    dz = dirs[:, 2]
    with np.errstate(divide="ignore"):
        t_ground = np.where(dz < -1e-6, -LIDAR_HEIGHT / dz, np.inf)

    # scene objects: cars, pedestrians, and wall slabs at the sides
    centers, sizes, yaws = [], [], []
    for _ in range(num_cars):
        centers.append([rng.uniform(6, 66), rng.uniform(-32, 32),
                        -LIDAR_HEIGHT + 0.78])
        sizes.append([3.9 * rng.uniform(0.9, 1.1),
                      1.6 * rng.uniform(0.9, 1.1), 1.56])
        yaws.append(rng.uniform(-np.pi, np.pi))
    for _ in range(num_peds):
        centers.append([rng.uniform(4, 40), rng.uniform(-20, 20),
                        -LIDAR_HEIGHT + 0.87])
        sizes.append([0.8, 0.6, 1.73])
        yaws.append(rng.uniform(-np.pi, np.pi))
    for _ in range(num_walls):
        side = rng.choice([-1.0, 1.0])
        centers.append([rng.uniform(15, 60), side * rng.uniform(12, 38),
                        -LIDAR_HEIGHT + 1.5])
        sizes.append([rng.uniform(8, 25), 0.4, 3.0])
        yaws.append(rng.uniform(-0.3, 0.3))
    t_box = _box_hits(dirs, np.array(centers), np.array(sizes),
                      np.array(yaws))

    t = np.minimum(t_ground, t_box)
    ret = np.isfinite(t) & (t < max_range)
    pts = dirs[ret] * t[ret, None]
    pts += rng.normal(0.0, 0.012, pts.shape)          # range noise
    refl = rng.uniform(0.0, 1.0, (pts.shape[0], 1))
    pts = np.concatenate([pts, refl], axis=1)

    pcr = np.asarray(point_cloud_range)
    keep = np.all((pts[:, :3] >= pcr[:3]) & (pts[:, :3] < pcr[3:]), axis=1)
    pts = pts[keep]

    if pts.shape[0] >= num_points:
        sel = rng.choice(pts.shape[0], num_points, replace=False)
        out = pts[sel]
        valid = np.ones((num_points,), bool)
    else:
        pad = np.zeros((num_points - pts.shape[0], 4))
        out = np.concatenate([pts, pad], axis=0)
        valid = np.zeros((num_points,), bool)
        valid[: pts.shape[0]] = True
    n_obj = num_cars + num_peds
    boxes = np.concatenate([np.array(centers[:n_obj]),
                            np.array(sizes[:n_obj]),
                            np.array(yaws[:n_obj])[:, None]], 1)
    names = ["Car"] * num_cars + ["Pedestrian"] * num_peds
    return out.astype(np.float32), valid, boxes.astype(np.float32), names


def lidar_batch(rng, b, num_points, point_cloud_range):
    """(b, P, 4) float32 points + (b, P) bool valid."""
    pts, valid = zip(*[lidar_scene(rng, num_points, point_cloud_range)
                       for _ in range(b)])
    return np.stack(pts), np.stack(valid)


def gt_boxes(rng, b, g=40, n=20):
    """(b, g, 8) float32 GT boxes, the first ``n`` rows valid: car-sized
    boxes at random x, y and heading with random 1-based classes, rows
    past ``n`` zero — the JAX benchmark's GT draw
    (``detmatch_tpu/benchmarks.py:84-93``), the same ``rng`` calls in the
    same order."""
    gt = np.zeros((b, g, 8), np.float32)
    gt[:, :n, 0] = rng.rand(b, n) * 60 + 3
    gt[:, :n, 1] = rng.rand(b, n) * 70 - 35
    gt[:, :n, 2] = -1.0
    gt[:, :n, 3:6] = [3.9, 1.6, 1.56]
    gt[:, :n, 6] = rng.rand(b, n) - 0.5
    gt[:, :n, 7] = rng.randint(1, 4, (b, n))
    return gt


# the JAX benchmark's KITTI range, image and calibration
# (``detmatch_tpu/benchmarks.py:47, 56-80``)
SSL_PCR = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
SSL_LIDAR2IMG = np.array([[0, -700, 0, 6200], [0, 0, -700, 1800],
                          [1, 0, 0, 0], [0, 0, 0, 1]], np.float32)


def ssl_view(rng, b, p, canvas, with_gt=False):
    """One multimodal view of ``b`` frames as numpy arrays: ``p``-point
    synthetic scans, a random (B, H, W, 3) image on the ``canvas``
    (h, w), KITTI's 375 x 1242 original shape, a fixed lidar-to-image
    matrix and identity augmentation records (``aug3d`` / ``aug2d`` dicts
    of the ``Aug3D`` / ``Aug2D`` fields); with ``with_gt`` also a labeled
    view's 40-slot ground truth (20 valid): 3D boxes (:func:`gt_boxes`),
    60-pixel 2D boxes, 0-based 2D labels and their validity. The JAX
    benchmark's ``make_view`` (``benchmarks.py:84-102``): the same ``rng``
    calls in the same order."""
    pts, pvalid = lidar_batch(rng, b, p, SSL_PCR)
    view = dict(
        points=pts,
        points_valid=pvalid,
        img=rng.randn(b, *canvas, 3).astype(np.float32),
        img_shape=np.tile([[canvas[0], canvas[1]]], (b, 1)
                          ).astype(np.float32),
        ori_shape=np.tile([[375.0, 1242.0]], (b, 1)).astype(np.float32),
        lidar2img=np.tile(SSL_LIDAR2IMG[None], (b, 1, 1)),
        aug3d=dict(flip_x=np.zeros((b,), np.float32),
                   rot=np.zeros((b,), np.float32),
                   scale=np.ones((b,), np.float32),
                   trans=np.zeros((b, 3), np.float32)),
        aug2d=dict(scale=np.ones((b, 4), np.float32),
                   flip=np.zeros((b,), np.float32),
                   img_w=np.full((b,), canvas[1], np.float32)),
    )
    if with_gt:
        g, n = 40, 20
        view["gt_boxes"] = gt_boxes(rng, b, g, n)
        g2 = np.zeros((b, g, 4), np.float32)
        g2[:, :n, :2] = rng.rand(b, n, 2) * 400
        g2[:, :n, 2:] = g2[:, :n, :2] + 60
        view["gt_boxes2d"] = g2
        view["gt_labels2d"] = rng.randint(0, 3, (b, g)).astype(np.int32)
        view["gt2d_valid"] = np.arange(g)[None, :].repeat(b, 0) < n
    return view


# A KITTI-like calibration (P2, R0_rect, Tr_velo_to_cam), the one of
# ``tests/kitti_fixture.py``.
CALIB = dict(
    P2=np.array([[707.0, 0.0, 604.0, 45.75], [0.0, 707.0, 180.0, -0.345],
                 [0.0, 0.0, 1.0, 0.005]]),
    R0_rect=np.array([[0.9999, 0.0098, -0.0074], [-0.0099, 0.9999, -0.0043],
                      [0.0074, 0.0044, 1.0]]),
    Tr_velo_to_cam=np.array([[0.0075, -0.9999, -0.0006, -0.0040],
                             [0.0148, 0.0007, -0.9998, -0.0767],
                             [0.9998, 0.0075, 0.0148, -0.2717]]))
CLASS_COLOR = {"Car": (220, 40, 40), "Pedestrian": (40, 220, 40)}


def _pad44(m):
    out = np.eye(4)
    out[:m.shape[0], :m.shape[1]] = m
    return out


def _corners(boxes):
    """(N, 7) internal boxes → (N, 8, 3) corners."""
    signs = np.array([[sx, sy, sz] for sx in (1, -1) for sy in (1, -1)
                      for sz in (1, -1)], np.float64) / 2.0
    local = boxes[:, None, 3:6] * signs[None]
    c, s = np.cos(boxes[:, 6])[:, None], np.sin(boxes[:, 6])[:, None]
    x = local[..., 0] * c - local[..., 1] * s
    y = local[..., 0] * s + local[..., 1] * c
    return np.stack([x, y, local[..., 2]], -1) + boxes[:, None, :3]


def _labels(boxes, names, image_shape):
    """KITTI label lines of the objects whose projection lands in the
    image (center depth at least 1 m), and their 2D boxes."""
    rect = _pad44(CALIB["R0_rect"]) @ _pad44(CALIB["Tr_velo_to_cam"])
    proj = _pad44(CALIB["P2"]) @ rect
    h_img, w_img = image_shape
    lines, drawn = [], []
    for box, name in zip(boxes.astype(np.float64), names):
        corners = _corners(box[None])[0]
        uvw = np.concatenate([corners, np.ones((8, 1))], 1) @ proj.T
        bottom = np.append(box[:3] - [0.0, 0.0, box[5] / 2.0], 1.0) @ rect.T
        if bottom[2] < 1.0 or (uvw[:, 2] <= 0.1).any():
            continue
        uv = uvw[:, :2] / uvw[:, 2:3]
        x1, y1 = np.maximum(uv.min(0), 0.0)
        x2, y2 = np.minimum(uv.max(0), [w_img, h_img])
        if x2 - x1 < 2 or y2 - y1 < 2:
            continue
        x, y, z = bottom[:3]
        ry = -box[6] - np.pi / 2.0
        ry = (ry + np.pi) % (2 * np.pi) - np.pi
        alpha = ry - np.arctan2(x, z)
        lines.append(f"{name} 0.00 0 {alpha:.2f} {x1:.2f} {y1:.2f} "
                     f"{x2:.2f} {y2:.2f} {box[5]:.2f} {box[4]:.2f} "
                     f"{box[3]:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}")
        drawn.append((name, (x1, y1, x2, y2)))
    return lines, drawn


def calib_text():
    """:data:`CALIB` as a KITTI ``calib/<frame>.txt``."""
    return "".join(
        f"{k}: " + " ".join(f"{v:.6g}" for v in CALIB[k].ravel()) + "\n"
        for k in ("P2", "R0_rect", "Tr_velo_to_cam"))


def write_kitti_tree(root, n_frames, seed=0, image_shape=(375, 1242),
                     num_points=40000, n_azimuth=500):
    """Write ``n_frames`` synthetic frames under ``root/training``: the
    HDL-64 scan of :func:`lidar_scene_objects` (every point in the KITTI
    range, to ``velodyne/`` and ``velodyne_reduced/``), the calibration
    :data:`CALIB`, the labels of the cars and pedestrians that project
    into the image (through the calibration, so the dataset's loader
    recovers the scene's boxes to the labels' two decimals), and a
    ``image_shape`` PNG with those objects drawn in their class colors.
    ``num_points`` and ``n_azimuth`` as :func:`lidar_scene_objects`'s.
    Returns the frame ids ("000000", ...)."""
    rng = np.random.RandomState(seed)
    sub = os.path.join(root, "training")
    for d in ("velodyne", "velodyne_reduced", "calib", "label_2",
              "image_2"):
        os.makedirs(os.path.join(sub, d), exist_ok=True)
    calib_txt = calib_text()
    ids = []
    for i in range(n_frames):
        idx = f"{i:06d}"
        ids.append(idx)
        pts, valid, boxes, names = lidar_scene_objects(
            rng, num_points, SSL_PCR, n_azimuth=n_azimuth)
        for d in ("velodyne", "velodyne_reduced"):
            pts[valid].tofile(os.path.join(sub, d, f"{idx}.bin"))
        with open(os.path.join(sub, "calib", f"{idx}.txt"), "w") as f:
            f.write(calib_txt)
        lines, drawn = _labels(boxes, names, image_shape)
        with open(os.path.join(sub, "label_2", f"{idx}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        img = rng.randint(40, 80, (*image_shape, 3)).astype(np.uint8)
        for name, (x1, y1, x2, y2) in drawn:
            img[int(y1):int(y2), int(x1):int(x2)] = CLASS_COLOR[name]
        write_png(os.path.join(sub, "image_2", f"{idx}.png"), img)
    return ids


# CaDDN's range (JAX ``caddn.py``: 2 - 46.8 m ahead, +-30.08 m aside)
CADDN_PCR = (2.0, -30.08, -3.0, 46.8, 30.08, 1.0)
CLASS_ID = {"Pedestrian": 1, "Cyclist": 2, "Car": 3}  # the anchors' order


def caddn_view(rng, b, canvas=(384, 1280), num_points=18000, downsample=4):
    """A monocular training batch for CaDDN as numpy arrays, ``b`` scenes
    of :func:`lidar_scene_objects` in ``CADDN_PCR`` seen through
    :data:`CALIB` on a ``canvas`` (h, w): images (B, H, W, 3) caffe BGR
    (a gray ground with the objects' projections in their class colors,
    the mean subtracted), lidar2cam (B, 4, 4) = R0_rect @ Tr_velo_to_cam,
    cam2img (B, 3, 4) = P2, gt_boxes (B, G, 8) (1-based classes, zero
    rows padding), gt_boxes2d (B, G, 4): each box's projection clipped to
    the image (zero where it does not project), depth_maps (B, H / d,
    W / d): the nearest scan point's camera depth in each
    ``downsample``-pixel cell, 0 where none lands (a target out of
    range)."""
    rect = _pad44(CALIB["R0_rect"]) @ _pad44(CALIB["Tr_velo_to_cam"])
    proj = _pad44(CALIB["P2"]) @ rect
    h, w = canvas
    hf, wf = -(-h // downsample), -(-w // downsample)
    scenes = [lidar_scene_objects(rng, num_points, CADDN_PCR)
              for _ in range(b)]
    g = max(len(s[2]) for s in scenes)
    images = np.empty((b, h, w, 3), np.float32)
    gt = np.zeros((b, g, 8), np.float32)
    gt2 = np.zeros((b, g, 4), np.float32)
    depth = np.zeros((b, hf, wf), np.float32)
    for i, (pts, valid, boxes, names) in enumerate(scenes):
        n = len(boxes)
        gt[i, :n, :7] = boxes
        gt[i, :n, 7] = [CLASS_ID[x] for x in names]
        img = rng.randint(40, 80, (h, w, 3)).astype(np.float32)
        for j, box in enumerate(boxes.astype(np.float64)):
            uvw = np.concatenate([_corners(box[None])[0], np.ones((8, 1))],
                                 1) @ proj.T
            if (uvw[:, 2] <= 0.1).any():
                continue
            uv = uvw[:, :2] / uvw[:, 2:3]
            x1, y1 = np.maximum(uv.min(0), 0.0)
            x2, y2 = np.minimum(uv.max(0), [w, h])
            if x2 - x1 < 2 or y2 - y1 < 2:
                continue
            gt2[i, j] = x1, y1, x2, y2
            img[int(y1):int(y2), int(x1):int(x2)] = CLASS_COLOR[names[j]][
                ::-1]
        images[i] = img - CAFFE_MEAN
        p = np.concatenate([pts[valid, :3], np.ones((valid.sum(), 1))],
                           1) @ proj.T
        z = p[:, 2]
        ok = z > 0.1
        u = np.floor(p[ok, 0] / z[ok] / downsample).astype(np.int64)
        v = np.floor(p[ok, 1] / z[ok] / downsample).astype(np.int64)
        inside = (u >= 0) & (u < wf) & (v >= 0) & (v < hf)
        cell = np.full(hf * wf, np.inf)
        np.minimum.at(cell, v[inside] * wf + u[inside], z[ok][inside])
        depth[i] = np.where(np.isfinite(cell), cell, 0.0).reshape(hf, wf)
    return dict(images=images,
                lidar2cam=np.tile(rect[None].astype(np.float32), (b, 1, 1)),
                cam2img=np.tile(CALIB["P2"][None].astype(np.float32),
                                (b, 1, 1)),
                gt_boxes=gt, gt_boxes2d=gt2, depth_maps=depth)
