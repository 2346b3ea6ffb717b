"""3D box geometry in numpy for the host data and evaluation layers (the
numpy branch of ``detmatch_tpu/core/geometry.py``, operation for
operation, so the data layer's outputs equal the JAX package's bit for
bit on the same inputs). The device code uses ``core/geometry.py``.

Internal 3D box convention: ``(x, y, z, dx, dy, dz, heading)`` with
``(x, y, z)`` the gravity center in the LiDAR frame (x forward, y left,
z up), full sizes along the box axes, and heading CCW around +z from +x.
Camera-frame boxes appear only at KITTI I/O
(:func:`boxes_camera_to_lidar` / :func:`boxes_lidar_to_camera`).
"""
from __future__ import annotations

import numpy as np


def limit_period(val, offset=0.5, period=np.pi):
    """Wrap ``val`` into ``[-offset*period, (1-offset)*period)``."""
    return val - np.floor(val / period + offset) * period


def rotation_matrix_z(angle):
    """(..., 3, 3) CCW rotation matrices around +z for row-vector points
    (``points @ R`` rotates x towards y)."""
    c, s = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    rot = np.stack([c, s, zeros, -s, c, zeros, zeros, zeros, ones], axis=-1)
    return rot.reshape(rot.shape[:-1] + (3, 3))


def rotate_points_z(points, angle):
    """Rotate (..., N, 3 + C) points CCW around +z by a broadcastable
    batch of angles; extra channels pass through."""
    angle = np.asarray(angle)
    c = np.cos(angle)[..., None]
    s = np.sin(angle)[..., None]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    xr = x * c - y * s
    yr = x * s + y * c
    xyz = np.stack([xr, yr, z], axis=-1)
    return np.concatenate([xyz, points[..., 3:]], axis=-1)


# Corner template in pcdet order (pcdet/utils/box_utils.py:28-53).
_CORNER_TEMPLATE = np.array(
    [
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
    ],
    dtype=np.float32,
) / 2.0


def boxes_to_corners_3d(boxes):
    """(N, 7[+]) boxes → (N, 8, 3) corners, pcdet corner order."""
    template = np.asarray(_CORNER_TEMPLATE, dtype=boxes.dtype)
    corners = boxes[:, None, 3:6] * template[None, :, :]
    corners = rotate_points_z(corners, boxes[:, 6])
    return corners + boxes[:, None, 0:3]


def boxes_to_corners_bev(boxes):
    """(N, 5|7) BEV boxes → (N, 4, 2) corners, counter-clockwise."""
    if boxes.shape[-1] >= 7:
        cxy, dxy, ang = boxes[:, 0:2], boxes[:, 3:5], boxes[:, 6]
    else:
        cxy, dxy, ang = boxes[:, 0:2], boxes[:, 2:4], boxes[:, 4]
    template = np.asarray(
        np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], dtype=np.float32) / 2.0,
        dtype=boxes.dtype,
    )
    corners = dxy[:, None, :] * template[None, :, :]
    c, s = np.cos(ang), np.sin(ang)
    x = corners[..., 0] * c[:, None] - corners[..., 1] * s[:, None]
    y = corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
    return np.stack([x, y], axis=-1) + cxy[:, None, :]


def boxes_to_bev(boxes):
    """(N, 7) → (N, 5) (cx, cy, dx, dy, heading)."""
    return np.concatenate([boxes[:, 0:2], boxes[:, 3:5], boxes[:, 6:7]],
                          axis=-1)


def points_in_boxes(points, boxes):
    """(N, 3) points, (M, 7) boxes → (M, N) bool, box-major."""
    local = points[None, :, :3] - boxes[:, None, 0:3]
    local = rotate_points_z(local, -boxes[:, 6])
    half = boxes[:, None, 3:6] / 2.0
    return np.all(np.abs(local) <= half, axis=-1)


def flip_boxes(boxes, axis="x"):
    """Mirror boxes across a vertical plane: ``"x"`` across the x-z plane
    (y → −y, heading → −heading), ``"y"`` across the y-z plane
    (x → −x, heading → π − heading)."""
    x, y, z = boxes[:, 0:1], boxes[:, 1:2], boxes[:, 2:3]
    dims = boxes[:, 3:6]
    yaw = boxes[:, 6:7]
    rest = boxes[:, 7:]
    if axis == "x":
        y, yaw = -y, -yaw
    elif axis == "y":
        x, yaw = -x, np.pi - yaw
    else:
        raise ValueError(axis)
    return np.concatenate([x, y, z, dims, yaw, rest], axis=-1)


def flip_points(points, axis="x"):
    if axis == "x":
        sign = np.asarray([1.0, -1.0, 1.0], dtype=points.dtype)
    elif axis == "y":
        sign = np.asarray([-1.0, 1.0, 1.0], dtype=points.dtype)
    else:
        raise ValueError(axis)
    xyz = points[..., :3] * sign
    return np.concatenate([xyz, points[..., 3:]], axis=-1)


def boxes_camera_to_lidar(boxes_cam, r0_inv_v2c_inv):
    """KITTI rect-camera boxes (x, y, z bottom center, l, h, w, ry) →
    internal LiDAR boxes, through the (4, 4) rect-camera → LiDAR matrix."""
    xyz_cam, l, h, w, ry = (
        boxes_cam[:, 0:3], boxes_cam[:, 3:4], boxes_cam[:, 4:5],
        boxes_cam[:, 5:6], boxes_cam[:, 6:7],
    )
    ones = np.ones_like(xyz_cam[:, :1])
    xyz_lidar = (np.concatenate([xyz_cam, ones], axis=-1)
                 @ r0_inv_v2c_inv.T)[:, :3]
    z = xyz_lidar[:, 2:3] + h / 2.0  # bottom → gravity center
    heading = -(ry + np.pi / 2.0)
    return np.concatenate([xyz_lidar[:, 0:2], z, l, w, h, heading], axis=-1)


def boxes_lidar_to_camera(boxes_lidar, r0_v2c):
    """Internal LiDAR boxes → KITTI rect-camera boxes (inverse of
    :func:`boxes_camera_to_lidar`), through ``R0 @ Tr_velo_to_cam``."""
    xyz = boxes_lidar[:, 0:3]
    l, w, h = boxes_lidar[:, 3:4], boxes_lidar[:, 4:5], boxes_lidar[:, 5:6]
    heading = boxes_lidar[:, 6:7]
    xyz = np.concatenate([xyz[:, 0:2], xyz[:, 2:3] - h / 2.0], axis=-1)
    ones = np.ones_like(xyz[:, :1])
    xyz_cam = (np.concatenate([xyz, ones], axis=-1) @ r0_v2c.T)[:, :3]
    ry = -heading - np.pi / 2.0
    return np.concatenate([xyz_cam, l, h, w, ry], axis=-1)


def project_to_image(pts_3d, proj_mat):
    """(..., 3) LiDAR points through the (4, 4) lidar → image matrix →
    (pixels (..., 2), camera depth (...))."""
    ones = np.ones_like(pts_3d[..., :1])
    hom = np.concatenate([pts_3d, ones], axis=-1) @ proj_mat.T
    depth = hom[..., 2]
    eps = 1e-6
    denom = np.where(np.abs(depth) < eps, eps, depth)
    return hom[..., 0:2] / denom[..., None], depth


def boxes_3d_to_2d(boxes, proj_mat, img_shape=None, min_depth=0.5,
                   min_corners=3):
    """(N, 7) boxes → (xyxy (N, 4), valid (N,)): the bounding rectangle
    of the projected corners, clipped to ``img_shape`` (h, w); valid where
    the center's depth is at least ``min_depth`` and at least
    ``min_corners`` corners fall inside the image."""
    corners = boxes_to_corners_3d(boxes)
    pts2d, depth = project_to_image(corners, proj_mat)
    _, cdepth = project_to_image(boxes[:, 0:3], proj_mat)
    x1y1 = np.min(pts2d, axis=1)
    x2y2 = np.max(pts2d, axis=1)
    bboxes = np.concatenate([x1y1, x2y2], axis=-1)
    valid = cdepth >= min_depth
    if img_shape is not None:
        h, w = img_shape[0], img_shape[1]
        inside = (
            (pts2d[..., 0] >= 0) & (pts2d[..., 0] < w)
            & (pts2d[..., 1] >= 0) & (pts2d[..., 1] < h)
            & (depth > 0)
        )
        valid = valid & (np.sum(inside.astype(bboxes.dtype), axis=1)
                         >= min_corners)
        lo = np.zeros((4,), dtype=bboxes.dtype)
        hi = np.asarray([w, h, w, h], dtype=bboxes.dtype)
        bboxes = np.clip(bboxes, lo, hi)
    return bboxes, valid


def mask_boxes_outside_range(boxes, limit_range, min_num_corners=1):
    """Boxes with at least ``min_num_corners`` corners inside the range."""
    corners = boxes_to_corners_3d(boxes[:, :7])
    lo = np.asarray(limit_range[0:3], dtype=boxes.dtype)
    hi = np.asarray(limit_range[3:6], dtype=boxes.dtype)
    ok = np.all((corners >= lo) & (corners <= hi), axis=2)
    return np.sum(ok.astype(np.int32), axis=1) >= min_num_corners


def mask_points_by_range(points, limit_range):
    """BEV x/y range mask of (N, 3+) points."""
    return (
        (points[:, 0] >= limit_range[0]) & (points[:, 0] <= limit_range[3])
        & (points[:, 1] >= limit_range[1]) & (points[:, 1] <= limit_range[4])
    )


def in_range_bev(boxes, limit_range):
    """Box centers strictly inside the BEV range."""
    return (
        (boxes[:, 0] > limit_range[0]) & (boxes[:, 1] > limit_range[1])
        & (boxes[:, 0] < limit_range[3]) & (boxes[:, 1] < limit_range[4])
    )
