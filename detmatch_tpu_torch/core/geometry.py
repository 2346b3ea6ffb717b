"""3D box geometry (counterpart of ``detmatch_tpu/core/geometry.py``, the
parts the PV-RCNN inference and training paths and the DetMatch teacher
phase call).

Box convention: (x, y, z, dx, dy, dz, heading) — gravity center in the
LiDAR frame, full sizes, heading CCW around +z from +x.
"""
from __future__ import annotations

import numpy as np
import torch


def limit_period(val, offset=0.5, period=np.pi):
    """Wrap ``val`` into ``[-offset*period, (1-offset)*period)``."""
    return val - torch.floor(val / period + offset) * period


def rotate_points_z(points, angle):
    """Rotate (..., N, 3 + C) points CCW around +z by (...) angles; extra
    channels pass through."""
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    xyz = torch.stack([x * c - y * s, x * s + y * c, z], dim=-1)
    return torch.cat([xyz, points[..., 3:]], dim=-1)


_BEV_TEMPLATE = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]],
                         dtype=np.float32) / 2.0


def boxes_to_corners_bev(boxes):
    """(N, 5|7) BEV boxes → (N, 4, 2) corners, counter-clockwise."""
    if boxes.shape[-1] >= 7:
        cxy, dxy, ang = boxes[:, 0:2], boxes[:, 3:5], boxes[:, 6]
    else:
        cxy, dxy, ang = boxes[:, 0:2], boxes[:, 2:4], boxes[:, 4]
    template = torch.as_tensor(_BEV_TEMPLATE, dtype=boxes.dtype,
                               device=boxes.device)
    corners = dxy[:, None, :] * template[None]
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x = corners[..., 0] * c - corners[..., 1] * s
    y = corners[..., 0] * s + corners[..., 1] * c
    return torch.stack([x, y], dim=-1) + cxy[:, None, :]


def boxes_to_bev(boxes):
    """(N, 7) → (N, 5) (cx, cy, dx, dy, heading)."""
    return torch.cat([boxes[:, 0:2], boxes[:, 3:5], boxes[:, 6:7]], dim=-1)


# pcdet corner order: 0-3 the bottom face, 4-7 the top face
_CORNER_TEMPLATE = np.array(
    [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
     [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]],
    dtype=np.float32) / 2.0


def boxes_to_corners_3d(boxes):
    """(N, 7[+]) boxes → (N, 8, 3) corners, pcdet corner order."""
    template = torch.as_tensor(_CORNER_TEMPLATE, dtype=boxes.dtype,
                               device=boxes.device)
    corners = boxes[:, None, 3:6] * template[None]
    return rotate_points_z(corners, boxes[:, 6]) + boxes[:, None, 0:3]


def boxes_to_aligned_bev(boxes):
    """(N, 7) → (N, 4) axis-aligned BEV xyxy: dx/dy swapped when the
    heading is nearer the y axis (pcdet
    ``boxes3d_lidar_to_aligned_bev_boxes``)."""
    rot = limit_period(boxes[:, 6], offset=0.5, period=np.pi)
    cond = (torch.abs(rot) > np.pi / 4)[..., None]
    dxy = torch.where(cond, boxes[:, [4, 3]], boxes[:, [3, 4]])
    return torch.cat([boxes[:, 0:2] - dxy / 2, boxes[:, 0:2] + dxy / 2],
                     dim=-1)


def points_in_boxes(points, boxes):
    """(N, 3) points, (M, 7) boxes → (M, N) bool, box-major."""
    local = points[None, :, :3] - boxes[:, None, 0:3]
    local = rotate_points_z(local, -boxes[:, 6])
    half = boxes[:, None, 3:6] / 2.0
    return (torch.abs(local) <= half).all(dim=-1)


def enlarge_boxes(boxes, extra_width):
    """Grow each box's full sizes by ``2 * extra_width`` per axis (pcdet
    ``enlarge_box3d``)."""
    ew = torch.as_tensor(extra_width, dtype=boxes.dtype, device=boxes.device)
    return torch.cat([boxes[:, 0:3], boxes[:, 3:6] + ew * 2.0, boxes[:, 6:]],
                     dim=-1)


def project_to_image(pts_3d, proj_mat):
    """(..., 3) LiDAR points through the (4, 4) ``lidar2img`` matrix →
    (pixels (..., 2), camera depth (...)); a depth within 1e-6 of zero
    divides by 1e-6."""
    ones = torch.ones_like(pts_3d[..., :1])
    hom = torch.cat([pts_3d, ones], dim=-1) @ proj_mat.T
    depth = hom[..., 2]
    denom = torch.where(depth.abs() < 1e-6, 1e-6, depth)
    return hom[..., 0:2] / denom[..., None], depth


def boxes_3d_to_2d(boxes, proj_mat, img_shape=None, min_depth=0.5,
                   min_corners=3):
    """(N, 7) boxes → (xyxy (N, 4), valid (N,)): the bounding rectangle of
    the 8 projected corners; valid where the center's depth is >=
    ``min_depth`` and, given ``img_shape`` (an (h, w) tensor), at least
    ``min_corners`` corners land inside the image, the boxes then clipped
    to it; ``img_shape=None`` skips the inside test and the clip."""
    corners = boxes_to_corners_3d(boxes)
    pts2d, depth = project_to_image(corners, proj_mat)
    _, cdepth = project_to_image(boxes[:, 0:3], proj_mat)
    bboxes = torch.cat([pts2d.amin(1), pts2d.amax(1)], dim=-1)
    valid = cdepth >= min_depth
    if img_shape is not None:
        h, w = img_shape[0], img_shape[1]
        inside = ((pts2d[..., 0] >= 0) & (pts2d[..., 0] < w)
                  & (pts2d[..., 1] >= 0) & (pts2d[..., 1] < h)
                  & (depth > 0))
        valid = valid & (inside.to(bboxes.dtype).sum(1) >= min_corners)
        hi = torch.stack([w, h, w, h]).to(bboxes.dtype)
        bboxes = torch.minimum(torch.clamp(bboxes, min=0), hi)
    return bboxes, valid
