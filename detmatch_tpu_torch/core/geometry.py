"""3D box geometry (counterpart of ``detmatch_tpu/core/geometry.py``, the
parts the inference slice calls).

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
