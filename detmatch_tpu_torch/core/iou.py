"""Axis-aligned 2D IoU / IoF / GIoU, rotated BEV overlap and IoU, and 3D IoU
(counterpart of ``detmatch_tpu/core/iou.py``).

Convex intersection of two quads: candidate vertices are the 16 edge-pair
intersections plus the corners of each quad inside the other, sorted by
angle around their mean, then shoelace. Per-pair quantities live in
stacked (K, M, N) planes, in the same operation order as the reference.
"""
from __future__ import annotations

import torch

from . import geometry

EPS = 1e-8


def quantize(ious, bits=20):
    """Snap IoU values to a 2^-bits grid, so ties resolve identically
    whatever the last-ulp noise of the program that computed them."""
    scale = float(2.0 ** bits)
    return torch.round(ious * scale) * (1.0 / scale)


def area2d(boxes):
    """(..., 4) xyxy → (...) area, clamped at 0."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)
    return w * h


def iou2d(boxes1, boxes2, mode="iou", aligned=False, eps=1e-6):
    """Axis-aligned IoU / IoF / GIoU between xyxy boxes.

    Args:
        boxes1: (N, 4); boxes2: (M, 4) (or (N, 4) each if ``aligned``).
        mode: "iou" | "iof" | "giou".
    Returns:
        (N, M), or (N,) if ``aligned``.
    """
    if aligned:
        b1, b2 = boxes1, boxes2
    else:
        b1, b2 = boxes1[:, None, :], boxes2[None, :, :]
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = area2d(b1)
    union = a1 if mode == "iof" else a1 + area2d(b2) - inter
    union = torch.clamp(union, min=eps)
    iou = inter / union
    if mode != "giou":
        return iou
    elt = torch.minimum(b1[..., :2], b2[..., :2])
    erb = torch.maximum(b1[..., 2:], b2[..., 2:])
    ewh = torch.clamp(erb - elt, min=0)
    earea = torch.clamp(ewh[..., 0] * ewh[..., 1], min=eps)
    return iou - (earea - union) / earea


def rotated_overlap_block(c1, c2):
    """(M, 4, 2), (N, 4, 2) CCW corners → (M, N) intersection areas."""
    m, n = c1.shape[0], c2.shape[0]
    ax = c1[:, :, 0].T[:, :, None]  # (4, M, 1)
    ay = c1[:, :, 1].T[:, :, None]
    bx = c2[:, :, 0].T[:, None, :]  # (4, 1, N)
    by = c2[:, :, 1].T[:, None, :]
    ax2, ay2 = torch.roll(ax, -1, 0), torch.roll(ay, -1, 0)
    bx2, by2 = torch.roll(bx, -1, 0), torch.roll(by, -1, 0)

    # 16 edge-pair intersections on a (4, 4, M, N) grid
    px, py = ax[:, None], ay[:, None]
    qx, qy = (ax2 - ax)[:, None], (ay2 - ay)[:, None]
    rx, ry = bx[None], by[None]
    sx, sy = (bx2 - bx)[None], (by2 - by)[None]
    denom = qx * sy - qy * sx
    dx, dy = rx - px, ry - py
    t = dx * sy - dy * sx
    u = dx * qy - dy * qx
    small = torch.abs(denom) < EPS
    safe = torch.where(small, 1.0, denom)
    t = t / safe
    u = u / safe
    iok = (~small) & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    inter_x = (px + t * qx).expand(4, 4, m, n).reshape(16, m, n)
    inter_y = (py + t * qy).expand(4, 4, m, n).reshape(16, m, n)
    inter_ok = iok.expand(4, 4, m, n).reshape(16, m, n)

    # corners of A inside B and vice versa
    cross_a = ((bx2 - bx)[None] * (ay[:, None] - by[None])
               - (by2 - by)[None] * (ax[:, None] - bx[None]))
    a_in = (cross_a >= -1e-6).all(dim=1)  # (4, M, N)
    cross_b = ((ax2 - ax)[None] * (by[:, None] - ay[None])
               - (ay2 - ay)[None] * (bx[:, None] - ax[None]))
    b_in = (cross_b >= -1e-6).all(dim=1)

    cand_x = torch.cat([inter_x, ax.expand(4, m, n), bx.expand(4, m, n)])
    cand_y = torch.cat([inter_y, ay.expand(4, m, n), by.expand(4, m, n)])
    cand_ok = torch.cat([inter_ok, a_in, b_in])  # (24, M, N)

    okf = cand_ok.to(c1.dtype)
    cnt = okf.sum(0)
    norm = torch.clamp(cnt, min=1.0)
    cx0 = (cand_x * okf).sum(0) / norm
    cy0 = (cand_y * okf).sum(0) / norm

    big = 1e9
    ang = torch.where(cand_ok, torch.atan2(cand_y - cy0, cand_x - cx0), big)
    ang_s, order = torch.sort(ang, dim=0, stable=True)
    xs = torch.gather(cand_x, 0, order)
    ys = torch.gather(cand_y, 0, order)

    # invalid slots → first (valid) vertex, making the shoelace wrap exact
    vmask = ang_s < big / 2
    p0x = torch.where(vmask[0], xs[0], 0.0)
    p0y = torch.where(vmask[0], ys[0], 0.0)
    fx = torch.where(vmask, xs, p0x[None])
    fy = torch.where(vmask, ys, p0y[None])
    fx2, fy2 = torch.roll(fx, -1, 0), torch.roll(fy, -1, 0)
    area = 0.5 * torch.abs((fx * fy2 - fx2 * fy).sum(0))
    return torch.where(cnt >= 3, area, 0.0)


def rotated_iou_bev(boxes1, boxes2, eps=1e-6):
    """Pairwise rotated BEV IoU of (N, 5) and (M, 5) boxes."""
    inter = rotated_overlap_block(geometry.boxes_to_corners_bev(boxes1),
                                  geometry.boxes_to_corners_bev(boxes2))
    a1 = (boxes1[:, 2] * boxes1[:, 3])[:, None]
    a2 = (boxes2[:, 2] * boxes2[:, 3])[None, :]
    return inter / torch.clamp(a1 + a2 - inter, min=eps)


def iou3d(boxes1, boxes2, eps=1e-6):
    """Pairwise 3D IoU of (N, 7) and (M, 7) boxes: rotated BEV overlap
    times z overlap over the volume union (pcdet ``boxes_iou3d_gpu``)."""
    inter_bev = rotated_overlap_block(geometry.boxes_to_corners_bev(boxes1),
                                      geometry.boxes_to_corners_bev(boxes2))
    zmax1 = boxes1[:, 2] + boxes1[:, 5] / 2
    zmin1 = boxes1[:, 2] - boxes1[:, 5] / 2
    zmax2 = boxes2[:, 2] + boxes2[:, 5] / 2
    zmin2 = boxes2[:, 2] - boxes2[:, 5] / 2
    z_overlap = torch.clamp(
        torch.minimum(zmax1[:, None], zmax2[None, :])
        - torch.maximum(zmin1[:, None], zmin2[None, :]), min=0.0)
    inter = inter_bev * z_overlap
    vol1 = torch.prod(boxes1[:, 3:6], dim=-1)[:, None]
    vol2 = torch.prod(boxes2[:, 3:6], dim=-1)[None, :]
    return inter / torch.clamp(vol1 + vol2 - inter, min=eps)


def nearest_bev_iou(boxes1, boxes2):
    """Axis-aligned IoU of 7-dof boxes after snapping each heading to the
    nearest axis (pcdet ``boxes3d_nearest_bev_iou``)."""
    return iou2d(geometry.boxes_to_aligned_bev(boxes1),
                 geometry.boxes_to_aligned_bev(boxes2))
