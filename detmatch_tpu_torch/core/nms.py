"""Greedy rotated-BEV NMS with fixed-size outputs (counterpart of
``detmatch_tpu/core/nms.py``).

The pairwise IoU matrix is built in row chunks; the greedy keep vector is
the fixed point of ``keep = valid & ~any(sup & keep[:, None])`` where
``sup[i, j]`` says box i outranks and overlaps box j. Iterating from
all-valid converges in (suppression-chain depth) steps to exactly the
sequential greedy result.
"""
from __future__ import annotations

import torch

from . import geometry, iou

NEG_INF = -1e10


def iou_matrix_bev(bev, chunk=None):
    """(N, 5) rotated BEV boxes → (N, N) IoU matrix."""
    n = bev.shape[0]
    if chunk is None:
        chunk = max(8, min(256, (1 << 19) // max(n, 1)))
    corners = geometry.boxes_to_corners_bev(bev)
    areas = bev[:, 2] * bev[:, 3]
    rows = []
    for s in range(0, n, chunk):
        inter = iou.rotated_overlap_block(corners[s:s + chunk], corners)
        a1 = areas[s:s + chunk]
        rows.append(inter / torch.clamp(a1[:, None] + areas[None, :] - inter,
                                        min=1e-6))
    return torch.cat(rows, 0)


def _greedy_from_matrix(iou_mat, scores, iou_thr, max_out):
    """Exact greedy NMS from a precomputed IoU matrix.

    Returns (idx (max_out,) int32 in descending-score order, valid
    (max_out,) bool); invalid slots point at index 0.
    """
    n = scores.shape[0]
    dev = scores.device
    order = torch.argsort(-scores, stable=True)  # ties: lower index first
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, device=dev)
    valid = scores > NEG_INF / 2
    sup = (iou_mat > iou_thr) & (rank[:, None] < rank[None, :])
    keep = valid
    for _ in range(n):
        new = valid & ~(sup & keep[:, None]).any(0)
        if torch.equal(new, keep):
            break
        keep = new
    keep_sorted = keep[order]
    pos = torch.cumsum(keep_sorted.to(torch.int64), 0) - 1
    take = keep_sorted & (pos < max_out)
    out_idx = torch.zeros(max_out, dtype=torch.int32, device=dev)
    out_idx[pos[take]] = order[take].to(torch.int32)
    out_valid = torch.arange(max_out, device=dev) < keep.sum()
    return out_idx, out_valid


def nms_bev(boxes, scores, iou_thr, max_out):
    """Class-agnostic rotated BEV NMS on (N, 7) (or (N, 5)) boxes with
    NEG_INF-padded scores → (idx (max_out,), valid (max_out,))."""
    bev = geometry.boxes_to_bev(boxes) if boxes.shape[-1] >= 7 else boxes
    return _greedy_from_matrix(iou_matrix_bev(bev), scores, iou_thr,
                               max_out)
