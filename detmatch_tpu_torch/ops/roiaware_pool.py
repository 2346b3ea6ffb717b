"""RoI-aware pooling (counterpart of ``detmatch_tpu/ops/roiaware_pool.py``;
pcdet ``roiaware_pool3d``): point features max- or average-pooled into a
G³ voxel grid inside each rotated 3D box.

The first ``max_pts`` in-box points of each box (in table order, as the
CUDA op's first-come cap) are picked by their running rank over the
points-in-box mask and written straight into their slot: the slot of
rank s holds the point whose rank is s, one writer a slot, so the index
set is JAX's exactly without its (R, N, max_pts) one-hot compare.
"""
from __future__ import annotations

import torch

from ..core import geometry


def first_k_inside(inside, k):
    """The first ``k`` True columns of each row of ``inside`` (..., N):
    (idx (..., k) int64 column of the s-th hit, 0 past the count;
    cnt (...) int64 hits, at most k). A direct write: hit s goes to slot
    s - 1 and every later hit to a trash column."""
    n = inside.shape[-1]
    rank = torch.cumsum(inside, dim=-1, dtype=torch.int32)
    cnt = torch.clamp(rank[..., -1], max=k).long()
    col = torch.where(inside & (rank <= k), rank - 1, k).long()
    cols = torch.arange(n, device=inside.device).expand_as(col)
    buf = torch.zeros(inside.shape[:-1] + (k + 1,), dtype=torch.int64,
                      device=inside.device)
    buf.scatter_(-1, col, cols)
    return buf[..., :k], cnt


def _box_frame(boxes, points, points_valid):
    """Points in each box's frame: (local (B, R, N, 3), half sizes
    (B, R, 1, 3), inside (B, R, N))."""
    b, r = boxes.shape[:2]
    n = points.shape[1]
    local = points[:, None, :, :3] - boxes[:, :, None, 0:3]
    local = geometry.rotate_points_z(local.reshape(b * r, n, 3),
                                     -boxes[..., 6].reshape(-1))
    local = local.reshape(b, r, n, 3)
    half = boxes[:, :, None, 3:6] / 2.0
    inside = (torch.abs(local) <= half).all(-1) & points_valid[:, None]
    return local, half, inside


def roiaware_pool_capped(boxes, points, point_feats, points_valid,
                         grid_size=12, max_pts=128, method="max"):
    """RoI-aware pooling with a per-box point cap.

    Args:
        boxes: (B, R, 7); points: (B, N, 3); point_feats: (B, N, C);
        points_valid: (B, N) bool; method: "max" or "avg".
    Returns:
        (B, R, G, G, G, C) pooled features, 0 in empty cells; cell
        (i, j, k) along the box's x, y, z.
    """
    g = grid_size
    b, r = boxes.shape[:2]
    c = point_feats.shape[-1]
    local, half, inside = _box_frame(boxes, points, points_valid)
    idx, cnt = first_k_inside(inside, max_pts)  # (B, R, max_pts)
    slot_valid = torch.arange(max_pts, device=idx.device) < cnt[..., None]

    sel_local = torch.gather(local, 2, idx[..., None].expand(-1, -1, -1, 3))
    sel_feats = torch.gather(
        point_feats, 1, idx.reshape(b, -1, 1).expand(-1, -1, c)
    ).reshape(b, r, max_pts, c)
    cell = torch.floor((sel_local + half) / (half * 2.0 / g)).long()
    cell = torch.clamp(cell, 0, g - 1)
    cell_id = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]
    g3 = g ** 3
    seg = torch.where(
        slot_valid,
        torch.arange(b * r, device=idx.device).reshape(b, r, 1) * g3
        + cell_id, b * r * g3).reshape(-1)  # the last row drops
    flat = sel_feats.reshape(-1, c)
    counts = torch.zeros(b * r * g3 + 1, dtype=flat.dtype,
                         device=flat.device)
    counts.index_add_(0, seg, torch.ones_like(seg, dtype=flat.dtype))
    if method == "max":
        pooled = torch.full((b * r * g3 + 1, c), -torch.inf,
                            dtype=flat.dtype, device=flat.device)
        pooled = pooled.scatter_reduce(0, seg[:, None].expand(-1, c), flat,
                                       "amax", include_self=True)
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
    else:
        s = torch.zeros((b * r * g3 + 1, c), dtype=flat.dtype,
                        device=flat.device).index_add(0, seg, flat)
        pooled = s / torch.clamp(counts[:, None], min=1.0)
    pooled = torch.where((counts > 0)[:, None], pooled, 0.0)
    return pooled[:-1].reshape(b, r, g, g, g, c)
