"""Ball query over a y-sorted point table: CUDA kernel
``csrc/ball_query.cu`` (replacing the TPU kernel
``detmatch_tpu/ops/pallas/ball_query.py:_ball_query_pallas``) and its
plain PyTorch twin :func:`ball_query_plain`.

Neighbours are the first ``nsample`` in y-sorted scan order (stable
sort, invalid rows last), as in the JAX reference; returned indices
refer to the caller's table. On a CPU tensor the wrapper runs the twin;
on a CUDA tensor it launches the kernel or raises. Both give exactly the
same indices and counts.
"""
from __future__ import annotations

import torch

from .. import pointnet
from . import build

BIG = 1e9


def sort_points_by_y(points, points_valid):
    """Stable sort of a (B, N, 3+) table by y, invalid rows last.

    Returns (points_sorted, valid_sorted, perm int32) with
    ``points_sorted[b, i] == points[b, perm[b, i]]``.
    """
    key = torch.where(points_valid, points[..., 1], BIG)
    perm = torch.argsort(key, dim=1, stable=True)
    pts_s = torch.gather(points, 1,
                         perm[..., None].expand(-1, -1, points.shape[-1]))
    return pts_s, torch.gather(points_valid, 1, perm), perm.to(torch.int32)


def _sorted_table(points, points_valid, point_perm):
    if point_perm is None:
        return sort_points_by_y(points, points_valid)
    return points, points_valid, point_perm


def ball_query_plain(centers, centers_valid, points, points_valid, radius,
                     nsample, point_perm=None):
    """Plain twin of :func:`ball_query_batched` (same arguments)."""
    pts_s, pv_s, perm = _sorted_table(points, points_valid, point_perm)
    idx_s, cnt = pointnet.ball_query(
        centers, centers_valid, pts_s, pv_s,
        float(pointnet.radius_sq(radius)), nsample)
    b = idx_s.shape[0]
    idx = torch.gather(perm, 1, idx_s.reshape(b, -1).long())
    return idx.reshape(idx_s.shape), cnt


def ball_query_batched(centers, centers_valid, points, points_valid, radius,
                       nsample, point_perm=None):
    """First ``nsample`` neighbours within ``radius``, batched.

    Args:
        centers: (B, M, 3) float32; centers_valid: (B, M) bool.
        points: (B, N, 3) float32; points_valid: (B, N) bool.
        radius: float; nsample: int.
        point_perm: the ``perm`` of :func:`sort_points_by_y` when
            ``points``/``points_valid`` are already y-sorted (several
            queries against one table); indices still refer to the
            original table.
    Returns:
        idx (B, M, nsample) int32 — unused slots repeat the first hit; an
        empty ball gives ``perm[b, 0]`` in every slot;
        cnt (B, M) int32 — number of hits, at most ``nsample``.
    """
    if centers.device.type == "cpu":
        return ball_query_plain(centers, centers_valid, points,
                                points_valid, radius, nsample, point_perm)
    name = "ball_query_batched"
    pts_s, pv_s, perm = _sorted_table(points, points_valid, point_perm)
    pts_s, pv_s, perm = (t.contiguous() for t in (pts_s, pv_s, perm))
    dev = build.require_cuda(name, centers, centers_valid, pts_s, pv_s, perm)
    for t, dtype, what in ((centers, torch.float32, "centers"),
                           (centers_valid, torch.bool, "centers_valid"),
                           (pts_s, torch.float32, "points"),
                           (pv_s, torch.bool, "points_valid"),
                           (perm, torch.int32, "point_perm")):
        build.require_dtype(name, t, dtype, what)
    b, m, _ = centers.shape
    n = pts_s.shape[1]
    if (centers.shape[-1] != 3 or pts_s.shape != (b, n, 3)
            or centers_valid.shape != (b, m) or pv_s.shape != (b, n)
            or perm.shape != (b, n)):
        raise ValueError(f"{name}: shapes do not match (B, M, 3) / (B, N, 3)")
    if n == 0 or nsample <= 0 or not radius > 0:
        raise ValueError(f"{name}: needs N > 0, nsample > 0 and radius > 0")
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=dev)
    cnt = torch.empty((b, m), dtype=torch.int32, device=dev)
    lib = build.load_library()
    err = lib.dm_ball_query(
        build.ptr(centers), build.ptr(centers_valid), build.ptr(pts_s),
        build.ptr(pv_s), build.ptr(perm), build.ptr(idx), build.ptr(cnt),
        b, m, n, float(radius), float(pointnet.radius_sq(radius)), nsample,
        build.stream(dev))
    ball_query_batched.launches += 1
    build.check(lib, err, name)
    return idx, cnt


ball_query_batched.launches = 0
