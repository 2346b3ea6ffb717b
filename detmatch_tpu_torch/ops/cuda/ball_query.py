"""Ball query over a y-sorted point table: CUDA kernel
``csrc/ball_query.cu`` (replacing the TPU kernel
``detmatch_tpu/ops/pallas/ball_query.py:_ball_query_pallas``) and its
plain PyTorch twin :func:`ball_query_plain`.

Neighbours are the first ``nsample`` in y-sorted scan order (stable
sort, invalid rows last), as in the JAX reference; returned indices
refer to the caller's table. On a CPU tensor the wrapper runs the twin;
on a CUDA tensor it launches the kernel or raises. Both give exactly the
same indices and counts.

The kernel reads the sorted table packed as one 16-byte record a point
(:func:`pack_table`); a caller that queries one table at several radii
packs it once. Host-side plan: :func:`group_lanes` picks the lanes that
serve one center.
"""
from __future__ import annotations

import torch

from .. import pointnet
from . import build

BIG = 1e9
# csrc/ball_query.cu: lanes per center it is built for
GROUP_LANES = (1, 2, 4, 8, 16, 32)


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


def pack_table(points_sorted, valid_sorted, perm):
    """The kernel's table: (B, N, 4) float32 records (x, y, z, perm as
    int32 bits) of a :func:`sort_points_by_y` result, y = +inf on the
    invalid rows (which sort last)."""
    x, y, z = points_sorted[..., :3].unbind(-1)
    y = torch.where(valid_sorted, y, float("inf"))
    return torch.stack((x.view(torch.int32), y.view(torch.int32),
                        z.view(torch.int32), perm.to(torch.int32)),
                       -1).view(torch.float32)


def group_lanes(m, n, radius, nsample):
    """Lanes that serve one center (``GROUP_LANES``) for a call of M
    centers over an N-point table: 32 over the VSA's tables of 10,000
    points and more, whose windows run to hundreds of positions; 8 over
    the RoI grid's 2,048 keypoints (windows of 58-212). By the kernel's
    device time on the H100 (``tools/port_probes/k2k3_plans.py``), the
    fastest G on 22 of the SSL iteration's 24 calls and within 18% of it
    on the other two (the student's RoI grid, where 1 and 4 won)."""
    return 32 if n > 4096 else 8


def _sorted_table(points, points_valid, point_perm):
    if point_perm is None:
        return sort_points_by_y(points, points_valid)
    return points, points_valid, point_perm


def ball_query_plain(centers, centers_valid, points, points_valid, radius,
                     nsample, point_perm=None, table=None):
    """Plain twin of :func:`ball_query_batched` (same arguments; it reads
    the sorted table itself, not ``table``)."""
    pts_s, pv_s, perm = _sorted_table(points, points_valid, point_perm)
    idx_s, cnt = pointnet.ball_query(
        centers, centers_valid, pts_s, pv_s,
        float(pointnet.radius_sq(radius)), nsample)
    b = idx_s.shape[0]
    idx = torch.gather(perm, 1, idx_s.reshape(b, -1).long())
    return idx.reshape(idx_s.shape), cnt


def ball_query_launch(centers, centers_valid, table, radius, nsample,
                      group):
    """The kernel with ``group`` lanes a center (the wrapper passes
    :func:`group_lanes`'s) on a :func:`pack_table` table; arguments
    checked by :func:`ball_query_batched`."""
    b, m, _ = centers.shape
    idx = torch.empty((b, m, nsample), dtype=torch.int32,
                      device=centers.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=centers.device)
    lib = build.load_library()
    err = lib.dm_ball_query(
        build.ptr(centers), build.ptr(centers_valid), build.ptr(table),
        build.ptr(idx), build.ptr(cnt), b, m, table.shape[1], float(radius),
        float(pointnet.radius_sq(radius)), nsample, group,
        build.stream(centers.device))
    ball_query_batched.launches += 1
    build.check(lib, err, "ball_query_batched")
    return idx, cnt


def ball_query_batched(centers, centers_valid, points, points_valid, radius,
                       nsample, point_perm=None, table=None):
    """First ``nsample`` neighbours within ``radius``, batched.

    Args:
        centers: (B, M, 3) float32; centers_valid: (B, M) bool.
        points: (B, N, 3) float32; points_valid: (B, N) bool.
        radius: float; nsample: int.
        point_perm: the ``perm`` of :func:`sort_points_by_y` when
            ``points``/``points_valid`` are already y-sorted (several
            queries against one table); indices still refer to the
            original table.
        table: :func:`pack_table` of that sorted table, when the caller
            packed it already (the kernel reads only this).
    Returns:
        idx (B, M, nsample) int32 — unused slots repeat the first hit; an
        empty ball gives ``perm[b, 0]`` in every slot;
        cnt (B, M) int32 — number of hits, at most ``nsample``.
    """
    if centers.device.type == "cpu":
        return ball_query_plain(centers, centers_valid, points,
                                points_valid, radius, nsample, point_perm)
    name = "ball_query_batched"
    if table is None:
        table = pack_table(*_sorted_table(points, points_valid, point_perm))
    build.require_cuda(name, centers, centers_valid, table)
    for t, dtype, what in ((centers, torch.float32, "centers"),
                           (centers_valid, torch.bool, "centers_valid"),
                           (table, torch.float32, "table")):
        build.require_dtype(name, t, dtype, what)
    b, m, _ = centers.shape
    n = points.shape[1]
    if (centers.shape[-1] != 3 or points.shape[0] != b
            or centers_valid.shape != (b, m) or table.shape != (b, n, 4)):
        raise ValueError(f"{name}: shapes do not match centers (B, M, 3), "
                         "points (B, N, 3+), table (B, N, 4)")
    if n == 0 or nsample <= 0 or not radius > 0:
        raise ValueError(f"{name}: needs N > 0, nsample > 0 and radius > 0")
    return ball_query_launch(centers, centers_valid, table, radius, nsample,
                             group_lanes(m, n, radius, nsample))


ball_query_batched.launches = 0
