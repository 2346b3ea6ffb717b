"""Point-cloud voxelization as a sort + segment reduction
(counterpart of ``detmatch_tpu/ops/voxelize.py``).

Fixed-capacity output: ``max_voxels`` rows per sample, sorted keys with
``INVALID_KEY`` padding, mean of the first ``max_points`` points of each
voxel in arrival order (MeanVFE fused in). The cap keeps the smallest
keys. The per-voxel sum runs as ``max_points`` passes over the sorted
points, each adding at most one point to a voxel, so the summation order
is fixed (arrival order) on every device — no atomics.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INVALID_KEY = int(np.iinfo(np.int32).max)


class VoxelizerSpec(NamedTuple):
    """Static voxelization config."""
    point_cloud_range: tuple  # (x0, y0, z0, x1, y1, z1)
    voxel_size: tuple         # (vx, vy, vz)
    max_voxels: int
    max_points: int

    @property
    def grid_size(self):
        """(X, Y, Z) integer grid dims."""
        pcr = np.asarray(self.point_cloud_range, np.float64)
        vs = np.asarray(self.voxel_size, np.float64)
        return tuple(int(g) for g in
                     np.round((pcr[3:] - pcr[:3]) / vs).astype(np.int64))

    @property
    def spatial_shape(self):
        """(Z+1, Y, X) — the sparse shape used by the backbone."""
        gx, gy, gz = self.grid_size
        return (gz + 1, gy, gx)


def linearize(coords_zyx, spatial_shape):
    """(..., 3) int zyx coords → (...,) int32 keys, y-major (y, x, z)."""
    Z, Y, X = spatial_shape
    return ((coords_zyx[..., 1] * X + coords_zyx[..., 2]) * Z
            + coords_zyx[..., 0]).to(torch.int32)


def delinearize(keys, spatial_shape):
    """(...,) keys → (..., 3) int32 zyx (inverse of :func:`linearize`)."""
    Z, Y, X = spatial_shape
    z = keys % Z
    q = keys // Z
    x = q % X
    y = q // X
    return torch.stack([z, y, x], dim=-1).to(torch.int32)


def _voxelize_one(points, points_valid, spec: VoxelizerSpec):
    dev = points.device
    P, C = points.shape
    V = spec.max_voxels
    pcr = torch.tensor(spec.point_cloud_range, dtype=points.dtype,
                       device=dev)
    vs = torch.tensor(spec.voxel_size, dtype=points.dtype, device=dev)
    grid = torch.tensor(spec.grid_size, dtype=torch.int32, device=dev)

    cxyz = torch.floor((points[:, :3] - pcr[:3]) / vs).to(torch.int32)
    in_range = ((cxyz >= 0) & (cxyz < grid)).all(dim=-1) & points_valid
    keys = linearize(cxyz.flip(-1), spec.spatial_shape)
    keys = torch.where(in_range, keys, torch.full_like(keys, INVALID_KEY))

    # stable: points of one voxel keep their arrival order
    order = torch.argsort(keys, stable=True)
    skeys = keys[order]
    sfeat = points[order]

    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    first &= skeys != INVALID_KEY
    voxel_id = torch.cumsum(first.to(torch.int32), 0) - 1
    total_voxels = first.sum()
    num_voxels = torch.clamp(total_voxels, max=V)

    pos = torch.arange(P, dtype=torch.int32, device=dev)
    starts = first & (voxel_id < V)
    seg_start = torch.zeros(V, dtype=torch.int32, device=dev)
    seg_start[voxel_id[starts].long()] = pos[starts]
    rank = pos - seg_start[voxel_id.clamp(0, V - 1).long()]
    contrib = ((skeys != INVALID_KEY) & (rank < spec.max_points)
               & (voxel_id < V) & (voxel_id >= 0))

    feat_sum = torch.zeros(V, C, dtype=points.dtype, device=dev)
    cnt = torch.zeros(V, dtype=points.dtype, device=dev)
    for r in range(spec.max_points):
        sel = contrib & (rank == r)  # at most one point per voxel
        vid = voxel_id[sel].long()
        feat_sum[vid] = feat_sum[vid] + sfeat[sel]
        cnt[vid] = cnt[vid] + 1.0
    features = feat_sum / torch.clamp(cnt[:, None], min=1.0)

    vkeys = torch.full((V,), INVALID_KEY, dtype=torch.int32, device=dev)
    vkeys[voxel_id[starts].long()] = skeys[starts]
    pad = vkeys == INVALID_KEY
    coords = delinearize(torch.where(pad, 0, vkeys), spec.spatial_shape)
    coords = torch.where(pad[:, None], 0, coords)
    return dict(features=features, coords=coords, keys=vkeys,
                num_voxels=num_voxels.to(torch.int32),
                num_dropped_voxels=(total_voxels - num_voxels).to(
                    torch.int32))


def voxelize_mean(points, points_valid, spec: VoxelizerSpec):
    """Voxelize a batch and mean-reduce point features per voxel.

    Args:
        points: (B, P, 3 + C) xyz + features.
        points_valid: (B, P) bool padding mask.
        spec: static :class:`VoxelizerSpec`.
    Returns:
        dict of batched tensors: features (B, V, 3 + C), coords (B, V, 3)
        int32 zyx, keys (B, V) int32 sorted ascending with INVALID_KEY
        padding, num_voxels (B,), num_dropped_voxels (B,).
    """
    outs = [_voxelize_one(p, v, spec) for p, v in zip(points, points_valid)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
