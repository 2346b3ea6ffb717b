"""Synthetic KITTI LiDAR frames (counterpart of
``detmatch_tpu/utils/synth_kitti.py``; the same seed gives the same
frames, bit for bit).

Uniform-random points understate real voxel load: 16k uniform points
over the KITTI range fill ~16k distinct 5 cm voxels scattered in 3D,
while a real HDL-64 frame puts its voxels on 2D surfaces (ground plane
and object faces). This module ray-casts the HDL-64 beam geometry
(64 elevation rings x ~0.18 deg azimuth) against a ground plane and
randomly placed boxes (cars, pedestrians, walls), so the points lie on
surfaces as in a real scan. Used by ``chip_smoke.py`` and the port's
tests; not part of the training path.
"""
from __future__ import annotations

import numpy as np

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
    dirs = _ray_dirs()
    R = dirs.shape[0]

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
    return out.astype(np.float32), valid


def lidar_batch(rng, b, num_points, point_cloud_range):
    """(b, P, 4) float32 points + (b, P) bool valid."""
    pts, valid = zip(*[lidar_scene(rng, num_points, point_cloud_range)
                       for _ in range(b)])
    return np.stack(pts), np.stack(valid)
