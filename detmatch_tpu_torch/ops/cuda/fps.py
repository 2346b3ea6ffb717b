"""Farthest-point sampling: CUDA kernel ``csrc/fps.cu`` (replacing the TPU
kernel ``detmatch_tpu/ops/pallas/fps.py:_fps_pallas``) and its plain
PyTorch twin ``ops/pointnet.farthest_point_sample``.

On a CPU tensor the wrapper runs the twin; on a CUDA tensor it launches
the kernel or raises. The kernel reproduces the twin's indices exactly.
Shape limit on the card: N up to ``MAX_POINTS`` = 16 CTAs x 128 threads
x 24 points = 49,152 points a sample; past it the wrapper raises
ValueError (no fallback). The widest model calls: the SSL clouds'
18,000 points (VSA keypoints) and PointRCNN's 16,384.

Host-side plan: :func:`fps_plan` picks, from (B, N), the cluster of CTAs
that serves one sample and the points a thread keeps in registers;
:func:`active_clusters` asks the card, once per process and plan, how
many such clusters it holds at once.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import pointnet
from . import build

# csrc/fps.cu: cluster sizes (up to kMaxCluster), threads a CTA
# (kThreads), points a thread (kMaxPerThread), the capacity (kMaxPoints)
# and a cluster's candidates, one a warp (kMaxSlots)
CLUSTER_SIZES = (2, 4, 8, 16)
CTA_THREADS = 128
MAX_PER_THREAD = 24
MAX_POINTS = max(CLUSTER_SIZES) * CTA_THREADS * MAX_PER_THREAD
MAX_SLOTS = max(CLUSTER_SIZES) * CTA_THREADS // 32

fps_plain = pointnet.farthest_point_sample


class FpsPlan(NamedTuple):
    cluster: int      # CTAs per sample
    per_thread: int   # points a thread keeps in registers


def fps_plan(b, n):
    """The launch of one (B, N) call, as timed on the H100
    (``tools/port_probes/k2k3_plans.py``): clusters of 8 CTAs up to
    B = 8 and 4 beyond (at most 64 CTAs in all), larger only where a
    smaller one cannot hold N; each thread keeps ceil(N / (C x 128))
    points. Clusters of 16 were slower at every B of 1-8 (1.5x at
    B = 8), as were CTAs of 64 and 256 threads."""
    if not 0 < n <= MAX_POINTS:
        raise ValueError(f"fps_batched: needs 0 < N <= {MAX_POINTS}, got {n}")
    fit = max([c for c in CLUSTER_SIZES if c <= 8 and b * c <= 64]
              or [min(CLUSTER_SIZES)])
    for cluster in (c for c in CLUSTER_SIZES if c >= fit):
        per_thread = -(-n // (cluster * CTA_THREADS))
        if per_thread <= MAX_PER_THREAD:
            return FpsPlan(cluster, per_thread)
    raise AssertionError("unreachable: N is within MAX_POINTS")


@functools.lru_cache(maxsize=None)
def active_clusters(plan):
    """How many clusters of ``plan`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``); raises if it holds none."""
    lib = build.load_library()
    active = ctypes.c_int(0)
    err = lib.dm_fps_active_clusters(*plan, ctypes.byref(active))
    build.check(lib, err, "fps_batched")
    if active.value < 1:
        raise RuntimeError(f"fps_batched: the card holds no cluster of "
                           f"{plan.cluster} CTAs")
    return active.value


def fps_launch(xyz, valid, num_samples, plan):
    """The kernel with a given :class:`FpsPlan` (the wrapper passes
    :func:`fps_plan`'s); arguments checked by :func:`fps_batched`."""
    b, n = valid.shape
    active_clusters(plan)
    out = torch.empty((b, num_samples), dtype=torch.int32,
                      device=xyz.device)
    lib = build.load_library()
    err = lib.dm_fps(build.ptr(xyz), build.ptr(valid), build.ptr(out), b, n,
                     num_samples, *plan, build.stream(xyz.device))
    fps_batched.launches += 1
    build.check(lib, err, "fps_batched")
    return out


def fps_batched(xyz, valid, num_samples):
    """Greedy farthest-point sampling.

    Args:
        xyz: (B, N, 3) float32; valid: (B, N) bool; num_samples: int.
    Returns:
        (B, num_samples) int32 indices.
    """
    if xyz.device.type == "cpu":
        return fps_plain(xyz, valid, num_samples)
    name = "fps_batched"
    build.require_cuda(name, xyz, valid)
    build.require_dtype(name, xyz, torch.float32, "xyz")
    build.require_dtype(name, valid, torch.bool, "valid")
    b, n, three = xyz.shape
    if three != 3 or valid.shape != (b, n):
        raise ValueError(f"{name}: xyz (B, N, 3) and valid (B, N) expected, "
                         f"got {tuple(xyz.shape)} and {tuple(valid.shape)}")
    if not 0 < n <= MAX_POINTS or num_samples <= 0:
        raise ValueError(f"{name}: needs 0 < N <= {MAX_POINTS} and "
                         f"num_samples > 0, got N={n}, {num_samples}")
    return fps_launch(xyz, valid, num_samples, fps_plan(b, n))


fps_batched.launches = 0
