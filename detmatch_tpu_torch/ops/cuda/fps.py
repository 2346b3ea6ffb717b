"""Farthest-point sampling: CUDA kernel ``csrc/fps.cu`` (replacing the TPU
kernel ``detmatch_tpu/ops/pallas/fps.py:_fps_pallas``) and its plain
PyTorch twin ``ops/pointnet.farthest_point_sample``.

On a CPU tensor the wrapper runs the twin; on a CUDA tensor it launches
the kernel or raises. The kernel reproduces the twin's indices exactly.
"""
from __future__ import annotations

import torch

from .. import pointnet
from . import build

MAX_POINTS = 1024 * 18  # csrc/fps.cu: 1,024 threads x 18 points each

fps_plain = pointnet.farthest_point_sample


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
    dev = build.require_cuda(name, xyz, valid)
    build.require_dtype(name, xyz, torch.float32, "xyz")
    build.require_dtype(name, valid, torch.bool, "valid")
    b, n, three = xyz.shape
    if three != 3 or valid.shape != (b, n):
        raise ValueError(f"{name}: xyz (B, N, 3) and valid (B, N) expected, "
                         f"got {tuple(xyz.shape)} and {tuple(valid.shape)}")
    if not 0 < n <= MAX_POINTS or num_samples <= 0:
        raise ValueError(f"{name}: needs 0 < N <= {MAX_POINTS} and "
                         f"num_samples > 0, got N={n}, {num_samples}")
    out = torch.empty((b, num_samples), dtype=torch.int32, device=dev)
    lib = build.load_library()
    err = lib.dm_fps(build.ptr(xyz), build.ptr(valid), build.ptr(out), b, n,
                     num_samples, build.stream(dev))
    fps_batched.launches += 1
    build.check(lib, err, name)
    return out


fps_batched.launches = 0
