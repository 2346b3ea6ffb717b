"""Builders: a config loaded with
``detmatch_tpu_torch.config.Config.fromfile`` → detector and voxelizer
(counterpart of ``detmatch_tpu/apis/build.py``; the port has PV-RCNN
only)."""
from __future__ import annotations

from typing import Any, Dict

from ..models.pvrcnn.pvrcnn import PVRCNN
from ..ops.voxelize import VoxelizerSpec


def build_detector(cfg: Dict[str, Any], device="cpu"):
    """The PV-RCNN of ``cfg['model']['detector_3d']``, in eval mode on
    ``device``."""
    det = dict(cfg["model"]["detector_3d"])
    kind = det.pop("type", "PVRCNN")
    if kind != "PVRCNN":
        raise NotImplementedError(f"detector type {kind!r} is not ported")
    return PVRCNN(**det).to(device).eval()


def build_voxelizer(cfg: Dict[str, Any]) -> VoxelizerSpec:
    """The :class:`VoxelizerSpec` of ``cfg['voxelizer']``."""
    v = cfg["voxelizer"]
    return VoxelizerSpec(point_cloud_range=tuple(v["point_cloud_range"]),
                         voxel_size=tuple(v["voxel_size"]),
                         max_voxels=v.get("max_voxels", 16000),
                         max_points=v.get("max_points", 5))
