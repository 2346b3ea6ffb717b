"""The SSL step's data side (counterpart of
``detmatch_tpu/train/ssl_step.py``): bring a collated numpy batch to the
device and voxelize every view before the teacher phase."""
from __future__ import annotations

import numpy as np
import torch

from ..core.transforms import Aug2D, Aug3D
from ..ops.voxelize import VoxelizerSpec, voxelize_mean


def to_device_views(batch, device):
    """``{split: {view_name: numpy view}}`` → the same of tensors on
    ``device``: images from (B, H, W, 3) to (B, 3, H, W), the ``aug3d`` /
    ``aug2d`` dicts to :class:`Aug3D` / :class:`Aug2D`."""
    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def view(v):
        out = {k: tensor(a) for k, a in v.items()
               if k not in ("aug3d", "aug2d")}
        out["img"] = out["img"].permute(0, 3, 1, 2).contiguous()
        out["aug3d"] = Aug3D(**{k: tensor(a) for k, a in v["aug3d"].items()})
        out["aug2d"] = Aug2D(**{k: tensor(a) for k, a in v["aug2d"].items()})
        return out

    return {split: {k: view(v) for k, v in views.items()}
            for split, views in batch.items()}


def voxelize_views(batch, spec: VoxelizerSpec):
    """Add voxel_features, voxel_keys and voxel_dropped (per-frame count
    of occupied voxels cut by the ``max_voxels`` cap) to every view of
    ``{split: {view_name: view}}``."""
    def add(view):
        vox = voxelize_mean(view["points"], view["points_valid"], spec)
        return dict(view, voxel_features=vox["features"],
                    voxel_keys=vox["keys"],
                    voxel_dropped=vox["num_dropped_voxels"])

    return {split: {k: add(v) for k, v in views.items()}
            for split, views in batch.items()}
