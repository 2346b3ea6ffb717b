"""Inference entry point: raw points → detections."""
from __future__ import annotations

import torch

from ..models.pvrcnn.pvrcnn import post_processing
from ..ops.voxelize import VoxelizerSpec, voxelize_mean


@torch.inference_mode()
def detect(model, points, points_valid, vox_spec: VoxelizerSpec,
           score_thresh=0.1):
    """Voxelize → PV-RCNN eval forward → class-agnostic NMS.

    Args:
        model: an eval-mode PV-RCNN (``apis.build.build_detector``).
        points: (B, P, 4) float32 xyz + intensity; points_valid: (B, P)
            bool; both on the model's device.
        vox_spec: the voxelizer config.
        score_thresh: refined-score threshold before NMS.
    Returns:
        dict of per-frame fixed-size tensors: boxes (B, K, 7), scores
        (B, K), labels (B, K) 1-based, valid (B, K).
    """
    vox = voxelize_mean(points, points_valid, vox_spec)
    out = model(dict(points=points, points_valid=points_valid,
                     voxel_features=vox["features"],
                     voxel_keys=vox["keys"]))
    post = post_processing(out, score_thresh=score_thresh)
    return {k: post[k] for k in ("boxes", "scores", "labels", "valid")}
