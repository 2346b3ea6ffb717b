"""RoI point pooling (counterpart of ``detmatch_tpu/ops/roipoint_pool.py``;
pcdet ``roipoint_pool3d``): the first ``num_sampled`` points (with their
features) inside each optionally enlarged box; a box with fewer points
repeats its first in-box point, an empty box is zero and flagged.

The first-K pick is ``roiaware_pool.first_k_inside``'s direct write, the
same index set as JAX's (R, N, K) one-hot compare without it.
"""
from __future__ import annotations

import torch

from ..core import geometry
from .roiaware_pool import first_k_inside


def roipoint_pool(boxes, points, point_feats, points_valid,
                  num_sampled=512, extra_width=(0.0, 0.0, 0.0)):
    """
    Args:
        boxes: (B, R, 7); points: (B, N, 3); point_feats: (B, N, C);
        points_valid: (B, N) bool.
    Returns:
        pooled (B, R, num_sampled, 3 + C): raw xyz and features (not
        canonicalised); empty (B, R) bool.
    """
    b, r = boxes.shape[:2]
    big = geometry.enlarge_boxes(boxes.reshape(b * r, -1), extra_width)
    inside = torch.stack([
        geometry.points_in_boxes(p, bx) for p, bx in zip(
            points, big.reshape(b, r, -1))]) & points_valid[:, None]
    idx, cnt = first_k_inside(inside, num_sampled)
    slots = torch.arange(num_sampled, device=idx.device)
    idx = torch.where(slots < torch.clamp(cnt, min=1)[..., None], idx,
                      idx[..., :1])
    data = torch.cat([points, point_feats], dim=-1)
    pooled = torch.gather(
        data, 1, idx.reshape(b, -1, 1).expand(-1, -1, data.shape[-1])
    ).reshape(b, r, num_sampled, -1)
    empty = cnt == 0
    return torch.where(empty[..., None, None], 0.0, pooled), empty
