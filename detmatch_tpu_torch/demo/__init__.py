"""Inference demos (counterparts of the repository's ``demo/*.py``): each
runs as ``python -m detmatch_tpu_torch.demo.<name>`` on the card unless
``--device cpu`` is given, reads the port's checkpoints
(``train/checkpoints.py``) and writes one PNG."""
from __future__ import annotations

import numpy as np

MAX_POINTS = 18000  # the JAX demos' point cap


def point_batch(path, device):
    """A KITTI ``.bin`` cloud → (all points (N, 4), points (1, P, 4) and
    points_valid (1, P) on ``device``, the first ``MAX_POINTS`` kept)."""
    import torch
    pts = np.fromfile(path, np.float32).reshape(-1, 4)
    n = min(len(pts), MAX_POINTS)
    p = np.zeros((1, MAX_POINTS, 4), np.float32)
    v = np.zeros((1, MAX_POINTS), bool)
    p[0, :n], v[0, :n] = pts[:n], True
    return (pts, torch.from_numpy(p).to(device),
            torch.from_numpy(v).to(device))
