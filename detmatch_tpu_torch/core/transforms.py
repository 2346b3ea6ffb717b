"""Augmentation records: apply or reverse a recorded 3D or 2D
augmentation on a batch of boxes (counterpart of
``detmatch_tpu/core/transforms.py``).

A record holds one entry per frame, as tensors with a leading batch
axis. The 3D flow order is fixed, as in the DetMatch pipeline
(RandomFlip3D, then GlobalRotScaleTrans R→S→T):

    forward:  flip_x → rotate → scale → translate
    reverse:  -translate → 1/scale → -rotate → flip_x
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import geometry


class Aug3D(NamedTuple):
    """Per-frame 3D augmentation: flip_x (B,) 1.0 where the BEV flip
    (y → -y) was applied, rot (B,) radians CCW around +z, scale (B,),
    trans (B, 3)."""
    flip_x: torch.Tensor
    rot: torch.Tensor
    scale: torch.Tensor
    trans: torch.Tensor


class Aug2D(NamedTuple):
    """Per-frame 2D augmentation: scale (B, 4) (sw, sh, sw, sh) resize
    factors, flip (B,) 1.0 where the image was flipped horizontally,
    img_w (B,) the resized image width the flip mirrors in."""
    scale: torch.Tensor
    flip: torch.Tensor
    img_w: torch.Tensor


def _maybe_flip(boxes, flag):
    """(B, N, 7+) boxes mirrored across the x-z plane (y → -y, heading →
    -heading) where flag > 0.5."""
    flipped = torch.cat([boxes[..., 0:1], -boxes[..., 1:2], boxes[..., 2:6],
                         -boxes[..., 6:7], boxes[..., 7:]], -1)
    return torch.where(flag[:, None, None] > 0.5, flipped, boxes)


def _rotate(boxes, angle):
    center = geometry.rotate_points_z(boxes[..., 0:3], angle)
    heading = boxes[..., 6:7] + angle[:, None, None]
    return torch.cat([center, boxes[..., 3:6], heading, boxes[..., 7:]], -1)


def _scale(boxes, factor):
    f = factor[:, None, None]
    return torch.cat([boxes[..., 0:3] * f, boxes[..., 3:6] * f,
                      boxes[..., 6:]], -1)


def apply_aug3d_boxes(boxes, rec: Aug3D):
    """Apply a recorded 3D augmentation to (B, N, 7+) boxes."""
    boxes = _maybe_flip(boxes, rec.flip_x)
    boxes = _scale(_rotate(boxes, rec.rot), rec.scale)
    return torch.cat([boxes[..., 0:3] + rec.trans[:, None, :],
                      boxes[..., 3:]], -1)


def reverse_aug3d_boxes(boxes, rec: Aug3D):
    """Undo a recorded 3D augmentation on (B, N, 7+) boxes."""
    boxes = torch.cat([boxes[..., 0:3] - rec.trans[:, None, :],
                       boxes[..., 3:]], -1)
    boxes = _rotate(_scale(boxes, 1.0 / rec.scale), -rec.rot)
    return _maybe_flip(boxes, rec.flip_x)


def _hflip(boxes, img_w):
    w = img_w[:, None]
    return torch.stack([w - boxes[..., 2], boxes[..., 1], w - boxes[..., 0],
                        boxes[..., 3]], -1)


def apply_aug2d_boxes(boxes, rec: Aug2D):
    """Original-image frame → augmented-image frame, (B, N, 4) xyxy."""
    boxes = boxes * rec.scale[:, None, :]
    return torch.where(rec.flip[:, None, None] > 0.5,
                       _hflip(boxes, rec.img_w), boxes)


def reverse_aug2d_boxes(boxes, rec: Aug2D):
    """Augmented-image frame → original-image frame, (B, N, 4) xyxy."""
    boxes = torch.where(rec.flip[:, None, None] > 0.5,
                        _hflip(boxes, rec.img_w), boxes)
    return boxes / rec.scale[:, None, :]
