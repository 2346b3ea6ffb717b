"""3D pretraining loop (counterpart of
``detmatch_tpu/apis/train_pretrain.py:train_pvrcnn``): PV-RCNN under
AdamW and the one-cycle rate, gradients clipped at global norm 10
(``pretrain_pvrcnn/split_0.py:320-346``)."""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ops.voxelize import VoxelizerSpec, voxelize_mean
from ..train.optim import clip_grad_norm_, make_optimizer
from ..utils.logging import JsonlLogger


def to_device_batch(batch_np, vox_spec: VoxelizerSpec, device):
    """A collated numpy batch (points (B, P, 4), points_valid (B, P),
    gt_boxes (B, G, 8)) → tensors on ``device`` plus the voxelizer's
    ``voxel_features`` / ``voxel_keys``."""
    batch = {k: torch.from_numpy(np.array(batch_np[k])).to(device)
             for k in ("points", "points_valid", "gt_boxes")}
    vox = voxelize_mean(batch["points"], batch["points_valid"], vox_spec)
    return dict(batch, voxel_features=vox["features"],
                voxel_keys=vox["keys"])


def train_pvrcnn(model, vox_spec: VoxelizerSpec, batches, work_dir,
                 max_iters, base_lr=0.001, log_interval=10, seed=0):
    """Train ``model`` for ``max_iters`` steps on the device it lives on.

    Args:
        model: a PV-RCNN (``apis.build.build_detector``); put in train
            mode here.
        vox_spec: the voxelizer config.
        batches: an iterator of collated numpy batches (points,
            points_valid, gt_boxes), one per step.
        work_dir: gets ``log.json``, one line per ``log_interval`` steps
            with the JAX loop's keys (the loss terms, ``loss``, ``iter``,
            ``mode``, ``time``).
        seed: seeds the ``torch.Generator`` that RoI sampling and dropout
            draw from.
    Returns:
        (model, optimizer, losses): ``losses`` holds every step's loss
        terms as floats.
    """
    os.makedirs(work_dir, exist_ok=True)
    logger = JsonlLogger(os.path.join(work_dir, "log.json"))
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer, scheduler = make_optimizer(params, base_lr, max_iters)
    model.train()
    history = []
    t0 = time.perf_counter()
    for it in range(max_iters):
        batch = to_device_batch(next(batches), vox_spec, device)
        out = model(batch, train=True, generator=generator)
        losses = model.loss(out, batch)
        optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()
        clip_grad_norm_(params)
        optimizer.step()
        scheduler.step()
        entry = {k: float(v.detach()) for k, v in losses.items()}
        history.append(entry)
        if (it + 1) % log_interval == 0:
            logger.log(dict(entry, iter=it + 1, mode="train",
                            time=(time.perf_counter() - t0) / log_interval))
            t0 = time.perf_counter()
    logger.close()
    return model, optimizer, history
