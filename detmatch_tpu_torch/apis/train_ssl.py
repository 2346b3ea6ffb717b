"""DetMatch SSL training loop (counterpart of
``detmatch_tpu/apis/train_ssl.py:train_ssl``; reference
``apis/ssl_train.py`` + ``IterBasedSSLRunner``): per iteration one
labeled and one unlabeled batch, the teacher phase, one step of each
student branch and the teacher's EMA (``train/ssl_step.py``).
"""
from __future__ import annotations

import os
import time

import torch

from ..ops.voxelize import VoxelizerSpec
from ..train.optim import detmatch_branch_optimizers
from ..train.ssl_step import (ema_step, student_2d_step, student_3d_step,
                              teacher_step, to_device_views, voxelize_views)
from ..utils.logging import JsonlLogger


def train_ssl(ssl, vox_spec: VoxelizerSpec, batches, work_dir, max_iters,
              batch_size=4, lr_3d=None, lr_2d=None, lr_scale=1.0,
              num_unlabeled=1, warmup_iters=500, log_interval=10, seed=0):
    """Train ``ssl`` for ``max_iters`` iterations on the device it lives
    on.

    Args:
        ssl: an ``SSLDetector`` (``apis.build.build_ssl``); its student is
            put in train mode, its teacher stays in eval mode.
        batches: an iterator of collated numpy batches
            ``{"lab": {"stu", "tea"}, "unlab": {"stu", "tea"}}`` of views
            as ``utils.synth_kitti.ssl_view`` makes them (the labeled
            student view with gt_boxes, gt_boxes2d, gt_labels2d,
            gt2d_valid).
        batch_size, num_unlabeled: set the default rates of the recipe
            (``split_0.py:824-827``): lr_3d = 1e-3 / 2 * bs * (1 + U) * 10
            and lr_2d = 2e-2 / 2 * bs * (1 + U), then times ``lr_scale``.
        work_dir: gets ``log.json``, one line per ``log_interval``
            iterations with the JAX loop's keys (``sup.3d.*``,
            ``sup.2d.*``, ``ssl.unlab.*``, ``metrics.*``, ``ssl.weight``,
            ``ssl.ema_decay``, ``grad_skips`` (both branches' skipped
            steps), ``loss``, ``iter``, ``mode``, ``time``).
        seed: seeds the ``torch.Generator`` that every sampler and dropout
            mask draws from.
    Returns:
        (ssl, (opt3d, opt2d), history): ``history`` holds every
        iteration's logs as floats.
    """
    os.makedirs(work_dir, exist_ok=True)
    logger = JsonlLogger(os.path.join(work_dir, "log.json"))
    if lr_3d is None:
        lr_3d = 1e-3 / 2 * batch_size * (1 + num_unlabeled) * 10
    if lr_2d is None:
        lr_2d = 2e-2 / 2 * batch_size * (1 + num_unlabeled)
    device = next(ssl.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    opt3d, opt2d = detmatch_branch_optimizers(
        ssl, lr_3d * lr_scale, lr_2d * lr_scale, warmup_iters)
    ssl.train()
    cfg = ssl.cfg
    history = []
    t0 = time.perf_counter()
    for it in range(max_iters):
        batch = voxelize_views(to_device_views(next(batches), device),
                               vox_spec)
        pseudo = teacher_step(ssl, batch)
        branches = []
        if cfg.enable_3d:
            branches.append(student_3d_step(ssl, opt3d, batch, pseudo, it,
                                            generator))
        if cfg.enable_2d:
            branches.append(student_2d_step(ssl, opt2d, batch, pseudo, it,
                                            generator))
        ema_step(ssl, it)
        logs = dict(pseudo["logs"])
        for branch in branches:
            logs.update(branch)
        logs["loss"] = sum(branch["loss"] for branch in branches)
        logs["grad_skips"] = opt3d.skipped + opt2d.skipped
        logs["metrics.dropped_voxels"] = sum(
            v["voxel_dropped"].sum() for views in batch.values()
            for v in views.values())
        entry = {k: float(v) for k, v in logs.items()}
        history.append(entry)
        if (it + 1) % log_interval == 0:
            logger.log(dict(entry, iter=it + 1, mode="train",
                            time=(time.perf_counter() - t0) / log_interval))
            t0 = time.perf_counter()
    logger.close()
    return ssl, (opt3d, opt2d), history
