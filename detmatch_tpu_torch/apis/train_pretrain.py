"""Supervised pretraining loops (counterpart of
``detmatch_tpu/apis/train_pretrain.py``): PV-RCNN under AdamW and the
one-cycle rate (``pretrain_pvrcnn/split_0.py:320-346``), Faster R-CNN
under SGD and the warmup step rate (``pretrain_frcnn/split_0.py:185-198``),
both with gradients clipped at global norm 10.

Each loop draws its batches from a dataset through a ``data.loader.Loader``
and writes ``log.json`` and checkpoints ``<work_dir>/ckpt/ckpt_<n>``
(``dict(model=state_dict)``), the ``load_from`` of an SSL config.
``train_pvrcnn_batches`` is the 3D loop on an iterator of collated
batches, which the synthetic-frame callers use.

Under several processes (``parallel``) every process draws the same
global batches (one loader, one seed) and keeps its rows, as JAX shards
one loader's batch over its devices; the gradient is summed over the
processes, the logged values are the global batch's, and process 0
writes ``log.json`` and the checkpoints. Only the PV-RCNN and the Faster
R-CNN have global loss denominators: another detector of the zoo, or
CaDDN, raises.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.loader import Loader
from ..models.frcnn.faster_rcnn import FasterRCNN
from ..models.pvrcnn.caddn import CaDDN
from ..models.pvrcnn.pvrcnn import PVRCNN
from ..ops.voxelize import VoxelizerSpec, voxelize_mean
from ..parallel import (all_reduce_grads, broadcast_state, is_primary,
                        local_shard, process_count, reduce_logs)
from ..train import checkpoints
from ..train.optim import (BranchOptimizer, clip_grad_norm_, make_optimizer,
                           warmup_step_lr)
from ..utils.logging import JsonlLogger, NullLogger


def to_device_batch(batch_np, vox_spec: VoxelizerSpec, device):
    """A collated numpy batch (points (B, P, 4), points_valid (B, P),
    gt_boxes (B, G, 8)) → tensors on ``device`` plus the voxelizer's
    ``voxel_features`` / ``voxel_keys``."""
    batch = {k: torch.from_numpy(np.array(batch_np[k])).to(device)
             for k in ("points", "points_valid", "gt_boxes")}
    vox = voxelize_mean(batch["points"], batch["points_valid"], vox_spec)
    return dict(batch, voxel_features=vox["features"],
                voxel_keys=vox["keys"])


def _save_model(work_dir, model, step):
    if is_primary():
        checkpoints.save(os.path.join(work_dir, "ckpt"),
                         dict(model=model.state_dict()), step)


def _logger(work_dir):
    """``<work_dir>/log.json`` on process 0, nothing on the others."""
    if not is_primary():
        return NullLogger()
    return JsonlLogger(os.path.join(work_dir, "log.json"))


def check_data_parallel(model, batch_size=None):
    """Refuse what several processes cannot train as one: a detector
    whose loss denominators are not global (the zoo: ROADMAP.md, queue 1,
    "The zoo under multi-process"), or a global batch the process count
    does not divide."""
    n = process_count()
    if n == 1:
        return
    if isinstance(model, CaDDN):
        raise NotImplementedError(
            f"CaDDN under {n} processes: ddn_loss's normaliser counts one "
            "process's pixels; train CaDDN in one process")
    if type(model) not in (PVRCNN, FasterRCNN):
        raise NotImplementedError(
            f"{type(model).__name__} under {n} processes: its heads' loss "
            "denominators are not global yet (ROADMAP.md, queue 1, the zoo "
            "under multi-process); train it in one process")
    if batch_size is not None and batch_size % n:
        raise ValueError(f"a global batch of {batch_size} over {n} "
                         "processes: the batch size must be a multiple")


def train_pvrcnn_batches(model, vox_spec: VoxelizerSpec, batches, work_dir,
                         max_iters, base_lr=0.001, log_interval=10,
                         ckpt_interval=None, seed=0):
    """Train ``model`` for ``max_iters`` steps on the device it lives on.

    Args:
        model: a PV-RCNN (``apis.build.build_detector``); put in train
            mode here.
        vox_spec: the voxelizer config.
        batches: an iterator of collated numpy batches (points,
            points_valid, gt_boxes), one global batch per step (each
            process keeps its rows, ``parallel.local_shard``).
        work_dir: gets ``log.json``, one line per ``log_interval`` steps
            with the JAX loop's keys (the loss terms, ``loss``, ``iter``,
            ``mode``, ``time``), and with ``ckpt_interval`` the
            checkpoints ``ckpt/ckpt_<n>`` every ``ckpt_interval`` steps.
        seed: seeds the ``torch.Generator`` that RoI sampling and dropout
            draw from.
    Returns:
        (model, optimizer, losses): ``losses`` holds every step's loss
        terms as floats.
    """
    check_data_parallel(model)
    os.makedirs(work_dir, exist_ok=True)
    logger = _logger(work_dir)
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    broadcast_state(model)
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer, scheduler = make_optimizer(params, base_lr, max_iters)
    model.train()
    history = []
    t0 = time.perf_counter()
    for it in range(max_iters):
        batch = to_device_batch(local_shard(next(batches)), vox_spec,
                                device)
        out = model(batch, train=True, generator=generator)
        losses = model.loss(out, batch)
        optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()
        all_reduce_grads(params)
        clip_grad_norm_(params)
        optimizer.step()
        scheduler.step()
        entry = {k: float(v) for k, v in reduce_logs(
            {k: v.detach() for k, v in losses.items()}).items()}
        history.append(entry)
        if (it + 1) % log_interval == 0:
            logger.log(dict(entry, iter=it + 1, mode="train",
                            time=(time.perf_counter() - t0) / log_interval))
            t0 = time.perf_counter()
        if ckpt_interval and (it + 1) % ckpt_interval == 0:
            _save_model(work_dir, model, it + 1)
    logger.close()
    return model, optimizer, history


def train_pvrcnn(model, vox_spec: VoxelizerSpec, dataset, collate_fn,
                 work_dir, max_iters, base_lr=0.001, batch_size=2,
                 log_interval=10, ckpt_interval=None, seed=0):
    """3D pretraining from a dataset (JAX's ``train_pvrcnn``): global
    batches of ``batch_size`` from a ``Loader`` seeded with ``seed``,
    collated by ``collate_fn`` (``data.collate.collate_view``), through
    :func:`train_pvrcnn_batches`; a checkpoint every ``ckpt_interval``
    steps (default: at ``max_iters`` only)."""
    check_data_parallel(model, batch_size)
    loader = Loader(dataset, batch_size, collate_fn, seed=seed)
    try:
        return train_pvrcnn_batches(
            model, vox_spec, iter(loader), work_dir, max_iters,
            base_lr=base_lr, log_interval=log_interval,
            ckpt_interval=ckpt_interval or max_iters, seed=seed)
    finally:
        loader.stop()


def train_frcnn(model, dataset, collate_fn, work_dir, max_iters,
                base_lr=0.02, batch_size=2, step_iters=(), log_interval=10,
                ckpt_interval=None, seed=0):
    """2D pretraining of a Faster R-CNN from a dataset (JAX's
    ``train_frcnn``): SGD with momentum 0.9 and weight decay 1e-4 under
    the warmup step rate (500 warmup iterations, ×0.1 at each of
    ``step_iters``), gradients clipped at global norm 10; a step whose
    gradients are not all finite is skipped and counted (the optimizer's
    ``skipped``). Global batches of ``batch_size`` come from a ``Loader``
    seeded with ``seed`` (each process keeping its rows), collated by
    ``collate_fn`` (``collate_view``, with the 2D gt); a checkpoint every
    ``ckpt_interval`` steps (default: at ``max_iters`` only).

    ``work_dir`` gets ``log.json`` with the loss terms, ``loss``,
    ``iter``, ``mode`` and ``time`` every ``log_interval`` steps. ``seed``
    also seeds the ``torch.Generator`` the RPN and RoI samplers draw from.
    Returns (model, optimizer, losses), ``losses`` every step's terms as
    floats.
    """
    check_data_parallel(model, batch_size)
    os.makedirs(work_dir, exist_ok=True)
    logger = _logger(work_dir)
    ckpt_interval = ckpt_interval or max_iters
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    broadcast_state(model)
    optimizer = BranchOptimizer(
        model.parameters(), "sgd",
        warmup_step_lr(base_lr, step_iters=tuple(step_iters)))
    model.train()
    loader = Loader(dataset, batch_size, collate_fn, seed=seed)
    batches = iter(loader)
    history = []
    t0 = time.perf_counter()
    try:
        for it in range(max_iters):
            b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in local_shard(next(batches)).items()
                 if k in ("img", "img_shape", "gt_boxes2d", "gt_labels2d",
                          "gt2d_valid")}
            optimizer.zero_grad()
            fwd = model(b["img"].permute(0, 3, 1, 2).contiguous(),
                        b["img_shape"], train=True)
            losses = model.loss(generator, fwd, b["gt_boxes2d"],
                                b["gt_labels2d"], b["gt2d_valid"])
            total = sum(losses.values())
            total.backward()
            optimizer.step()
            entry = {k: v.detach() for k, v in losses.items()}
            entry["loss"] = total.detach()
            entry = {k: float(v) for k, v in reduce_logs(entry).items()}
            history.append(entry)
            if (it + 1) % log_interval == 0:
                logger.log(dict(entry, iter=it + 1, mode="train",
                                time=(time.perf_counter() - t0)
                                / log_interval))
                t0 = time.perf_counter()
            if (it + 1) % ckpt_interval == 0:
                _save_model(work_dir, model, it + 1)
    finally:
        loader.stop()
        logger.close()
    return model, optimizer, history
