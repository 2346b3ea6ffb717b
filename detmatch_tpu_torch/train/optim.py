"""The 3D pretraining optimiser (counterpart of the parts of
``detmatch_tpu/train/optim.py`` that ``train_pvrcnn`` uses): the one-cycle
learning rate of mmcv's CyclicLrUpdater as a plain function of the
iteration, AdamW (betas .95/.99, weight decay .01) under it, and gradient
clipping at global norm 10 (``pretrain_pvrcnn/split_0.py:320-346``).
"""
from __future__ import annotations

import math

import torch

CLIP_NORM = 10.0


def cyclic_lr(base_lr, total_iters, target_ratio=(10.0, 1e-4),
              step_ratio_up=0.4):
    """One cycle: the rate rises from base_lr to base_lr * 10 over the
    first 40% of ``total_iters`` (cosine), then anneals to base_lr * 1e-4.
    Returns ``fn(it) -> float``. The arithmetic is float32 in the JAX
    schedule's order: near the end the rate is a small difference of two
    numbers near 10, and float32 rounding there moves it by ~0.2%, which
    this reproduces to the bit."""
    up = int(total_iters * step_ratio_up)

    def cos_anneal(frac):
        return 0.5 * (1.0 - torch.cos(math.pi * frac))

    def fn(it):
        it = torch.tensor(float(it), dtype=torch.float32)
        if it < up:
            frac = torch.clamp(it / max(up, 1), 0.0, 1.0)
            lr = base_lr * (1 + (target_ratio[0] - 1) * cos_anneal(frac))
        else:
            frac = torch.clamp((it - up) / max(total_iters - up, 1), 0.0,
                               1.0)
            lr = base_lr * (target_ratio[0] + (target_ratio[1]
                                               - target_ratio[0])
                            * cos_anneal(frac))
        return float(lr)

    return fn


def make_optimizer(params, base_lr, total_iters):
    """(AdamW, LambdaLR) of the pretraining recipe. The scheduler's factor
    at iteration ``it`` is ``cyclic_lr(1, total_iters)(it)``, so the rate
    of the ``it``-th ``step()`` (from 0) is ``cyclic_lr(base_lr,
    total_iters)(it)``, as optax's schedule counts its updates; AdamW's
    decoupled weight decay is scaled by that rate, as optax's
    ``add_decayed_weights`` before ``scale_by_learning_rate``."""
    opt = torch.optim.AdamW(params, lr=base_lr, betas=(0.95, 0.99),
                            eps=1e-8, weight_decay=0.01)
    sched = torch.optim.lr_scheduler.LambdaLR(opt,
                                              cyclic_lr(1.0, total_iters))
    return opt, sched


def clip_grad_norm_(params, max_norm=CLIP_NORM):
    """Clip the gradients at global norm ``max_norm``; returns the norm.
    torch scales by ``max_norm / (norm + 1e-6)`` where optax's
    ``clip_by_global_norm`` scales by ``max_norm / norm``: a relative
    difference below 1e-7 at the norms (> 10) where either clips."""
    return torch.nn.utils.clip_grad_norm_(params, max_norm)
