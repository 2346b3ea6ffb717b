"""Optimisers and learning-rate schedules (counterpart of
``detmatch_tpu/train/optim.py``).

* 3D pretraining (``pretrain_pvrcnn/split_0.py:320-346``): the one-cycle
  rate of mmcv's CyclicLrUpdater as a plain function of the iteration,
  ``torch.optim.AdamW`` (betas .95/.99, weight decay .01) under it, and
  gradient clipping at global norm 10.
* The DetMatch SSL step (``detmatch/split_0.py:824-852``): one optimiser
  per student branch, each the optax chain of the JAX package in its
  order of operations — skip the step if any gradient is not finite;
  clip at global norm 10; then AdamW (betas .95/.99, eps 1e-8, decoupled
  weight decay .01 added after the Adam scaling) for the PV-RCNN, or SGD
  (weight decay 1e-4 added before the momentum-0.9 trace) for the Faster
  R-CNN; scaled by the linear-warmup step rate.

Under several processes (``parallel``) each process's loss is its share
of the global batch's loss, so the gradient is summed over the
processes, in one flat buffer, before anything reads it: the skip, the
clip and the update see the global gradient on every process.
"""
from __future__ import annotations

import math

import torch

from ..parallel import all_reduce_grads

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


def warmup_step_lr(base_lr, warmup_iters=500, warmup_ratio=0.001,
                   step_iters=(), gamma=0.1):
    """mmcv StepLrUpdater with linear warmup, as ``fn(count) -> float``
    in the JAX schedule's float32 arithmetic."""
    def fn(it):
        it = torch.tensor(float(it), dtype=torch.float32)
        warm = warmup_ratio + (1 - warmup_ratio) * torch.clamp(
            it / max(warmup_iters, 1), max=1.0)
        lr = base_lr * warm
        for s in step_iters:
            lr = torch.where(it >= s, lr * gamma, lr)
        return lr
    return fn


class BranchOptimizer:
    """The JAX ``detmatch_branch_optimizers`` chain over one student
    branch: ``skip_nonfinite(chain(clip_by_global_norm(clip_norm),
    adamw | sgd_momentum))``, on the gradient summed over the processes.

    Every parameter takes part, a missing gradient counting as zero
    (the frozen ResNet stages get weight decay, as in optax). A step
    whose gradients are not all finite changes nothing but ``skipped``.
    The rate of the ``count``-th applied update (from 0) is
    ``lr_fn(count)``.

    ``step_interval`` k (JAX's ``every_k_steps`` around the inner
    optimizer, as ``hybrid_optimizer(step_intervals=...)`` places it;
    reference ``hybrid_optimizer.py:87-93``): ``calls`` advances on every
    step with finite gradients, and the update fires when ``calls % k ==
    0``, from that call's gradients alone; otherwise the parameters, the
    moments and ``count`` stay as they are.

    Args:
        params: the branch's parameters.
        kind: "adamw" (betas (0.95, 0.99), eps 1e-8, weight decay 0.01)
            or "sgd" (momentum 0.9, weight decay 1e-4).
    """

    def __init__(self, params, kind, lr_fn, clip_norm=CLIP_NORM,
                 step_interval=1):
        if kind not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer kind {kind!r}")
        if step_interval < 1:
            raise ValueError(f"step_interval {step_interval} < 1")
        self.params = list(params)
        self.kind = kind
        self.lr_fn = lr_fn
        self.clip_norm = clip_norm
        self.step_interval = int(step_interval)
        self.calls = 0
        self.count = 0
        self.skipped = 0
        zeros = [torch.zeros_like(p) for p in self.params]
        if kind == "adamw":
            self.b1, self.b2, self.eps, self.wd = 0.95, 0.99, 1e-8, 0.01
            self.mu, self.nu = zeros, [torch.zeros_like(p)
                                       for p in self.params]
        else:
            self.momentum, self.wd = 0.9, 1e-4
            self.trace = zeros

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _moments(self):
        return (dict(mu=self.mu, nu=self.nu) if self.kind == "adamw"
                else dict(trace=self.trace))

    def state_dict(self):
        """The optimizer's state: ``count``, ``calls``, ``skipped`` and
        its moment lists (``mu``, ``nu`` for AdamW, ``trace`` for SGD),
        cloned."""
        return dict(kind=self.kind, count=self.count, calls=self.calls,
                    skipped=self.skipped,
                    **{k: [t.clone() for t in v]
                       for k, v in self._moments().items()})

    @torch.no_grad()
    def load_state_dict(self, state):
        """Restore :meth:`state_dict`'s output, copying each moment into
        this optimizer's tensors on their device."""
        if state["kind"] != self.kind:
            raise ValueError(f"a {state['kind']} state for a {self.kind} "
                             "optimizer")
        for k, dst in self._moments().items():
            if len(state[k]) != len(dst):
                raise ValueError(f"{k}: {len(state[k])} tensors for "
                                 f"{len(dst)} parameters")
            for d, s in zip(dst, state[k]):
                d.copy_(s)
        self.count = int(state["count"])
        self.calls = int(state.get("calls", self.count))
        self.skipped = int(state["skipped"])

    @torch.no_grad()
    def step(self):
        """Apply one update from the parameters' ``.grad``; returns False
        if it was skipped. Under several processes the trainable
        parameters' gradients are first summed over them (one flat
        all-reduce) and the sums left in ``.grad``."""
        all_reduce_grads(self.params)
        g = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in self.params]
        finite = torch.stack([torch.isfinite(x).all() for x in g]).all()
        if not bool(finite):
            self.skipped += 1
            return False
        self.calls += 1
        if self.calls % self.step_interval:
            return False
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(g)))
        if not bool(norm < self.clip_norm):
            g = torch._foreach_mul(torch._foreach_div(g, norm),
                                   self.clip_norm)
        dev = self.params[0].device
        step_size = -self.lr_fn(self.count).to(dev)
        self.count += 1
        if self.kind == "adamw":
            u = self._adam(g)
            torch._foreach_add_(u, torch._foreach_mul(self.params, self.wd))
        else:
            u = torch._foreach_add(g, torch._foreach_mul(self.params,
                                                         self.wd))
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, u)
            u = self.trace
        torch._foreach_add_(self.params, torch._foreach_mul(u, step_size))
        return True

    def _adam(self, g):
        """optax ``scale_by_adam``: the bias-corrected moment ratio."""
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - b2))
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(b1, dtype=f32) ** self.count)
        bc2 = float(1 - torch.tensor(b2, dtype=f32) ** self.count)
        denom = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(self.nu, bc2)), self.eps)
        return torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)


def detmatch_branch_optimizers(ssl, lr_3d, lr_2d, warmup_iters=500,
                               clip_norm=CLIP_NORM, step_intervals=None):
    """(AdamW over ``ssl.student.det3d``, SGD over ``ssl.student.det2d``)
    under linear-warmup step rates, as the JAX
    ``detmatch_branch_optimizers``; ``step_intervals`` ({"det3d": k,
    "det2d": k}, missing keys 1) sets each branch's ``step_interval``."""
    k = dict(step_intervals or {})
    return (BranchOptimizer(ssl.student["det3d"].parameters(), "adamw",
                            warmup_step_lr(lr_3d, warmup_iters), clip_norm,
                            k.get("det3d", 1)),
            BranchOptimizer(ssl.student["det2d"].parameters(), "sgd",
                            warmup_step_lr(lr_2d, warmup_iters), clip_norm,
                            k.get("det2d", 1)))
