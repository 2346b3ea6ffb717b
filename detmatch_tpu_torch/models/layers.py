"""Shared building blocks (counterpart of ``detmatch_tpu/models/layers.py``).

The port keeps pcdet's own module types (``BatchNorm1d``/``BatchNorm2d``,
``Linear``, ``Conv1d``/``Conv2d``, ``Dropout``) so the state dict matches
a reference checkpoint; these helpers apply them the way the JAX
reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def masked_bn(bn: nn.modules.batchnorm._BatchNorm, x, mask=None):
    """Batch norm over the LAST axis of ``x`` — the JAX ``MaskedBatchNorm``.

    Eval (``bn.training`` False): running statistics. Train: statistics
    over the rows where ``mask`` is True (all rows if None), the count
    clamped at >= 1; the biased variance normalises and the unbiased one
    (count / (count - 1)) enters ``running_var``, with ``bn.momentum``
    (0.01 throughout the model). Padded rows do not move the statistics.
    Rows where ``mask`` is False come out zero.
    """
    if bn.training:
        c = x.shape[-1]
        xf = x.reshape(-1, c)
        if mask is None:
            cnt = xf.shape[0]
            mean = xf.mean(0)
            var = ((xf - mean) ** 2).mean(0)
            unbiased = var * (cnt / max(cnt - 1, 1))
        else:
            m = mask.reshape(-1, 1).to(x.dtype)
            cnt = torch.clamp(m.sum(), min=1.0)
            mean = (xf * m).sum(0) / cnt
            var = ((xf - mean) ** 2 * m).sum(0) / cnt
            unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
        with torch.no_grad():
            bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
            bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * unbiased)
            bn.num_batches_tracked.add_(1)
    else:
        mean, var = bn.running_mean, bn.running_var
    y = (x - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias
    if mask is not None:
        y = torch.where(mask[..., None], y, 0.0)
    return y


def dropout(x, p, generator):
    """Inverted dropout with its mask drawn from ``generator`` (the JAX
    ``nn.Dropout``: keep with probability 1 - p, scale kept values by
    1 / (1 - p)); the identity for p = 0."""
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def pointwise(layer, x):
    """Apply a Linear / 1x1 Conv1d / 1x1 Conv2d over the last axis of
    (..., Cin) ``x`` (pcdet stores some pointwise layers as convs)."""
    w = layer.weight
    return F.linear(x, w.reshape(w.shape[0], w.shape[1]), layer.bias)


def bn_pairs(seq):
    """The (linear-like, batch-norm) pairs of a pcdet layer stack
    (``Sequential`` of conv/linear, BN, ReLU[, Dropout] units)."""
    return [(seq[i], seq[i + 1]) for i in range(len(seq) - 1)
            if isinstance(seq[i + 1], nn.modules.batchnorm._BatchNorm)]


def mlp(pairs, x, mask=None):
    """Pointwise (Linear, BN, ReLU) stack over the last axis — the JAX
    ``MLP``; ``pairs`` lists the (linear-like, batch-norm) modules."""
    for lin, bn in pairs:
        x = torch.relu(masked_bn(bn, pointwise(lin, x), mask))
    return x
