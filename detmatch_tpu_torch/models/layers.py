"""Shared building blocks (counterpart of ``detmatch_tpu/models/layers.py``).

The port keeps pcdet's own module types (``BatchNorm1d``/``BatchNorm2d``,
``Linear``, ``Conv1d``/``Conv2d``) so the state dict matches a reference
checkpoint; these helpers apply them the way the JAX reference does.
This slice is inference only: batch norm uses its running statistics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def masked_bn(bn: nn.modules.batchnorm._BatchNorm, x, mask=None):
    """Batch norm over the LAST axis of ``x`` with running statistics —
    the JAX ``MaskedBatchNorm`` at eval; rows where ``mask`` is False
    come out zero."""
    if bn.training:
        raise NotImplementedError(
            "train-mode batch statistics are not ported yet; call .eval()")
    y = ((x - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
         * bn.weight + bn.bias)
    if mask is not None:
        y = torch.where(mask[..., None], y, 0.0)
    return y


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
