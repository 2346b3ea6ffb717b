"""Shared building blocks (counterpart of ``detmatch_tpu/models/layers.py``).

The port keeps pcdet's own module types (``BatchNorm1d``/``BatchNorm2d``,
``Linear``, ``Conv1d``/``Conv2d``, ``Dropout``) so the state dict matches
a reference checkpoint; these helpers apply them the way the JAX
reference does.

Compute dtype (the JAX ``compute_dtype``, ``dtype`` of its ``nn.Dense`` /
``nn.Conv`` / ``ConvBNReLU``): with ``dtype=torch.bfloat16`` a linear or
conv casts its input and its float32 parameters to bfloat16 at use and
returns bfloat16, the bias (if any) added after the product in bfloat16,
as flax does. Batch norm takes its statistics and normalises in float32
and casts back to its input's dtype. A layer without ``dtype`` that is
given a bfloat16 input computes in float32, as flax promotes it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import global_rows, global_sum_grad, process_count


def masked_bn(bn: nn.modules.batchnorm._BatchNorm, x, mask=None):
    """Batch norm over the LAST axis of ``x`` — the JAX ``MaskedBatchNorm``.

    Eval (``bn.training`` False): running statistics. Train: statistics
    over the rows where ``mask`` is True (all rows if None), the count
    clamped at >= 1; the biased variance normalises and the unbiased one
    (count / (count - 1)) enters ``running_var``, with ``bn.momentum``
    (0.01 throughout the model). Padded rows do not move the statistics.
    Rows where ``mask`` is False come out zero. Statistics and the
    normalisation are float32 whatever ``x``'s dtype; the result has
    ``x``'s dtype. Under several processes the statistics are over every
    process's rows (:func:`global_moments`).
    """
    if bn.training:
        c = x.shape[-1]
        xf = x.reshape(-1, c).float()
        m = None if mask is None else mask.reshape(-1, 1).to(torch.float32)
        mean, var, unbiased = global_moments(xf, (0,), m)
        update_running_stats(bn, mean, unbiased)
    else:
        mean, var = bn.running_mean, bn.running_var
    y = (x.float() - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias
    if mask is not None:
        y = torch.where(mask[..., None], y, 0.0)
    return y.to(x.dtype)


def global_moments(xf, dims, m=None):
    """(mean, biased var, unbiased var) per channel of float32 ``xf`` over
    the axes ``dims`` and over every process's rows where ``m`` (R, 1)
    (a float 0/1 mask of the rows of (R, C) ``xf``; every row if None),
    two-pass: the global count and sum give the mean, the global sum of
    squared deviations the variance (the count clamped at 1).
    Differentiable through both collectives; one process's own rows
    without a process group."""
    keep = [1 if d in dims else s for d, s in enumerate(xf.shape)]
    if m is None:
        s = xf.sum(dims)
        cnt = xf.new_tensor(float(np.prod([xf.shape[d] for d in dims])))
    else:
        s = (xf * m).sum(dims)
        cnt = m.sum()
    sc = global_sum_grad(torch.cat([s, cnt.reshape(1)]))
    cnt = torch.clamp(sc[-1].detach(), min=1.0)
    mean = sc[:-1] / cnt
    dev = (xf - mean.reshape(keep)) ** 2
    var = global_sum_grad((dev if m is None else dev * m).sum(dims)) / cnt
    return mean, var, var * cnt / torch.clamp(cnt - 1.0, min=1.0)


def update_running_stats(bn, mean, unbiased):
    """Move ``bn``'s running statistics toward a batch's (momentum
    ``bn.momentum``), as torch's batch norm does."""
    with torch.no_grad():
        bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
        bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * unbiased)
        bn.num_batches_tracked.add_(1)


def batch_norm_2d(bn, x):
    """A ``BatchNorm2d`` on an NCHW map of any dtype, in float32, cast
    back to ``x``'s dtype: torch's own batch norm in one process; in
    train mode under several processes, statistics over the global
    (B, H, W) (:func:`global_moments`)."""
    if not (bn.training and process_count() > 1):
        return bn(x.float()).to(x.dtype)
    xf = x.float()
    mean, var, unbiased = global_moments(xf, (0, 2, 3))
    update_running_stats(bn, mean, unbiased)
    shape = (1, -1, 1, 1)
    y = ((xf - mean.reshape(shape)) * torch.rsqrt(var + bn.eps).reshape(shape)
         * bn.weight.reshape(shape) + bn.bias.reshape(shape))
    return y.to(x.dtype)


def _low(dtype):
    return dtype is not None and dtype != torch.float32


def linear(x, weight, bias=None, dtype=None):
    """``x @ weight.T + bias`` in ``dtype`` (float32 if None)."""
    if not _low(dtype):
        return F.linear(x.float(), weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def conv(layer, x, dtype=None):
    """A ``Conv2d`` or ``ConvTranspose2d`` module applied in ``dtype``
    (float32 if None)."""
    if not _low(dtype):
        return layer(x.float())
    w = layer.weight.to(dtype)
    if isinstance(layer, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x.to(dtype), w, None, layer.stride,
                               layer.padding, layer.output_padding,
                               layer.groups, layer.dilation)
    else:
        y = F.conv2d(x.to(dtype), w, None, layer.stride, layer.padding,
                     layer.dilation, layer.groups)
    return y if layer.bias is None else y + layer.bias.to(dtype)[:, None,
                                                                   None]


def dropout(x, p, generator, row_groups=1):
    """Inverted dropout with its mask drawn from ``generator`` (the JAX
    ``nn.Dropout``: keep with probability 1 - p, scale kept values by
    1 / (1 - p)); the identity for p = 0. The leading axis of ``x`` is the
    batch (``row_groups`` parts, as ``parallel.global_rows``): the mask
    is drawn at the global batch's shape and this process keeps its
    rows."""
    if p == 0.0:
        return x
    rows, total = global_rows(x.shape[0], row_groups)
    u = torch.rand((total,) + tuple(x.shape[1:]), generator=generator,
                   device=x.device)
    keep = (u if total == x.shape[0] else u[rows]) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def pointwise(layer, x, dtype=None):
    """Apply a Linear / 1x1 Conv1d / 1x1 Conv2d over the last axis of
    (..., Cin) ``x`` in ``dtype`` (pcdet stores some pointwise layers as
    convs)."""
    w = layer.weight
    return linear(x, w.reshape(w.shape[0], w.shape[1]), layer.bias, dtype)


def bn_pairs(seq):
    """The (linear-like, batch-norm) pairs of a pcdet layer stack
    (``Sequential`` of conv/linear, BN, ReLU[, Dropout] units)."""
    return [(seq[i], seq[i + 1]) for i in range(len(seq) - 1)
            if isinstance(seq[i + 1], nn.modules.batchnorm._BatchNorm)]


def mlp(pairs, x, mask=None, dtype=None):
    """Pointwise (Linear, BN, ReLU) stack over the last axis — the JAX
    ``MLP``; ``pairs`` lists the (linear-like, batch-norm) modules, the
    linear layers run in ``dtype``."""
    for lin, bn in pairs:
        x = torch.relu(masked_bn(bn, pointwise(lin, x, dtype), mask))
    return x
