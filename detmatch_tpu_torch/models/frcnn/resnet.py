"""ResNet-50 (caffe style) with frozen batch norm, and the FPN neck
(counterpart of ``detmatch_tpu/models/frcnn/resnet.py``; mmdet's
``ResNet(style="caffe", norm_eval=True)`` and ``FPN``).

NCHW throughout. Module names follow mmdet's state-dict keys
(``conv1``, ``bn1``, ``layer{s}.{b}.conv1`` ... ``downsample.0/1``,
``lateral_convs.{i}.conv``, ``fpn_convs.{i}.conv``), so an mmdet
checkpoint loads with ``load_state_dict``. Frozen BN constants are
buffers: no optimiser sees them.

``dtype`` (bfloat16) runs every conv in it (JAX ``resnet.py:46-122``):
the activations between the convs are bfloat16, frozen batch norm
computes in float32 and casts back to its input's dtype.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import conv


class FrozenBN(nn.Module):
    """y = x * inv + (bias - mean * inv), inv = rsqrt(var + eps) * weight:
    the JAX ``FrozenBN`` in its operation order."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return (x.float() * inv[:, None, None]
                + shift[:, None, None]).to(x.dtype)


class _ConvModule(nn.Module):
    """mmcv ``ConvModule`` without norm or activation: the ``.conv``
    level of mmdet's FPN keys."""

    def __init__(self, cin, cout, k, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=padding)

    def forward(self, x, dtype=None):
        return conv(self.conv, x, dtype)


class Bottleneck(nn.Module):
    """Caffe-style bottleneck: the stride sits on the first 1x1 conv."""

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride=stride,
                               bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBN(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBN(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            FrozenBN(planes * 4)) if downsample else None)

    def forward(self, x):
        dt = self.dtype
        out = F.relu(self.bn1(conv(self.conv1, x, dt)))
        out = F.relu(self.bn2(conv(self.conv2, out, dt)))
        out = self.bn3(conv(self.conv3, out, dt))
        identity = x if self.downsample is None else self.downsample[1](
            conv(self.downsample[0], x, dt))
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """Stem (7x7/2 conv, 3x3/2 max pool) and four stages of
    ``stage_blocks`` bottlenecks → (C2, C3, C4, C5)."""

    def __init__(self, stage_blocks: Tuple[int, ...] = (3, 4, 6, 3),
                 frozen_stages: int = 1, dtype=None):
        super().__init__()
        self.frozen_stages = frozen_stages  # no gradients reach them
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(64)
        inplanes = 64
        for stage, n_blocks in enumerate(stage_blocks):
            planes = 64 * 2 ** stage
            blocks = [Bottleneck(inplanes, planes,
                                 stride=1 if stage == 0 else 2,
                                 downsample=True, dtype=dtype)]
            blocks += [Bottleneck(planes * 4, planes, dtype=dtype)
                       for _ in range(n_blocks - 1)]
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            inplanes = planes * 4
        self.num_stages = len(stage_blocks)

    def forward(self, x):
        x = F.relu(self.bn1(conv(self.conv1, x, self.dtype)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            if self.frozen_stages >= stage + 1:
                x = x.detach()
            outs.append(x)
        return tuple(outs)


class FPN(nn.Module):
    """1x1 laterals, a top-down pass of nearest upsampling, 3x3 output
    convs, and a 5th level that takes every other pixel of P5 (mmdet's
    stride-2 1x1 max pool)."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=256,
                 num_outs=5, dtype=None):
        super().__init__()
        self.num_outs = num_outs
        self.dtype = dtype
        self.lateral_convs = nn.ModuleList(
            _ConvModule(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            _ConvModule(out_channels, out_channels, 3, padding=1)
            for _ in in_channels)

    def forward(self, inputs):
        laterals = [m(c, self.dtype)
                    for m, c in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            # half-pixel nearest: jax.image.resize(method="nearest") at
            # every size ratio, not only at exact 2x
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[-2:],
                mode="nearest-exact")
        outs = [m(lat, self.dtype) for m, lat in zip(self.fpn_convs,
                                                     laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(outs)
