"""The JAX package's initialisers, for every model the port builds.

flax gives a ``Dense``, ``Conv`` or ``ConvTranspose`` kernel LeCun-normal
draws (``variance_scaling(1, "fan_in", "truncated_normal")``) and a zero
bias unless the module names its own initialiser; the sparse convs draw
He-normal (the same with scale 2). flax's fan-in is the kernel's
receptive field times its input channels in JAX's layout, which for a
``ConvTranspose2d`` is dim 0 of PyTorch's weight (PyTorch's own default
takes dim 1 there).

Each detector ends its constructor with :func:`init_like_jax`: flax's
defaults on every conv and linear layer, then every module's own
``init_explicit()`` (the prior biases, the N(0, 0.001) box regressors),
so an explicit initialiser always wins. The draws come from PyTorch's
generator of the device the tensor lies on: ``apis/build.py`` builds
on the CPU and then moves the model, so one seed gives the same weights
on the CPU and the card. The port follows JAX in distribution, not draw
for draw (``jax.random`` and ``torch.Generator`` share no stream).
"""
from __future__ import annotations

import math

import torch
from torch import nn

# std of a standard normal truncated to (-2, 2): flax divides by it so
# that the truncated draw keeps the variance asked for
TRUNC_STD = 0.87962566103423978
# -log((1 - 0.01) / 0.01): the logit of a 0.01 prior (JAX's prior biases)
PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
# the layers that take flax's default kernel and bias initialisers
DEFAULT_INIT = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                nn.Linear)


def fan_in(layer: nn.Module) -> int:
    """flax's fan-in of ``layer``'s kernel: receptive field × input
    channels (dim 0 of a ``ConvTranspose2d``'s weight, dim 1 of any other
    conv's or a ``Linear``'s)."""
    w = layer.weight
    cin = w.shape[0 if isinstance(layer, nn.ConvTranspose2d) else 1]
    return cin * math.prod(w.shape[2:])


def _normal_cdf(x: float) -> float:
    return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0


@torch.no_grad()
def variance_scaling_(w: torch.Tensor, scale: float, fan: int):
    """flax's ``variance_scaling(scale, "fan_in", "truncated_normal")``:
    a normal of std sqrt(scale / fan) / :data:`TRUNC_STD` truncated at
    two of that std, in place. Drawn by the inverse CDF of one uniform an
    element, as ``jax.random.truncated_normal`` draws it and as PyTorch's
    ``nn.init.trunc_normal_`` did before it turned to rejection (which
    redraws the whole tensor each round: seconds a build at full
    width)."""
    std = math.sqrt(scale / fan) / TRUNC_STD
    lo, hi = -2.0 * std, 2.0 * std
    w.uniform_(2.0 * _normal_cdf(lo / std) - 1.0,
               2.0 * _normal_cdf(hi / std) - 1.0)
    w.erfinv_().mul_(std * math.sqrt(2.0))
    return w.clamp_(min=lo, max=hi)


def lecun_normal_(w: torch.Tensor, fan: int):
    """flax's ``lecun_normal`` over fan-in ``fan``, in place."""
    return variance_scaling_(w, 1.0, fan)


def he_normal_(w: torch.Tensor, fan: int):
    """flax's ``he_normal`` over fan-in ``fan``, in place."""
    return variance_scaling_(w, 2.0, fan)


@torch.no_grad()
def init_like_jax(model: nn.Module) -> nn.Module:
    """Give every layer of :data:`DEFAULT_INIT` in ``model`` flax's
    defaults (LeCun-normal weight, zero bias), then call every module's
    ``init_explicit()``; returns ``model``."""
    for m in model.modules():
        if isinstance(m, DEFAULT_INIT):
            lecun_normal_(m.weight, fan_in(m))
            if m.bias is not None:
                m.bias.zero_()
    for m in model.modules():
        if hasattr(m, "init_explicit"):
            m.init_explicit()
    return model
