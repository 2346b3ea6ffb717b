"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

``KERNELS`` and ``PLAIN`` bundle the ops of the DetMatch SSL iteration
(the three of PV-RCNN, the JV assignment of the fusion matching, and the
key-compare sparse conv that ``VoxelBackbone8x(conv_impl="key")`` runs in
place of the windowed one) with identical signatures. ``KERNELS``
launches the CUDA kernels on CUDA tensors and runs the twins on CPU
tensors; the models always use it. Both sparse convs carry a gradient
whose backward is a kernel too (``window_key_conv_bwd``,
``key_conv_bwd``). ``PLAIN`` runs the twins on any device, and autograd
differentiates them (the key conv's twin through JAX's own backward): it
exists only for verification, where ``chip_smoke.py`` sets
``model.ops = PLAIN`` to check the kernels against their twins end to
end on the card.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from .ball_query import ball_query_batched, ball_query_plain
from .fps import fps_batched, fps_plain
from .hungarian import solve_masked_batched, solve_masked_plain
from .key_conv import key_conv_batched, key_conv_bwd, key_conv_plain
from .window_key_conv import (window_key_conv_batched, window_key_conv_bwd,
                              window_key_conv_plain)


class Ops(NamedTuple):
    window_key_conv_batched: Callable
    fps_batched: Callable
    ball_query_batched: Callable
    solve_masked_batched: Callable
    key_conv_batched: Callable


KERNELS = Ops(window_key_conv_batched, fps_batched, ball_query_batched,
              solve_masked_batched, key_conv_batched)
PLAIN = Ops(window_key_conv_plain, fps_plain, ball_query_plain,
            solve_masked_plain, key_conv_plain)
# every launching wrapper, each with its own ``.launches`` counter
LAUNCHERS = (*KERNELS, window_key_conv_bwd, key_conv_bwd)


def reset_launch_counts():
    for fn in LAUNCHERS:
        fn.launches = 0


def launch_counts():
    return {fn.__name__: fn.launches for fn in LAUNCHERS}
