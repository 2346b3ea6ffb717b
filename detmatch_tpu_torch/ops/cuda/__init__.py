"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

``KERNELS`` and ``PLAIN`` bundle the three ops of the PV-RCNN inference
path with identical signatures. ``KERNELS`` launches the CUDA kernels on
CUDA tensors and runs the twins on CPU tensors; the model always uses
it. ``PLAIN`` runs the twins on any device: it exists only for
verification, where ``chip_smoke.py`` sets ``model.ops = PLAIN`` to check
the kernels against their twins end to end on the card.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from .ball_query import ball_query_batched, ball_query_plain
from .fps import fps_batched, fps_plain
from .window_key_conv import window_key_conv_batched, window_key_conv_plain


class Ops(NamedTuple):
    window_key_conv_batched: Callable
    fps_batched: Callable
    ball_query_batched: Callable


KERNELS = Ops(window_key_conv_batched, fps_batched, ball_query_batched)
PLAIN = Ops(window_key_conv_plain, fps_plain, ball_query_plain)


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0


def launch_counts():
    return {fn.__name__: fn.launches for fn in KERNELS}
