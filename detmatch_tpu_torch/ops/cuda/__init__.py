"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

``KERNELS`` and ``PLAIN`` bundle the ops of the DetMatch SSL iteration
(the three of PV-RCNN, the JV assignment of the fusion matching, and the
key-compare and rulebook sparse convs that ``VoxelBackbone8x`` runs in
place of the windowed one with ``conv_impl="key"`` or ``"rulebook"``)
with identical signatures. ``KERNELS``
launches the CUDA kernels on CUDA tensors and runs the twins on CPU
tensors; the models always use it. The windowed and key-compare convs
carry a gradient whose backward is a kernel too (``window_key_conv_bwd``,
``key_conv_bwd``); the rulebook conv's backward is fp32 tensor code, as
in JAX. ``PLAIN`` runs the twins on any device, and autograd
differentiates them (the key conv's twin through JAX's own backward): it
exists only for verification, where ``chip_smoke.py`` sets
``model.ops = PLAIN`` to check the kernels against their twins end to
end on the card. ``LAUNCHERS`` also holds the wrappers of the one-hot
ops K6 and K8 (``onehot_gather``, ``onehot_rows``), which no model calls;
K6's S also counts its two paths (``onehot_gather_scatter.direct`` and
``.sorted``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from .ball_query import ball_query_batched, ball_query_plain
from .fps import fps_batched, fps_plain
from .gather_conv import gather_conv_batched, gather_conv_plain
from .hungarian import solve_masked_batched, solve_masked_plain
from .key_conv import key_conv_batched, key_conv_bwd, key_conv_plain
from .onehot_gather import onehot_gather_conv, onehot_gather_scatter
from .onehot_rows import onehot_scatter_rows, onehot_take_rows_batched
from .window_key_conv import (window_key_conv_batched, window_key_conv_bwd,
                              window_key_conv_plain)


class Ops(NamedTuple):
    window_key_conv_batched: Callable
    fps_batched: Callable
    ball_query_batched: Callable
    solve_masked_batched: Callable
    key_conv_batched: Callable
    gather_conv_batched: Callable


KERNELS = Ops(window_key_conv_batched, fps_batched, ball_query_batched,
              solve_masked_batched, key_conv_batched, gather_conv_batched)
PLAIN = Ops(window_key_conv_plain, fps_plain, ball_query_plain,
            solve_masked_plain, key_conv_plain, gather_conv_plain)
# every launching wrapper, each with its own ``.launches`` counter
LAUNCHERS = (*KERNELS, window_key_conv_bwd, key_conv_bwd, onehot_gather_conv,
             onehot_gather_scatter, onehot_take_rows_batched,
             onehot_scatter_rows)


def reset_launch_counts():
    for fn in LAUNCHERS:
        fn.launches = 0
    onehot_gather_scatter.direct = onehot_gather_scatter.sorted = 0


def launch_counts():
    return {fn.__name__: fn.launches for fn in LAUNCHERS}
