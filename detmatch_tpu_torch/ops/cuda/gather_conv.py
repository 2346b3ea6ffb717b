"""Rulebook gather-GEMM sparse conv (K7): the CUDA kernel, the
gather-GEMM tile of ``csrc/gather_gemm.cuh`` in map mode on the rulebook
(entry point ``dm_gather_conv_fwd`` in ``csrc/gather_conv.cu``, replacing
the TPU kernel ``detmatch_tpu/ops/pallas/spconv_kernel.py:
pallas_gather_conv``), and its plain PyTorch twin
``spconv.gather_conv_batched``, joined by one ``torch.autograd.Function``.

The function is JAX's ``spconv.gather_conv_batched``, the conv of the
rulebook path (``VoxelBackbone8x(conv_impl="rulebook")``, JAX's
``conv_impl="xla"``), in fp32. JAX differentiates it with XLA's autodiff
and has no backward kernel, so the backward here is plain fp32 tensor
code: S[k, n] = sum_m 1[rb[m, k] == n] * dout[m], one indexed store
(a spconv rulebook sends each input row to at most one output row per
tap, so each slot has one writer; repeats are summed deterministically),
then K5's two einsums, dF = sum_k S_k W_k^T and dW_k = F^T S_k.

The tile gathers and multiplies matched (row, tap) pairs only and sums
in K1's order, so K7 equals K1's forward on the same rulebook bit for
bit. It copies 16-byte vectors: where C or Co is not a multiple of 4, or
the features or weights do not start on 16 bytes
(``window_key_conv.needs_pad``),
the wrapper allocates zero-padded scratch (``key_conv.rounded_shapes``)
that a prologue fills. On a CPU tensor the wrapper runs the twin; on a
CUDA tensor it launches the kernel or raises, with no fallback.

Shape limits on the card (K1's tile): C and Co up to 128, C * Co up to
16,384, K up to 27 taps, B * N and B * M below 2^31; past them
:func:`check_args` raises ValueError. The rulebook path's widest conv is
PV-RCNN's backbone at C, Co <= 64.
``gather_conv_plain`` runs the twin on any device (for verification).
"""
from __future__ import annotations

import torch

from .. import spconv
from . import build
from .key_conv import key_conv_grads, rounded_shapes
from .window_key_conv import needs_pad, tile_rows

# csrc/gather_conv.cu limits (any C and Co within them: the wrapper pads)
MAX_TAPS, MAX_CIN, MAX_COUT, MAX_W = 27, 128, 128, 16384


def check_args(name, feats, rulebook, weights):
    """The kernels' device, type, shape and size limits: feats (B, N, C),
    rulebook (B, M, K), weights (K, C, Co); returns the device and
    (b, n, m, k, c, co)."""
    dev = build.require_cuda(name, feats, rulebook, weights)
    for t, dtype, what in ((feats, torch.float32, "feats"),
                           (rulebook, torch.int32, "rulebook"),
                           (weights, torch.float32, "weights")):
        build.require_dtype(name, t, dtype, what)
    b, n, c = feats.shape
    m, k = rulebook.shape[1], rulebook.shape[2]
    co = weights.shape[-1]
    if rulebook.shape[0] != b or weights.shape != (k, c, co):
        raise ValueError(f"{name}: shapes do not match feats (B, N, C), "
                         "rulebook (B, M, K), weights (K, C, Co)")
    if (n == 0 or k > MAX_TAPS or c > MAX_CIN or co > MAX_COUT
            or c * co > MAX_W or b * n >= 2 ** 31 or b * m >= 2 ** 31):
        raise ValueError(f"{name}: needs N > 0, B * N and B * M < 2^31, "
                         f"K <= {MAX_TAPS}, C <= {MAX_CIN}, Co <= "
                         f"{MAX_COUT}, C * Co <= {MAX_W}; got B={b} N={n} "
                         f"M={m} K={k} C={c} Co={co}")
    return dev, (b, n, m, k, c, co)


def k7_tile_rows(k, c, co):
    """Output rows of a K7 block: ``window_key_conv.tile_rows`` at C and
    Co up to multiples of 4, the tile's widths."""
    return tile_rows(*rounded_shapes(0, 0, k, c, co)[1])


def gather_conv_fwd(feats, rulebook, weights, rows=None):
    """K7 on the card: (B, M, Co) float32 from feats (B, N, C), the
    rulebook (B, M, K) int32 (rows of the same sample; -1 and any other
    entry outside [0, N) = none) and weights (K, C, Co), at ``rows``
    output rows a block (None: :func:`k7_tile_rows`; other values for
    measurement)."""
    name = "gather_conv_batched"
    dev, (b, n, m, k, c, co) = check_args(name, feats, rulebook, weights)
    out = torch.empty((b, m, co), dtype=torch.float32, device=dev)
    f_shape, w_shape = rounded_shapes(b, n, k, c, co)
    pad = needs_pad(feats, weights)
    fp = torch.empty(f_shape, dtype=torch.float32, device=dev) if pad else None
    wp = torch.empty(w_shape, dtype=torch.float32, device=dev) if pad else None
    lib = build.load_library()
    err = lib.dm_gather_conv_fwd(
        build.ptr(feats), build.ptr(rulebook), build.ptr(weights),
        build.ptr(fp), build.ptr(wp), build.ptr(out), b, n, m, k, c, co,
        k7_tile_rows(k, c, co) if rows is None else rows, build.stream(dev))
    gather_conv_batched.launches += 1
    build.check(lib, err, name)
    return out


def gather_conv_grads(dout, feats, rulebook, weights, need_dfeats=True):
    """fp32 (dfeats (B, N, C) or None, dweights (K, C, Co)) of the
    rulebook conv from S (K, B * N, Co) = dout at each (tap, input row)."""
    b, n, _ = feats.shape
    bi, mi, ki = (rulebook >= 0).nonzero(as_tuple=True)
    s = dout.new_zeros((rulebook.shape[-1], b * n, dout.shape[-1]))
    s.index_put_((ki, bi * n + rulebook[bi, mi, ki].long()), dout[bi, mi],
                 accumulate=True)
    return key_conv_grads(s, feats, weights, need_dfeats)


class GatherConv(torch.autograd.Function):
    """``forward`` computes the output (the kernel or the twin); the
    backward is :func:`gather_conv_grads` for both."""

    @staticmethod
    def forward(ctx, feats, rulebook, weights, forward):
        ctx.save_for_backward(feats, rulebook, weights)
        return forward(feats, rulebook, weights)

    @staticmethod
    def backward(ctx, dout):
        feats, rulebook, weights = ctx.saved_tensors
        dfeats, dw = gather_conv_grads(dout, feats, rulebook, weights,
                                       ctx.needs_input_grad[0])
        return dfeats, None, dw, None


def gather_conv_plain(feats, rulebook, weights):
    """Plain twin of :func:`gather_conv_batched` (same arguments)."""
    return GatherConv.apply(feats, rulebook, weights,
                            spconv.gather_conv_batched)


def gather_conv_batched(feats, rulebook, weights):
    """Sparse conv over a rulebook, the JAX ``gather_conv_batched``
    signature, with a gradient for ``feats`` and ``weights``.

    Args:
        feats: (B, N, C) float32; rulebook: (B, M, K) int32 input rows of
            each output row's taps in its own sample, -1 = no input
            (``spconv.rulebook_batched``); weights: (K, C, Co) float32.
    Returns:
        (B, M, Co) float32.
    """
    if feats.device.type == "cpu":
        return gather_conv_plain(feats, rulebook, weights)
    return GatherConv.apply(feats, rulebook, weights, gather_conv_fwd)


gather_conv_batched.launches = 0
