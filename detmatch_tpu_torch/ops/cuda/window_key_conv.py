"""Sparse 3D conv over sorted voxel keys, forward and backward: CUDA
kernels ``csrc/window_key_conv.cu`` (replacing the TPU kernel
``detmatch_tpu/ops/pallas/window_key_conv.py:_fwd``) and
``csrc/window_key_conv_bwd.cu`` (replacing ``_bwd_fused`` there), joined
by a ``torch.autograd.Function``, and the plain PyTorch twin
:func:`window_key_conv_plain`, the rulebook gather-GEMM
(``spconv.rulebook_batched`` + ``spconv.gather_conv_batched``).

Each (row, tap) neighbour key is resolved inside its own sample's key
table. On a CPU tensor the wrapper runs the twin, and autograd
differentiates the twin; on a CUDA tensor it launches the forward kernel,
its backward launches the backward kernel, and either raises rather than
fall back. fp32 throughout; kernel and twin differ only in summation
order.
"""
from __future__ import annotations

import math

import torch

from .. import spconv
from . import build

# csrc/window_key_conv.cu and window_key_conv_bwd.cu limits
MAX_TAPS, MAX_CIN, MAX_COUT, MAX_W = 27, 64, 128, 8192
# the backward's dW pass aims at two blocks per SM of the H100's 132
DW_TARGET_BLOCKS = 264


def _check_band(b, band):
    if b * band >= 2 ** 31:
        raise ValueError(f"window_key_conv_batched: B * band = {b * band} "
                         f"must stay below 2^31 (B={b}, band={band})")


def window_key_conv_plain(feats, keys, nkeys, out_keys, weights, band):
    """Plain twin of :func:`window_key_conv_batched` (same arguments)."""
    _check_band(feats.shape[0], band)
    return spconv.gather_conv_batched(
        feats, spconv.rulebook_batched(keys, nkeys), weights)


def _check_args(name, feats, keys, nkeys, weights, band):
    """The kernels' device, type, shape and size limits; returns the
    device and (b, n, m, k, c, co)."""
    b, n, c = feats.shape
    _check_band(b, band)
    dev = build.require_cuda(name, feats, keys, nkeys, weights)
    for t, dtype, what in ((feats, torch.float32, "feats"),
                           (keys, torch.int32, "keys"),
                           (nkeys, torch.int32, "nkeys"),
                           (weights, torch.float32, "weights")):
        build.require_dtype(name, t, dtype, what)
    m, k = nkeys.shape[1], nkeys.shape[2]
    co = weights.shape[-1]
    if (keys.shape != (b, n) or nkeys.shape[0] != b
            or weights.shape != (k, c, co)):
        raise ValueError(f"{name}: shapes do not match feats (B, N, C), "
                         "keys (B, N), nkeys (B, M, K), weights (K, C, Co)")
    if (n == 0 or k > MAX_TAPS or c > MAX_CIN or co > MAX_COUT
            or c * co > MAX_W):
        raise ValueError(f"{name}: needs N > 0, K <= {MAX_TAPS}, "
                         f"C <= {MAX_CIN}, Co <= {MAX_COUT}, "
                         f"C * Co <= {MAX_W}; got N={n} K={k} C={c} "
                         f"Co={co}")
    return dev, (b, n, m, k, c, co)


def _launch_fwd(feats, keys, nkeys, out_keys, weights, band):
    name = "window_key_conv_batched"
    dev, (b, n, m, k, c, co) = _check_args(name, feats, keys, nkeys,
                                           weights, band)
    build.require_cuda(name, feats, out_keys)
    build.require_dtype(name, out_keys, torch.int32, "out_keys")
    if out_keys.shape != (b, m):
        raise ValueError(f"{name}: out_keys must be (B, M) = {(b, m)}")
    out = torch.empty((b, m, co), dtype=torch.float32, device=dev)
    lib = build.load_library()
    err = lib.dm_window_key_conv_fwd(
        build.ptr(feats), build.ptr(keys), build.ptr(nkeys),
        build.ptr(weights), build.ptr(out), b, n, m, k, c, co,
        build.stream(dev))
    window_key_conv_batched.launches += 1
    build.check(lib, err, name)
    return out


def dw_chunking(rows, k):
    """(chunk_rows, n_chunks) of the backward's dW pass over ``rows``
    output rows: about DW_TARGET_BLOCKS blocks over the k taps, chunks of
    256-4,096 rows (a multiple of the kernel's 32-row tile)."""
    per_tap = max(1, math.ceil(DW_TARGET_BLOCKS / k))
    chunk = 32 * math.ceil(max(1, math.ceil(rows / per_tap)) / 32)
    chunk = min(4096, max(256, chunk))
    return chunk, math.ceil(rows / chunk)


def window_key_conv_bwd(dout, feats, keys, nkeys, weights, band,
                        need_dfeats=True):
    """Backward of :func:`window_key_conv_batched` on the card.

    Args:
        dout: (B, M, Co) float32 gradient of the output; the rest as the
            forward. need_dfeats: False skips the input gradient.
    Returns:
        (dfeats (B, N, C) or None, dweights (K, C, Co)), both float32.
    """
    name = "window_key_conv_bwd"
    dev, (b, n, m, k, c, co) = _check_args(name, feats, keys, nkeys,
                                           weights, band)
    build.require_cuda(name, feats, dout)
    build.require_dtype(name, dout, torch.float32, "dout")
    if dout.shape != (b, m, co):
        raise ValueError(f"{name}: dout must be (B, M, Co) = {(b, m, co)}")
    chunk, n_chunks = dw_chunking(b * m, k)
    rb = torch.empty((b, m, k), dtype=torch.int32, device=dev)
    partial = torch.empty((n_chunks, k, c, co), dtype=torch.float32,
                          device=dev)
    dw = torch.empty((k, c, co), dtype=torch.float32, device=dev)
    if need_dfeats:
        inv = torch.full((b, n, k), -1, dtype=torch.int32, device=dev)
        dfeats = torch.empty((b, n, c), dtype=torch.float32, device=dev)
        inv_p, df_p = build.ptr(inv), build.ptr(dfeats)
    else:
        dfeats = None
        inv_p = df_p = build.ptr(None)
    lib = build.load_library()
    err = lib.dm_window_key_conv_bwd(
        build.ptr(feats), build.ptr(keys), build.ptr(nkeys),
        build.ptr(weights), build.ptr(dout), build.ptr(rb), inv_p,
        build.ptr(partial), df_p, build.ptr(dw), b, n, m, k, c, co, chunk,
        n_chunks, build.stream(dev))
    window_key_conv_bwd.launches += 1
    build.check(lib, err, name)
    return dfeats, dw


class _WindowKeyConv(torch.autograd.Function):
    """Forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, feats, keys, nkeys, out_keys, weights, band):
        ctx.save_for_backward(feats, keys, nkeys, weights)
        ctx.band = band
        return _launch_fwd(feats, keys, nkeys, out_keys, weights, band)

    @staticmethod
    def backward(ctx, dout):
        feats, keys, nkeys, weights = ctx.saved_tensors
        dfeats, dw = window_key_conv_bwd(
            dout.contiguous(), feats, keys, nkeys, weights, ctx.band,
            need_dfeats=ctx.needs_input_grad[0])
        return dfeats, None, None, None, dw, None


def window_key_conv_batched(feats, keys, nkeys, out_keys, weights, band):
    """Sparse conv, the JAX ``window_key_conv_batched`` signature, with a
    gradient for ``feats`` and ``weights``.

    Args:
        feats: (B, N, C) float32; keys: (B, N) int32 sorted per sample,
            INVALID_KEY padded; nkeys: (B, M, K) int32 neighbour keys of
            each output row (INVALID_KEY = no tap); out_keys: (B, M) the
            output keys (not needed by the kernels; kept for the JAX
            signature); weights: (K, C, Co) float32; band: per-sample key
            space size, ``B * band`` must stay below 2^31.
    Returns:
        (B, M, Co) float32.
    """
    if feats.device.type == "cpu":
        return window_key_conv_plain(feats, keys, nkeys, out_keys, weights,
                                     band)
    return _WindowKeyConv.apply(feats, keys, nkeys, out_keys, weights, band)


window_key_conv_batched.launches = 0
window_key_conv_bwd.launches = 0
