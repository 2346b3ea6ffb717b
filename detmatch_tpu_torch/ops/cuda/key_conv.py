"""Key-compare sparse 3D conv with bf16 operands and fp32 sums: CUDA
kernels ``csrc/key_conv.cu`` (replacing the TPU kernels
``detmatch_tpu/ops/pallas/onehot_key_conv.py:_key_conv_fwd`` and
``_key_scatter_all_taps``) and their plain PyTorch twins, joined by one
``torch.autograd.Function`` whose backward is JAX's ``_vjp_bwd``.

The function is the JAX ``key_conv_batched``: the forward rounds the
gathered features and the weights to bf16 and sums their products in
fp32; the backward forms S[k, n] = bf16(dout[m]) at the one output row m
whose tap k reads input row n (zero elsewhere), and takes
dF = sum_k S_k W_k^T and dW_k = F^T S_k in fp32 from the unrounded F and
W, outside the kernel as JAX does. Autograd through the rounded forward
would give dW = bf16(F)^T dout instead, a different function.

On a CPU tensor the wrapper runs the twins; on a CUDA tensor it launches
the kernels or raises, with no fallback. ``key_conv_plain`` runs the
twins on any device (for verification). The forward kernel is K1's
gather-GEMM tile on operands that a prologue rounds to bf16: it sums
the exact products in the twin's fp32 order, so it equals the twin on
the card; the wrapper allocates the rounded operands' scratch
(:func:`rounded_shapes`) and picks the tile rows
(``window_key_conv.tile_rows`` at C and Co up to multiples of 4).
"""
from __future__ import annotations

import torch

from .. import spconv
from . import build
from .window_key_conv import _check_args, _check_band, tile_rows


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def key_conv_forward_plain(feats, keys, nkeys, weights):
    """Plain twin of the forward kernel: (B, M, Co) float32."""
    return spconv.gather_conv_batched(
        _bf16(feats), spconv.rulebook_batched(keys, nkeys), _bf16(weights))


def key_scatter_plain(dout, keys, nkeys):
    """Plain twin of the backward kernel: S (K, B * N, Co) float32 with
    bf16(dout[b, m]) at (k, b * N + row(b, m, k)). Each slot has at most
    one writer (keys are unique in a sample), so a plain indexed store
    gives the JAX one-hot sum."""
    b, n = keys.shape
    k = nkeys.shape[2]
    rb = spconv.rulebook_batched(keys, nkeys)
    bi, mi, ki = (rb >= 0).nonzero(as_tuple=True)
    s = dout.new_zeros((k, b * n, dout.shape[-1]))
    s[ki, bi * n + rb[bi, mi, ki].long()] = _bf16(dout[bi, mi])
    return s


def key_conv_grads(s, feats, weights, need_dfeats=True):
    """JAX ``_vjp_bwd`` after the scatter: (dfeats (B, N, C) or None,
    dweights (K, C, Co)), fp32, from the unrounded feats and weights."""
    b, n, c = feats.shape
    dw = torch.einsum("nc,kno->kco", feats.reshape(b * n, c), s)
    dfeats = (torch.einsum("kno,kco->nc", s, weights).reshape(b, n, c)
              if need_dfeats else None)
    return dfeats, dw


def rounded_shapes(b, n, k, c, co):
    """The forward's float32 scratch of bf16-rounded features and weights
    (csrc/key_conv.cu): C and Co up to multiples of 4, zeros in the pads
    (the tile copies 16-byte vectors)."""
    c4, co4 = -(-c // 4) * 4, -(-co // 4) * 4
    return (b, n, c4), (k, c4, co4)


def _launch_fwd(feats, keys, nkeys, weights, rows=None):
    name = "key_conv_batched"
    dev, (b, n, m, k, c, co) = _check_args(name, feats, keys, nkeys,
                                           weights, 0)
    out = torch.empty((b, m, co), dtype=torch.float32, device=dev)
    f_shape, w_shape = rounded_shapes(b, n, k, c, co)
    fr = torch.empty(f_shape, dtype=torch.float32, device=dev)
    wr = torch.empty(w_shape, dtype=torch.float32, device=dev)
    lib = build.load_library()
    err = lib.dm_key_conv_fwd(
        build.ptr(feats), build.ptr(keys), build.ptr(nkeys),
        build.ptr(weights), build.ptr(fr), build.ptr(wr), build.ptr(out), b,
        n, m, k, c, co, tile_rows(*w_shape) if rows is None else rows,
        build.stream(dev))
    key_conv_batched.launches += 1
    build.check(lib, err, name)
    return out


def key_conv_fwd(feats, keys, nkeys, weights, rows):
    """The forward kernel on the card at ``rows`` output rows a block
    (for measurement; the model's calls take ``tile_rows``)."""
    return _launch_fwd(feats, keys, nkeys, weights, rows)


def key_conv_bwd(dout, keys, nkeys):
    """The backward kernel on the card: S (K, B * N, Co) float32 from
    dout (B, M, Co) (Co a multiple of 4)."""
    name = "key_conv_bwd"
    dev = build.require_cuda(name, dout, keys, nkeys)
    build.require_dtype(name, dout, torch.float32, "dout")
    build.require_dtype(name, keys, torch.int32, "keys")
    build.require_dtype(name, nkeys, torch.int32, "nkeys")
    b, n = keys.shape
    m, k = nkeys.shape[1], nkeys.shape[2]
    co = dout.shape[-1]
    if nkeys.shape[0] != b or dout.shape != (b, m, co) or co % 4:
        raise ValueError(f"{name}: needs dout (B, M, Co) with Co % 4 == 0, "
                         "keys (B, N), nkeys (B, M, K)")
    s = torch.empty((k, b * n, co), dtype=torch.float32, device=dev)
    lib = build.load_library()
    err = lib.dm_key_conv_bwd_scatter(
        build.ptr(dout), build.ptr(keys), build.ptr(nkeys), build.ptr(s), b,
        n, m, k, co, build.stream(dev))
    key_conv_bwd.launches += 1
    build.check(lib, err, name)
    return s


class KeyConv(torch.autograd.Function):
    """``forward`` computes the output, ``scatter`` S in the backward:
    the kernels or their twins."""

    @staticmethod
    def forward(ctx, feats, keys, nkeys, weights, forward, scatter):
        ctx.save_for_backward(feats, keys, nkeys, weights)
        ctx.scatter = scatter
        return forward(feats, keys, nkeys, weights)

    @staticmethod
    def backward(ctx, dout):
        feats, keys, nkeys, weights = ctx.saved_tensors
        s = ctx.scatter(dout.contiguous(), keys, nkeys)
        dfeats, dw = key_conv_grads(s, feats, weights, ctx.needs_input_grad[0])
        return dfeats, None, None, dw, None, None


def key_conv_plain(feats, keys, nkeys, weights, band):
    """Plain twin of :func:`key_conv_batched` (same arguments)."""
    _check_band(feats.shape[0], band)
    return KeyConv.apply(feats, keys, nkeys, weights, key_conv_forward_plain,
                         key_scatter_plain)


def key_conv_batched(feats, keys, nkeys, weights, band):
    """Sparse conv, the JAX ``key_conv_batched`` signature, with a gradient
    for ``feats`` and ``weights``.

    Args:
        feats: (B, N, C) float32; keys: (B, N) int32 sorted per sample,
            INVALID_KEY padded; nkeys: (B, M, K) int32 neighbour keys of
            each output row (INVALID_KEY = no tap); weights: (K, C, Co)
            float32; band: per-sample key space size. JAX flattens the
            samples into bands of this size and requires ``B * band`` below
            2^31; so does this function, though it searches each sample
            in its own table.
    Returns:
        (B, M, Co) float32.
    """
    if feats.device.type == "cpu":
        return key_conv_plain(feats, keys, nkeys, weights, band)
    _check_band(feats.shape[0], band)
    return KeyConv.apply(feats, keys, nkeys, weights, _launch_fwd,
                         key_conv_bwd)


key_conv_batched.launches = 0
key_conv_bwd.launches = 0
