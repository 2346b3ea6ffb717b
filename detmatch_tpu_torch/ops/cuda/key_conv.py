"""Key-compare sparse 3D conv with bf16 operands and fp32 sums: CUDA
kernels ``csrc/key_conv.cu`` (replacing the TPU kernels
``detmatch_tpu/ops/pallas/onehot_key_conv.py:_key_conv_fwd`` and
``_key_scatter_all_taps``) and their plain PyTorch twins, joined by one
``torch.autograd.Function`` whose backward is JAX's ``_vjp_bwd``.

The function is the JAX ``key_conv_batched``: the forward rounds the
gathered features and the weights to bf16 and sums their products in
fp32; the backward forms S[k, n], the fp32 sum of bf16(dout[m]) over the
output rows m whose tap k reads input row n (from +0, in ascending
b * M + m; zero where none, and one term on every conv, where an input
row and a tap fix at most one output row), and takes
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
(``window_key_conv.tile_rows`` at C and Co up to multiples of 4). When
autograd will want a gradient, the forward kernel also writes the
rulebook it resolved (as K1's does), and the backward kernel builds S
from it with no key search: an inverse map, then one pass that writes
every row of S once, then a pass that adds the later writers of a
repeated slot, which returns at once unless the map flagged one on the
card. The twins' backward resolves the keys again
(:func:`key_scatter_plain`); :func:`key_scatter_from_rulebook_plain` is
the twin of the kernel's own signature.
"""
from __future__ import annotations

import functools

import torch

from .. import spconv
from . import build
from .window_key_conv import (MAX_COUT, MAX_TAPS, _check_args, _check_band,
                              tile_rows, vec4)

# csrc/key_conv.cu kUnclaimed: the inverse map's fill, above any output row
UNCLAIMED = 0x7F7F7F7F


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def key_conv_forward_plain(feats, keys, nkeys, weights):
    """Plain twin of the forward kernel: (B, M, Co) float32."""
    return spconv.gather_conv_batched(
        _bf16(feats), spconv.rulebook_batched(keys, nkeys), _bf16(weights))


def ordered_slot_sum(rows, slot, slots):
    """(slots, C) float32: out[s] is the fp32 sum, from +0, of ``rows[j]``
    over the j with ``slot[j] == s``, in ascending j (zero where none),
    on any device: the j of a slot are taken rank by rank, each rank one
    indexed add with no repeated slot."""
    order = torch.argsort(slot, stable=True)
    slot = slot[order]
    pos = torch.arange(slot.numel(), device=slot.device)
    first = torch.ones_like(slot, dtype=torch.bool)
    first[1:] = slot[1:] != slot[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    out = rows.new_zeros((slots, rows.shape[-1]))
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == r
        out[slot[sel]] += rows[order[sel]]
    return out


def key_scatter_from_rulebook_plain(dout, rb, n):
    """Plain twin of the backward kernel: S (K, B * N, Co) float32 whose
    row k * B * N + b * N + r is the fp32 sum, from +0, of bf16(dout[b, m])
    over the entries rb[b, m, k] == r in [0, N), in ascending b * M + m
    (zero where none), as in the kernel. Keys are unique in a sample, so
    on a conv each row has at most one term; a rulebook that repeats one
    gets JAX's one-hot sum."""
    b, m, k = rb.shape
    dev = rb.device
    ok = (rb >= 0) & (rb < n)
    slot = (torch.arange(k, device=dev) * (b * n)
            + (torch.arange(b, device=dev) * n)[:, None, None] + rb)[ok]
    row = torch.arange(b * m, device=dev).view(b, m, 1).expand(b, m, k)[ok]
    rows = _bf16(dout).reshape(b * m, -1)[row]
    return ordered_slot_sum(rows, slot.long(), k * b * n).view(k, b * n, -1)


def key_scatter_plain(dout, keys, nkeys):
    """Plain twin of the backward from the keys, JAX's
    ``_key_scatter_all_taps``: S (K, B * N, Co) of
    :func:`key_scatter_from_rulebook_plain` on the rulebook of ``nkeys``
    in ``keys``."""
    return key_scatter_from_rulebook_plain(
        dout, spconv.rulebook_batched(keys, nkeys), keys.shape[1])


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
    return (b, n, vec4(c)), (k, vec4(c), vec4(co))


def key_conv_fwd(feats, keys, nkeys, weights, rows=None, rulebook=False):
    """The forward kernel on the card (arguments as
    :func:`key_conv_batched`, without the band), at ``rows`` output rows a
    block (None: the tile rows the wrapper plans; other values for
    measurement).

    Returns:
        (out (B, M, Co) float32, rb (B, M, K) int32 or None): with
        ``rulebook`` the per-sample input row each (output row, tap)
        resolved to, -1 where none, as ``spconv.rulebook_batched`` gives
        it; the backward reads it.
    """
    name = "key_conv_batched"
    dev, (b, n, m, k, c, co) = _check_args(name, feats, keys, nkeys,
                                           weights, 0)
    out = torch.empty((b, m, co), dtype=torch.float32, device=dev)
    rb = (torch.empty((b, m, k), dtype=torch.int32, device=dev)
          if rulebook else None)
    f_shape, w_shape = rounded_shapes(b, n, k, c, co)
    fr = torch.empty(f_shape, dtype=torch.float32, device=dev)
    wr = torch.empty(w_shape, dtype=torch.float32, device=dev)
    lib = build.load_library()
    err = lib.dm_key_conv_fwd(
        build.ptr(feats), build.ptr(keys), build.ptr(nkeys),
        build.ptr(weights), build.ptr(fr), build.ptr(wr), build.ptr(out),
        build.ptr(rb), b, n, m, k, c, co,
        tile_rows(*w_shape) if rows is None else rows, build.stream(dev))
    key_conv_batched.launches += 1
    build.check(lib, err, name)
    return out, rb


def key_conv_bwd(dout, rb, n):
    """The backward kernel on the card: S (K, B * N, Co) float32 from
    dout (B, M, Co) and the rulebook (B, M, K) int32 that
    :func:`key_conv_fwd` wrote, over N input rows a sample."""
    name = "key_conv_bwd"
    dev = build.require_cuda(name, dout, rb)
    build.require_dtype(name, dout, torch.float32, "dout")
    build.require_dtype(name, rb, torch.int32, "rb")
    b, m, k = rb.shape
    co = dout.shape[-1]
    if (dout.shape != (b, m, co) or n <= 0 or k > MAX_TAPS
            or co > MAX_COUT or b * n >= 2 ** 31 or b * m >= UNCLAIMED):
        raise ValueError(f"{name}: needs dout (B, M, Co) with Co <= "
                         f"{MAX_COUT}, rb (B, M, K) with K <= {MAX_TAPS}, "
                         f"N > 0, B * N below 2^31 and B * M below "
                         f"{UNCLAIMED}")
    inv = torch.empty(k * b * n + 1, dtype=torch.int32, device=dev)  # + flag
    s = torch.empty((k, b * n, co), dtype=torch.float32, device=dev)
    lib = build.load_library()
    err = lib.dm_key_conv_bwd_scatter(
        build.ptr(dout), build.ptr(rb), build.ptr(inv), build.ptr(s), b, n,
        m, k, co, build.stream(dev))
    key_conv_bwd.launches += 1
    build.check(lib, err, name)
    return s


def _kernel_forward(feats, keys, nkeys, weights, rulebook):
    out, rb = key_conv_fwd(feats, keys, nkeys, weights, rulebook=rulebook)
    return out, (() if rb is None else (rb,))


def _kernel_scatter(dout, n, rb):
    return key_conv_bwd(dout, rb, n)


def _plain_forward(feats, keys, nkeys, weights):
    return key_conv_forward_plain(feats, keys, nkeys, weights), (keys, nkeys)


def _plain_scatter(dout, n, keys, nkeys):
    return key_scatter_plain(dout, keys, nkeys)


class KeyConv(torch.autograd.Function):
    """``forward`` computes the output and the tensors that ``scatter``
    reads besides dout for S in the backward: the kernels (the rulebook
    the forward kernel wrote) or their twins (the keys)."""

    @staticmethod
    def forward(ctx, feats, keys, nkeys, weights, forward, scatter):
        out, index = forward(feats, keys, nkeys, weights)
        ctx.save_for_backward(feats, weights, *index)
        ctx.scatter = scatter
        return out

    @staticmethod
    def backward(ctx, dout):
        feats, weights, *index = ctx.saved_tensors
        s = ctx.scatter(dout.contiguous(), feats.shape[1], *index)
        dfeats, dw = key_conv_grads(s, feats, weights, ctx.needs_input_grad[0])
        return dfeats, None, None, dw, None, None


def key_conv_plain(feats, keys, nkeys, weights, band):
    """Plain twin of :func:`key_conv_batched` (same arguments)."""
    _check_band(feats.shape[0], band)
    return KeyConv.apply(feats, keys, nkeys, weights, _plain_forward,
                         _plain_scatter)


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
    grad = torch.is_grad_enabled() and (feats.requires_grad
                                        or weights.requires_grad)
    return KeyConv.apply(feats, keys, nkeys, weights,
                         functools.partial(_kernel_forward, rulebook=grad),
                         _kernel_scatter)


key_conv_batched.launches = 0
key_conv_bwd.launches = 0
