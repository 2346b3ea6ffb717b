"""Rulebook sparse conv with bf16 operands and fp32 sums (K6): the CUDA
kernels ``csrc/onehot_gather_conv.cu`` (``dm_onehot_gather_conv_fwd``, bf16
tensor cores on the matched pairs; replacing the TPU kernel
``detmatch_tpu/ops/pallas/onehot_gather.py:_onehot_gather_conv_fwd``)
and ``csrc/onehot_gather.cu`` with ``csrc/segment_sum.cu`` (replacing
``_scatter_all_taps`` there), their plain PyTorch twins, and one
``torch.autograd.Function`` whose backward is JAX's ``_vjp_bwd``, with
JAX's signatures ``onehot_gather_conv(feats, rulebook, weights)`` and
``onehot_gather_conv_batched``.

The function is JAX's: the forward sums bf16(F[rb[m, k]]) . bf16(W_k) in
fp32 over the taps with an input row (``rb`` in [0, N); the one-hot
matmul gives exactly that row, so both gather by index here); the
backward forms S[k, n] = sum_m 1[rb[m, k] == n] * bf16(dout[m]) in fp32
and takes dF = sum_k S_k W_k^T and dW_k = F^T S_k as fp32 matmuls of the
unrounded F and W outside the kernel, as JAX does. Like JAX's, no model
calls it.

S has two paths with one result (:func:`onehot_gather_scatter`): a
direct store where each (tap, row) slot has at most one writer, as in
every spconv rulebook, and otherwise K8's chunked segment sum in its
stated order (``onehot_rows.segment_sum``; within a slot ascending m,
chunks of ``onehot_rows.CHUNK`` pairs summed from 0, then the chunk sums
in order), deterministic for any rulebook. The twin follows that order.

On a CPU tensor the wrappers run the twins; on a CUDA tensor they launch
the kernels or raise, with no fallback.
"""
from __future__ import annotations

import torch

from .. import spconv
from . import build, gather_conv
from .key_conv import _bf16, key_conv_grads
from .onehot_rows import segment_sum, segment_sum_plain, slot_keys


def onehot_gather_forward_plain(feats, rulebook, weights):
    """Plain twin of the forward kernel: (M, Co) float32 from feats
    (N, C), rulebook (M, K) and weights (K, C, Co)."""
    rb = torch.where(rulebook < feats.shape[0], rulebook, -1)
    return spconv.gather_conv_batched(_bf16(feats)[None], rb[None],
                                      _bf16(weights))[0]


def _tap_slots(rulebook, n_total):
    """Slot k * N + rb[m, k] of each pair p = m * K + k, K * N where the
    entry is outside [0, N): (M * K,) int32."""
    k = rulebook.shape[1]
    taps = torch.arange(k, dtype=torch.int32, device=rulebook.device)
    ok = (rulebook >= 0) & (rulebook < n_total)
    return torch.where(ok, taps * n_total + rulebook, k * n_total).to(
        torch.int32).reshape(-1)


def onehot_gather_scatter_plain(dout, rulebook, n_total):
    """Plain twin of the backward kernel: S (K, N, Co) float32."""
    m, k = rulebook.shape
    co = dout.shape[-1]
    rows = _bf16(dout)[:, None].expand(m, k, co).reshape(m * k, co)
    return segment_sum_plain(rows, _tap_slots(rulebook, n_total),
                             k * n_total).reshape(k, n_total, co)


def mma_shapes(n, k, c, co):
    """The forward's bf16 scratch (csrc/onehot_gather_conv.cu): the rounded
    features (N, C16) and the rounded, transposed weights (K, Co8, C16),
    C up to a multiple of 16 (the mma's k-step) and Co up to one of 8."""
    c16, co8 = -(-c // 16) * 16, -(-co // 8) * 8
    return (n, c16), (k, co8, c16)


def _launch_fwd(feats, rulebook, weights):
    """The forward kernel on the card: (M, Co) float32 from feats (N, C),
    rulebook (M, K) int32 (-1 and any other entry outside [0, N) = none)
    and weights (K, C, Co)."""
    name = "onehot_gather_conv"
    dev, (_, n, m, k, c, co) = gather_conv.check_args(
        name, feats[None], rulebook[None], weights)
    f_shape, w_shape = mma_shapes(n, k, c, co)
    if n * f_shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: needs N * C16 below 2^31")
    fb = torch.empty(f_shape, dtype=torch.bfloat16, device=dev)
    wt = torch.empty(w_shape, dtype=torch.bfloat16, device=dev)
    out = torch.empty((m, co), dtype=torch.float32, device=dev)
    lib = build.load_library()
    err = lib.dm_onehot_gather_conv_fwd(
        build.ptr(feats), build.ptr(rulebook), build.ptr(weights),
        build.ptr(fb), build.ptr(wt), build.ptr(out), n, m, k, c, co,
        build.stream(dev))
    onehot_gather_conv.launches += 1
    build.check(lib, err, name)
    return out


def onehot_gather_scatter(dout, rulebook, n_total):
    """The backward kernels on the card: S (K, N, Co) float32 from dout
    (M, Co) float32 and the rulebook (M, K) int32.

    A claim kernel maps each (tap, row) slot to its writer and flags a
    slot with two; a fill kernel, queued behind it, stores
    bf16(dout[writer]) a slot. Reading the flag then costs one host
    synchronisation per call. Without repeats that S is the result
    (counted in ``.direct``); with them, the chunked segment sum of the
    sorted pairs writes every element of S again (``.sorted``).
    ``.launches`` counts both."""
    name = "onehot_gather_scatter"
    dev = build.require_cuda(name, dout, rulebook)
    build.require_dtype(name, dout, torch.float32, "dout")
    build.require_dtype(name, rulebook, torch.int32, "rulebook")
    m, k = rulebook.shape
    co = dout.shape[-1]
    slots = k * n_total
    if (dout.shape != (m, co) or not 0 < co <= (1024 if co % 4 == 0
                                                  else 256)
            or slots * co >= 2 ** 31 or m * k >= 2 ** 30):
        raise ValueError(f"{name}: needs dout (M, Co) with Co in [1, 256] "
                         "(up to 1024 if 4 divides it), rulebook (M, K), "
                         "K * N * Co below 2^31 and M * K below 2^30")
    lib = build.load_library()
    inv = torch.empty(slots + 1, dtype=torch.int32, device=dev)  # + flag
    s = torch.empty((k, n_total, co), dtype=torch.float32, device=dev)
    build.check(lib, lib.dm_onehot_gather_direct(
        build.ptr(rulebook), build.ptr(dout), build.ptr(inv), build.ptr(s),
        m, k, n_total, co, build.stream(dev)), name)
    if inv[slots].item() < 0:
        onehot_gather_scatter.direct += 1
    else:
        keys = slot_keys(name, rulebook, 1, k, n_total)
        segment_sum(name, dout, keys, k, slots, s)
        onehot_gather_scatter.sorted += 1
    onehot_gather_scatter.launches += 1
    return s


class OnehotGatherConv(torch.autograd.Function):
    """``forward`` computes the output, ``scatter`` S in the backward:
    the kernels or their twins."""

    @staticmethod
    def forward(ctx, feats, rulebook, weights, forward, scatter):
        ctx.save_for_backward(feats, rulebook, weights)
        ctx.scatter = scatter
        return forward(feats, rulebook, weights)

    @staticmethod
    def backward(ctx, dout):
        feats, rulebook, weights = ctx.saved_tensors
        s = ctx.scatter(dout.contiguous(), rulebook, feats.shape[0])
        # JAX's _vjp_bwd, as K5's: the same S-based fp32 matmuls
        dfeats, dw = key_conv_grads(s, feats[None], weights,
                                    ctx.needs_input_grad[0])
        return (None if dfeats is None else dfeats[0]), None, dw, None, None


def onehot_gather_conv_plain(feats, rulebook, weights):
    """Plain twin of :func:`onehot_gather_conv` (same arguments)."""
    return OnehotGatherConv.apply(feats, rulebook, weights,
                                  onehot_gather_forward_plain,
                                  onehot_gather_scatter_plain)


def onehot_gather_conv(feats, rulebook, weights):
    """Single-sample sparse conv core: feats (N, C) float32, rulebook
    (M, K) int32 (-1 = none), weights (K, C, Co) float32 → (M, Co) float32,
    bf16 operands and fp32 sums; differentiable in feats and weights."""
    if feats.device.type == "cpu":
        return onehot_gather_conv_plain(feats, rulebook, weights)
    return OnehotGatherConv.apply(feats, rulebook, weights, _launch_fwd,
                                  onehot_gather_scatter)


def onehot_gather_conv_batched(feats, rulebook, weights):
    """(B, N, C) x (B, M, K) x (K, C, Co) → (B, M, Co): the samples
    stacked in the row dimension with per-sample offsets, as JAX does, and
    one :func:`onehot_gather_conv`."""
    b, n, c = feats.shape
    m, k = rulebook.shape[1], rulebook.shape[2]
    base = (torch.arange(b, dtype=torch.int32, device=feats.device)
            * n)[:, None, None]
    rb = torch.where(rulebook >= 0, rulebook + base, -1).reshape(b * m, k)
    out = onehot_gather_conv(feats.reshape(b * n, c), rb, weights)
    return out.reshape(b, m, -1)


onehot_gather_conv.launches = 0
onehot_gather_scatter.launches = 0
onehot_gather_scatter.direct = 0   # calls that took the direct store
onehot_gather_scatter.sorted = 0   # calls that took the segment sum
