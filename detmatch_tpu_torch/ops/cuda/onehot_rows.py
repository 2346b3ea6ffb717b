"""Row gather with bf16-rounded values and its scatter-add transpose (K8):
CUDA kernels ``csrc/onehot_rows.cu`` (replacing the TPU kernels of
``detmatch_tpu/ops/pallas/onehot_rows.py``: ``_gather_fwd``,
``_scatter_add`` and their batched forms) and their plain PyTorch twins,
joined by one ``torch.autograd.Function``, with JAX's signatures
``onehot_take_rows(x, idx)`` and ``onehot_take_rows_batched(x, idx)``.

The function is JAX's: the forward is ``bf16(x)[idx]`` as float32, zero
where ``idx`` lies outside [0, N); the backward is
``dx[n] = sum_q 1[idx[q] == n] * bf16(dout[q])`` in float32, dropping
out-of-range indices. JAX runs both as one-hot matmuls because TPU row
gathers are slow; here the gather reads by index and the scatter sums
each row's contributions in a fixed order (:func:`segments`), with no
float atomics. Like JAX's, no model calls it: ``pointnet.gather_rows``
stays the models' row gather.

On a CPU tensor the wrappers run the twins (an index gather and
``index_add_`` of the rounded values); on a CUDA tensor they launch the
kernels or raise, with no fallback.
"""
from __future__ import annotations

import torch

from . import build
from .key_conv import _bf16


def segments(keys, slots):
    """Order of the pairs sorted stably by their slot ``keys`` (int32,
    ``slots`` or more = dropped), and each slot's [start, end) in that
    order: (order (P,) int32, offsets (slots + 1,) int32)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    bounds = torch.arange(slots + 1, dtype=keys.dtype, device=keys.device)
    offsets = torch.searchsorted(sorted_keys, bounds, out_int32=True)
    return order.to(torch.int32), offsets


def _slots(idx, n):
    """Flat slot b * N + idx of each (b, q), B * N where idx is out of
    range: (B * Q,) int32."""
    b = idx.shape[0]
    base = (torch.arange(b, dtype=torch.int32, device=idx.device) * n)[:, None]
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, idx + base, b * n).to(torch.int32).reshape(-1)


def take_rows_plain(x, idx):
    """Plain twin of the gather kernel: (B, Q, C) float32."""
    n = x.shape[1]
    ok = (idx >= 0) & (idx < n)
    safe = torch.where(ok, idx, 0).long()
    rows = torch.gather(_bf16(x), 1, safe[..., None].expand(-1, -1,
                                                            x.shape[-1]))
    return torch.where(ok[..., None], rows, 0.0)


def scatter_rows_plain(dout, idx, n):
    """Plain twin of the scatter kernel: dx (B, N, C) float32."""
    b, _, c = dout.shape
    dx = dout.new_zeros((b * n + 1, c))
    dx.index_add_(0, _slots(idx, n).long(), _bf16(dout).reshape(-1, c))
    return dx[:-1].reshape(b, n, c)


def _check(name, x, idx):
    dev = build.require_cuda(name, x, idx)
    build.require_dtype(name, x, torch.float32, "values")
    build.require_dtype(name, idx, torch.int32, "idx")
    if (x.dim() != 3 or idx.dim() != 2 or x.shape[0] != idx.shape[0]
            or x.shape[2] == 0):
        raise ValueError(f"{name}: needs (B, ., C) values with C > 0 and "
                         f"(B, Q) idx, got {tuple(x.shape)} and "
                         f"{tuple(idx.shape)}")
    return dev


def _launch_take(x, idx):
    name = "onehot_take_rows_batched"
    dev = _check(name, x, idx)
    b, n, c = x.shape
    q = idx.shape[1]
    if n == 0:
        raise ValueError(f"{name}: needs N > 0")
    out = torch.empty((b, q, c), dtype=torch.float32, device=dev)
    lib = build.load_library()
    err = lib.dm_onehot_take_rows(build.ptr(x), build.ptr(idx),
                                  build.ptr(out), b, n, q, c,
                                  build.stream(dev))
    onehot_take_rows_batched.launches += 1
    build.check(lib, err, name)
    return out


def onehot_scatter_rows(dout, idx, n):
    """The scatter kernel on the card: dx (B, N, C) float32 from dout
    (B, Q, C) float32 and idx (B, Q) int32."""
    name = "onehot_scatter_rows"
    dev = _check(name, dout, idx)
    b, q, c = dout.shape
    if idx.shape[1] != q or b * n >= 2 ** 31 - 1:
        raise ValueError(f"{name}: idx must be (B, Q) = {(b, q)} and "
                         f"B * N below 2^31 - 1")
    order, offsets = segments(_slots(idx, n), b * n)
    dx = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    lib = build.load_library()
    err = lib.dm_onehot_scatter_rows(build.ptr(dout), build.ptr(order),
                                     build.ptr(offsets), build.ptr(dx),
                                     b * n, c, build.stream(dev))
    onehot_scatter_rows.launches += 1
    build.check(lib, err, name)
    return dx


class TakeRows(torch.autograd.Function):
    """``take`` gathers, ``scatter`` computes the gradient of ``x``: the
    kernels or their twins."""

    @staticmethod
    def forward(ctx, x, idx, take, scatter):
        ctx.save_for_backward(idx)
        ctx.n, ctx.scatter = x.shape[1], scatter
        return take(x, idx)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        return ctx.scatter(dout.contiguous(), idx, ctx.n), None, None, None


def onehot_take_rows_plain(x, idx):
    """Plain twin of :func:`onehot_take_rows_batched` (same arguments)."""
    return TakeRows.apply(x, idx, take_rows_plain, scatter_rows_plain)


def onehot_take_rows_batched(x, idx):
    """x (B, N, C) float32, idx (B, Q) int32 → (B, Q, C) float32 rows of
    bf16(x), zero where idx is outside [0, N); differentiable in x."""
    if x.device.type == "cpu":
        return onehot_take_rows_plain(x, idx)
    return TakeRows.apply(x, idx, _launch_take, onehot_scatter_rows)


def onehot_take_rows(x, idx):
    """x (N, C) float32, idx (Q,) int32 → (Q, C): the batched form with
    B = 1."""
    return onehot_take_rows_batched(x[None], idx[None])[0]


onehot_take_rows_batched.launches = 0
onehot_scatter_rows.launches = 0
