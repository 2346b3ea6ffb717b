"""Row gather with bf16-rounded values and its scatter-add transpose (K8):
CUDA kernels ``csrc/onehot_rows.cu`` (the gather) and
``csrc/segment_sum.cu`` (the scatter), replacing the TPU kernels of
``detmatch_tpu/ops/pallas/onehot_rows.py``: ``_gather_fwd``,
``_scatter_add`` and their batched forms; their plain PyTorch twins,
joined by one ``torch.autograd.Function``, with JAX's signatures
``onehot_take_rows(x, idx)`` and ``onehot_take_rows_batched(x, idx)``.

The function is JAX's: the forward is ``bf16(x)[idx]`` as float32, zero
where ``idx`` lies outside [0, N); the backward is
``dx[n] = sum_q 1[idx[q] == n] * bf16(dout[q])`` in float32, dropping
out-of-range indices. JAX runs both as one-hot matmuls because TPU row
gathers are slow; here the gather reads by index (16-byte vectors a lane
where C and the data allow) and the scatter is the
chunked segment sum that K6's backward shares (:func:`segment_sum`), with
no float atomics, in one stated order: within a slot the pairs keep
ascending q and are cut into consecutive chunks of at most :data:`CHUNK`;
each chunk is summed in fp32 from 0, then the chunk sums in chunk order
from 0. A slot of at most ``CHUNK`` pairs is one sequential sum. The twin
(:func:`segment_sum_plain`) follows the same order. Like JAX's, no model
calls it: ``pointnet.gather_rows`` stays the models' row gather.

On a CPU tensor the wrappers run the twins; on a CUDA tensor they launch
the kernels or raise, with no fallback.
"""
from __future__ import annotations

import torch

from . import build
from .key_conv import _bf16

# pairs per chunk of the segment sum, read by the kernels and the twins
CHUNK = 256


def segment_sum_plain(rows, keys, slots):
    """Plain twin of the segment sum: out (slots, C) float32, out[s] the
    sum of ``rows[j]`` (already rounded) over the pairs j whose int
    ``keys[j]`` is s (``slots`` or more: dropped), in the order the kernel
    sums: chunks of at most :data:`CHUNK` pairs in ascending j, each summed
    from 0, then the chunk sums in chunk order (``index_add_`` adds in
    index order on the CPU)."""
    keys = keys.long()
    sorted_keys, order = torch.sort(keys, stable=True)
    kept = sorted_keys < slots
    sorted_keys, order = sorted_keys[kept], order[kept]
    counts = torch.bincount(sorted_keys, minlength=slots)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(sorted_keys.numel(), device=keys.device) - starts[
        sorted_keys]
    chunks = (counts + CHUNK - 1) // CHUNK
    first = torch.cumsum(chunks, 0) - chunks
    partials = rows.new_zeros((int(chunks.sum()), rows.shape[1]))
    partials.index_add_(0, first[sorted_keys] + rank // CHUNK, rows[order])
    out = rows.new_zeros((slots, rows.shape[1]))
    out.index_add_(0, torch.repeat_interleave(
        torch.arange(slots, device=keys.device), chunks), partials)
    return out


def segment_sum(name, rows, keys, div, slots, out):
    """The segment-sum kernels (``csrc/segment_sum.cu``) on the card:
    ``out`` (slots, C) float32 gets, for each slot, the sum of
    bf16(``rows[j // div]``) over the pairs j whose int32 ``keys[j]`` is
    that slot, in :func:`segment_sum_plain`'s order. The pairs are sorted
    stably by slot with ``torch.sort``; the offsets, chunk sums and chunk
    tails are one call, with no host synchronisation."""
    pairs, cols = keys.numel(), rows.shape[-1]
    rows_partial = 2 * (pairs // CHUNK) + 2
    if (pairs >= 2 ** 30 or max(rows.numel(), out.numel(),
                                rows_partial * cols) >= 2 ** 31):
        raise ValueError(f"{name}: needs fewer than 2^30 pairs and fewer "
                         "than 2^31 elements in the rows and the output")
    sorted_keys, order = torch.sort(keys, stable=True)
    offsets = torch.empty(slots + 1, dtype=torch.int32, device=keys.device)
    partials = torch.empty((rows_partial, cols), dtype=torch.float32,
                           device=keys.device)
    lib = build.load_library()
    err = lib.dm_segment_sum_bf16(
        build.ptr(rows), build.ptr(sorted_keys), build.ptr(order),
        build.ptr(offsets), build.ptr(partials), build.ptr(out), pairs, div,
        cols, slots, CHUNK, build.stream(keys.device))
    build.check(lib, err, name)


def slot_keys(name, x, per_group, groups, n):
    """The slot-key kernel on the card: (x.numel(),) int32 keys
    ``g * n + x[e]`` with ``g = (e // per_group) % groups`` where x[e] is
    in [0, n), ``groups * n`` elsewhere."""
    keys = torch.empty(x.numel(), dtype=torch.int32, device=x.device)
    lib = build.load_library()
    err = lib.dm_slot_keys(build.ptr(x), build.ptr(keys), x.numel(),
                           per_group, groups, n, build.stream(x.device))
    build.check(lib, err, name)
    return keys


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
    return segment_sum_plain(_bf16(dout).reshape(-1, c), _slots(idx, n),
                             b * n).reshape(b, n, c)


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
    if n == 0 or n * c >= 2 ** 31 or q * c >= 2 ** 31 or b > 65535:
        raise ValueError(f"{name}: needs N > 0, N * C and Q * C below "
                         "2^31 and B at most 65,535")
    out = torch.empty((b, q, c), dtype=torch.float32, device=dev)
    lib = build.load_library()
    err = lib.dm_onehot_take_rows(build.ptr(x), build.ptr(idx),
                                  build.ptr(out), b, n, q, c,
                                  build.stream(dev))
    onehot_take_rows_batched.launches += 1
    build.check(lib, err, name)
    return out


def onehot_scatter_rows(dout, idx, n):
    """The scatter kernels on the card: dx (B, N, C) float32 from dout
    (B, Q, C) float32 and idx (B, Q) int32; the slot keys, their stable
    sort and the chunked segment sum."""
    name = "onehot_scatter_rows"
    dev = _check(name, dout, idx)
    b, q, c = dout.shape
    if idx.shape[1] != q or b * n >= 2 ** 31 - 1 or b * q >= 2 ** 30:
        raise ValueError(f"{name}: idx must be (B, Q) = {(b, q)}, B * N "
                         f"below 2^31 - 1 and B * Q below 2^30")
    keys = slot_keys(name, idx, q, b, n)
    dx = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    segment_sum(name, dout, keys, 1, b * n, dx)
    onehot_scatter_rows.launches += 1
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
