"""Sparse 3D conv over sorted voxel keys, forward and backward (K1): CUDA
kernels ``csrc/window_key_conv.cu`` (replacing the TPU kernel
``detmatch_tpu/ops/pallas/window_key_conv.py:_fwd``) and
``csrc/window_key_conv_bwd.cu`` (replacing ``_bwd_fused`` there), both on
the gather-GEMM tile of ``csrc/gather_gemm.cuh``, joined by a
``torch.autograd.Function``, and the plain PyTorch twin
:func:`window_key_conv_plain`, the rulebook gather-GEMM
(``spconv.rulebook_batched`` + ``spconv.gather_conv_batched``).

Each (row, tap) neighbour key is resolved inside its own sample's key
table, by the forward kernel only: when autograd will want a gradient,
the forward also writes the resolved rulebook (B, M, K), and the
backward reads it instead of searching again. On a CPU tensor the
wrapper runs the twin, and autograd differentiates the twin; on a CUDA
tensor it launches the forward kernel, its backward launches the
backward kernel, and either raises rather than fall back. fp32
throughout. The forward sums in K7's order (``csrc/gather_conv.cu``) and
is bit-equal to it; kernel and twin differ only in summation order.
Where several output rows of one tap read the same input row (no conv
does; the public op's neighbour keys may repeat), dF sums every writer,
as JAX's does: the backward kernel flags such a slot on the card and a
pass that is always launched, and returns at once without the flag,
recomputes those rows.

Any C and Co up to ``MAX_CIN`` and ``MAX_COUT`` (C * Co up to
``MAX_W``): the tiles copy 16-byte vectors, so where C or Co is not a
multiple of 4, or the data do not start on 16 bytes (:func:`needs_pad`),
the wrappers allocate zero-padded scratch that a prologue fills, and the
kernels store C or Co of the padded columns.

Host-side plan: :func:`tile_rows` picks the rows of a block for a
(K, Cx, Cy) tile, :func:`bwd_workspace` and :func:`dw_chunks` size the
backward's scratch (``PAIR_CHUNK`` matched pairs per dW partial).
"""
from __future__ import annotations

import math

import torch

from .. import spconv
from . import build

# csrc/window_key_conv_bwd.cu limits (the forward's tile takes them too)
MAX_TAPS, MAX_CIN, MAX_COUT, MAX_W = 27, 128, 128, 16384
# matched pairs per dW partial (csrc/window_key_conv_bwd.cu kPairChunk)
PAIR_CHUNK = 2048
# rows of a counting chunk in the backward (its kThreads)
COUNT_ROWS = 256
# csrc/gather_gemm.cuh: a block's dynamic shared memory at most (227 KB),
# and an SM's shared memory for its blocks (228 KB, 1 KB reserved each)
MAX_SMEM = 232448
SM_SMEM = 233472
TILE_ROWS = (128, 64, 32)


def tile_smem_bytes(rows, k, cx, cy):
    """Shared memory of one gather-GEMM block (csrc/gather_gemm.cuh):
    (rows, cy) accumulators, two stages of rows x cx gathered rows and a
    cx x cy weight tap, the (rows, k) sources, two 32-int tables and the
    per-tap row lists (k * rows bytes, padded to 16)."""
    floats = rows * cy + 2 * (rows * cx + cx * cy)
    ints = rows * k + 2 * 32
    return 4 * floats + 4 * ints + (k * rows + 15) // 16 * 16


def tile_rows(k, cx, cy):
    """Rows of a gather-GEMM block for W_k of cx x cy: 128 where three
    such blocks (24 warps) share an SM, else the largest of 64 and 32
    whose tile fits 227 KB. Timed on an H100 at the 12 backbone convs'
    B=8 shapes (``tools/port_probes/k1_tiles.py``), this is the fastest
    of 32, 64 and 128 rows for each, but for the 3-tap conv, where it is
    0.011 ms slower than the fastest."""
    if 3 * (tile_smem_bytes(128, k, cx, cy) + 1024) <= SM_SMEM:
        return 128
    for rows in TILE_ROWS[1:]:
        if tile_smem_bytes(rows, k, cx, cy) <= MAX_SMEM:
            return rows
    raise ValueError(f"no gather-GEMM tile fits K={k} Cx={cx} Cy={cy}")


def vec4(x):
    """x up to a multiple of 4: the tiles' widths for x channels."""
    return -(-x // 4) * 4


def needs_pad(x, weights):
    """Whether the kernels copy ``x`` (rows of C floats) and ``weights``
    (rows of Co floats) into zero-padded scratch first: the tiles read
    16-byte vectors of rows."""
    c, co = x.shape[-1], weights.shape[-1]
    return bool(c % 4 or co % 4 or x.data_ptr() % 16
                or weights.data_ptr() % 16)


def dw_chunks(rows):
    """dW partials per tap for ``rows`` output rows: a tap has at most one
    pair per row, in chunks of PAIR_CHUNK pairs."""
    return max(1, math.ceil(rows / PAIR_CHUNK))


def bwd_workspace(b, n, m, k, need_dfeats):
    """int32 entries of the backward's workspace: per-chunk pair counts
    and offsets (K x ceil(B * M / 256) each), 32 tap starts, the pair
    lists (B * M * K) and, for dF, the inverse map (B * N * K), the
    repeat flag (1) and the repeat pass's row marks (B * N)."""
    n_rc = math.ceil(b * m / COUNT_ROWS)
    return (2 * k * n_rc + 32 + b * m * k
            + (b * n * (k + 1) + 1 if need_dfeats else 0))


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


def window_key_conv_fwd(feats, keys, nkeys, out_keys, weights, band,
                        rulebook=False):
    """The forward kernel on the card (arguments as
    :func:`window_key_conv_batched`).

    Returns:
        (out (B, M, Co) float32, rb (B, M, K) int32 or None): with
        ``rulebook`` the resolved per-sample input row of each
        (output row, tap), -1 where none, as ``spconv.rulebook_batched``
        gives it; the backward reads it.
    """
    name = "window_key_conv_batched"
    dev, (b, n, m, k, c, co) = _check_args(name, feats, keys, nkeys,
                                           weights, band)
    build.require_cuda(name, feats, out_keys)
    build.require_dtype(name, out_keys, torch.int32, "out_keys")
    if out_keys.shape != (b, m):
        raise ValueError(f"{name}: out_keys must be (B, M) = {(b, m)}")
    out = torch.empty((b, m, co), dtype=torch.float32, device=dev)
    rb = (torch.empty((b, m, k), dtype=torch.int32, device=dev)
          if rulebook else None)
    c4, co4 = vec4(c), vec4(co)
    pad = needs_pad(feats, weights)
    fp = (torch.empty((b, n, c4), dtype=torch.float32, device=dev)
          if pad else None)
    wp = (torch.empty((k, c4, co4), dtype=torch.float32, device=dev)
          if pad else None)
    lib = build.load_library()
    err = lib.dm_window_key_conv_fwd(
        build.ptr(feats), build.ptr(keys), build.ptr(nkeys),
        build.ptr(weights), build.ptr(fp), build.ptr(wp), build.ptr(out),
        build.ptr(rb), b, n, m, k, c, co, tile_rows(k, c4, co4),
        build.stream(dev))
    window_key_conv_batched.launches += 1
    build.check(lib, err, name)
    return out, rb


def window_key_conv_bwd(dout, feats, rb, weights, need_dfeats=True):
    """Backward of :func:`window_key_conv_batched` on the card.

    Args:
        dout: (B, M, Co) float32 gradient of the output; feats (B, N, C)
            and weights (K, C, Co) float32 as the forward; rb: (B, M, K)
            int32, the rulebook that :func:`window_key_conv_fwd` wrote.
            need_dfeats: False skips the input gradient.
    Returns:
        (dfeats (B, N, C) or None, dweights (K, C, Co)), both float32.
    """
    name = "window_key_conv_bwd"
    dev = build.require_cuda(name, dout, feats, rb, weights)
    for t, dtype, what in ((dout, torch.float32, "dout"),
                           (feats, torch.float32, "feats"),
                           (rb, torch.int32, "rb"),
                           (weights, torch.float32, "weights")):
        build.require_dtype(name, t, dtype, what)
    b, n, c = feats.shape
    m, k = rb.shape[1], rb.shape[2]
    co = weights.shape[-1]
    if (rb.shape[0] != b or weights.shape != (k, c, co)
            or dout.shape != (b, m, co)):
        raise ValueError(f"{name}: shapes do not match dout (B, M, Co), "
                         "feats (B, N, C), rb (B, M, K), weights (K, C, Co)")
    if (n == 0 or k > MAX_TAPS or c > MAX_CIN or co > MAX_COUT
            or c * co > MAX_W):
        raise ValueError(f"{name}: needs N > 0, K <= {MAX_TAPS}, "
                         f"C <= {MAX_CIN}, Co <= {MAX_COUT}, "
                         f"C * Co <= {MAX_W}; got N={n} K={k} C={c} "
                         f"Co={co}")
    c4, co4 = vec4(c), vec4(co)
    chunks = dw_chunks(b * m)
    ws_len = bwd_workspace(b, n, m, k, need_dfeats)
    ws = torch.empty(ws_len, dtype=torch.int32, device=dev)
    partial = torch.empty((k, chunks, c4, co4), dtype=torch.float32,
                          device=dev)
    dw = torch.empty((k, c, co), dtype=torch.float32, device=dev)
    # zero-padded copies of feats and dout where the tiles need them
    fp = (torch.empty((b, n, c4), dtype=torch.float32, device=dev)
          if c % 4 or feats.data_ptr() % 16 else None)
    dp = (torch.empty((b, m, co4), dtype=torch.float32, device=dev)
          if co % 4 or dout.data_ptr() % 16 else None)
    if need_dfeats:
        wt = torch.empty((k, co4, c4), dtype=torch.float32, device=dev)
        dfeats = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    else:
        wt = dfeats = None
    lib = build.load_library()
    err = lib.dm_window_key_conv_bwd(
        build.ptr(feats), build.ptr(rb), build.ptr(weights),
        build.ptr(dout), build.ptr(ws), ws_len, build.ptr(partial),
        build.ptr(wt), build.ptr(fp), build.ptr(dp), build.ptr(dfeats),
        build.ptr(dw), b, n, m, k, c, co, tile_rows(k, co4, c4), chunks,
        build.stream(dev))
    window_key_conv_bwd.launches += 1
    build.check(lib, err, name)
    return dfeats, dw


class _WindowKeyConv(torch.autograd.Function):
    """Forward kernel, with the backward kernel as its gradient; the
    forward keeps its rulebook for the backward only when ``grad`` says
    autograd will want one."""

    @staticmethod
    def forward(ctx, feats, keys, nkeys, out_keys, weights, band, grad):
        out, rb = window_key_conv_fwd(feats, keys, nkeys, out_keys, weights,
                                      band, rulebook=grad)
        ctx.save_for_backward(feats, rb, weights)
        return out

    @staticmethod
    def backward(ctx, dout):
        feats, rb, weights = ctx.saved_tensors
        dfeats, dw = window_key_conv_bwd(
            dout.contiguous(), feats, rb, weights,
            need_dfeats=ctx.needs_input_grad[0])
        return dfeats, None, None, None, dw, None, None


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
    grad = torch.is_grad_enabled() and (feats.requires_grad
                                        or weights.requires_grad)
    return _WindowKeyConv.apply(feats, keys, nkeys, out_keys, weights, band,
                                grad)


window_key_conv_batched.launches = 0
window_key_conv_bwd.launches = 0
