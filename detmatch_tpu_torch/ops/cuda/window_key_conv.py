"""Sparse 3D conv forward over sorted voxel keys: CUDA kernel
``csrc/window_key_conv.cu`` (replacing the TPU kernel
``detmatch_tpu/ops/pallas/window_key_conv.py:_fwd``) and its plain
PyTorch twin :func:`window_key_conv_plain`, the rulebook gather-GEMM
(``spconv.lookup_batched`` + ``spconv.gather_conv_batched``).

Each (row, tap) neighbour key is resolved inside its own sample's key
table. On a CPU tensor the wrapper runs the twin; on a CUDA tensor it
launches the kernel or raises. fp32 throughout; the two differ only in
summation order.
"""
from __future__ import annotations

import torch

from .. import spconv
from . import build

# csrc/window_key_conv.cu limits
MAX_TAPS, MAX_CIN, MAX_COUT, MAX_W = 27, 64, 128, 8192


def _check_band(b, band):
    if b * band >= 2 ** 31:
        raise ValueError(f"window_key_conv_batched: B * band = {b * band} "
                         f"must stay below 2^31 (B={b}, band={band})")


def window_key_conv_plain(feats, keys, nkeys, out_keys, weights, band):
    """Plain twin of :func:`window_key_conv_batched` (same arguments)."""
    _check_band(feats.shape[0], band)
    b, m, k = nkeys.shape
    rb = spconv.lookup_batched(keys, nkeys.reshape(b, m * k))
    return spconv.gather_conv_batched(feats, rb.reshape(b, m, k), weights)


def window_key_conv_batched(feats, keys, nkeys, out_keys, weights, band):
    """Sparse conv forward, the JAX ``window_key_conv_batched`` signature.

    Args:
        feats: (B, N, C) float32; keys: (B, N) int32 sorted per sample,
            INVALID_KEY padded; nkeys: (B, M, K) int32 neighbour keys of
            each output row (INVALID_KEY = no tap); out_keys: (B, M) the
            output keys (not needed by the forward; kept for the JAX
            signature); weights: (K, C, Co) float32; band: per-sample key
            space size, ``B * band`` must stay below 2^31.
    Returns:
        (B, M, Co) float32.
    """
    if feats.device.type == "cpu":
        return window_key_conv_plain(feats, keys, nkeys, out_keys, weights,
                                     band)
    name = "window_key_conv_batched"
    b, n, c = feats.shape
    _check_band(b, band)
    dev = build.require_cuda(name, feats, keys, nkeys, out_keys, weights)
    for t, dtype, what in ((feats, torch.float32, "feats"),
                           (keys, torch.int32, "keys"),
                           (nkeys, torch.int32, "nkeys"),
                           (out_keys, torch.int32, "out_keys"),
                           (weights, torch.float32, "weights")):
        build.require_dtype(name, t, dtype, what)
    m, k = nkeys.shape[1], nkeys.shape[2]
    co = weights.shape[-1]
    if (keys.shape != (b, n) or nkeys.shape[0] != b
            or out_keys.shape != (b, m) or weights.shape != (k, c, co)):
        raise ValueError(f"{name}: shapes do not match feats (B, N, C), "
                         "keys (B, N), nkeys (B, M, K), out_keys (B, M), "
                         "weights (K, C, Co)")
    if (n == 0 or k > MAX_TAPS or c > MAX_CIN or co > MAX_COUT
            or c * co > MAX_W):
        raise ValueError(f"{name}: needs N > 0, K <= {MAX_TAPS}, "
                         f"C <= {MAX_CIN}, Co <= {MAX_COUT}, "
                         f"C * Co <= {MAX_W}; got N={n} K={k} C={c} "
                         f"Co={co}")
    out = torch.empty((b, m, co), dtype=torch.float32, device=dev)
    lib = build.load_library()
    err = lib.dm_window_key_conv_fwd(
        build.ptr(feats), build.ptr(keys), build.ptr(nkeys),
        build.ptr(weights), build.ptr(out), b, n, m, k, c, co,
        build.stream(dev))
    window_key_conv_batched.launches += 1
    build.check(lib, err, name)
    return out


window_key_conv_batched.launches = 0
