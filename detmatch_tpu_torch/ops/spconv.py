"""Sparse 3D convolution key machinery and the plain gather-GEMM conv
(counterpart of ``detmatch_tpu/ops/spconv.py``).

A sparse tensor is a fixed-capacity (B, N, C) feature buffer plus
(B, N) int32 keys, sorted ascending per sample with ``INVALID_KEY``
padding. A conv resolves each output row's neighbour keys to input rows
by binary search within the row's own sample, then contracts the
gathered (K, Cin) neighbourhood with the (K, Cin, Cout) weights. The
same machinery gives the inverse conv of the Part-A2 UNet (output rows
on the fine keys of a strided conv), sparse max pooling and the dense
scatter.
"""
from __future__ import annotations

import numpy as np
import torch

from .voxelize import INVALID_KEY, delinearize, linearize


def _triple(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def _offsets(kernel_size):
    """Static (K, 3) kernel tap offsets (dz, dy, dx), row-major."""
    kz, ky, kx = kernel_size
    return np.asarray([(dz, dy, dx) for dz in range(kz) for dy in range(ky)
                       for dx in range(kx)], np.int32)


def output_spatial_shape(spatial_shape, kernel_size, stride, padding):
    """Dense conv output dims: floor((d + 2p - k) / s) + 1, per axis."""
    return tuple((d + 2 * p - k) // s + 1 for d, k, s, p in zip(
        spatial_shape, _triple(kernel_size), _triple(stride),
        _triple(padding)))


def _coords(keys, spatial_shape):
    return delinearize(torch.where(keys == INVALID_KEY, 0, keys),
                       spatial_shape)


def subm_neighbor_keys(keys, spatial_shape, kernel_size=(3, 3, 3)):
    """(B, N) keys → (B, N, K) neighbour keys (INVALID_KEY where out of
    bounds or padded)."""
    kernel_size = _triple(kernel_size)
    half = (np.asarray(kernel_size, np.int32) - 1) // 2
    offs = torch.as_tensor(_offsets(kernel_size) - half, device=keys.device)
    nc = _coords(keys, spatial_shape)[:, :, None, :] + offs
    shape = torch.tensor(spatial_shape, dtype=torch.int32, device=keys.device)
    inb = ((nc >= 0) & (nc < shape)).all(-1) & (keys != INVALID_KEY)[..., None]
    return torch.where(inb, linearize(nc, spatial_shape), INVALID_KEY)


def sparse_neighbor_keys(out_keys, spatial_shape_in, spatial_shape_out,
                         kernel_size, stride, padding):
    """(B, M) output keys → (B, M, K) input-space neighbour keys."""
    dev = out_keys.device
    offs = torch.as_tensor(_offsets(_triple(kernel_size)), device=dev)
    stride_ = torch.tensor(_triple(stride), dtype=torch.int32, device=dev)
    pad_ = torch.tensor(_triple(padding), dtype=torch.int32, device=dev)
    oc = _coords(out_keys, spatial_shape_out)
    ic = oc[:, :, None, :] * stride_ - pad_ + offs
    shape_in = torch.tensor(spatial_shape_in, dtype=torch.int32, device=dev)
    inb = (((ic >= 0) & (ic < shape_in)).all(-1)
           & (out_keys != INVALID_KEY)[..., None])
    return torch.where(inb, linearize(ic, spatial_shape_in), INVALID_KEY)


def downsample_keys_batched(in_keys, spatial_shape_in, spatial_shape_out,
                            kernel_size, stride, padding, out_cap):
    """(B, N) keys → ((B, out_cap) sorted output keys, (B,) counts).

    An output position exists iff some input voxel lies under its kernel
    footprint. Per sample: the sorted unique candidate keys, truncated to
    the ``out_cap`` smallest.
    """
    dev = in_keys.device
    b = in_keys.shape[0]
    offs = torch.as_tensor(_offsets(_triple(kernel_size)), device=dev)
    stride_ = torch.tensor(_triple(stride), dtype=torch.int32, device=dev)
    pad_ = torch.tensor(_triple(padding), dtype=torch.int32, device=dev)
    num = _coords(in_keys, spatial_shape_in)[:, :, None, :] + pad_ - offs
    exact = (num % stride_) == 0
    oc = num // stride_
    shape_out = torch.tensor(spatial_shape_out, dtype=torch.int32,
                             device=dev)
    ok = ((exact & (oc >= 0) & (oc < shape_out)).all(-1)
          & (in_keys != INVALID_KEY)[..., None])
    okeys = torch.where(ok, linearize(oc, spatial_shape_out), INVALID_KEY)
    skeys = torch.sort(okeys.reshape(b, -1), dim=1).values
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[:, 1:] = skeys[:, 1:] != skeys[:, :-1]
    first &= skeys != INVALID_KEY
    idx = torch.cumsum(first.to(torch.int32), 1) - 1
    take = first & (idx < out_cap)
    out = torch.full((b, out_cap), INVALID_KEY, dtype=torch.int32,
                     device=dev)
    rows = torch.arange(b, device=dev)[:, None].expand_as(skeys)
    out[rows[take], idx[take].long()] = skeys[take]
    counts = torch.clamp(first.sum(1), max=out_cap).to(torch.int32)
    return out, counts


def lookup_batched(sorted_keys, queries):
    """Per-sample binary search: (B, N) sorted keys, (B, Q) queries →
    (B, Q) int32 row indices, -1 where absent (or the query is
    INVALID_KEY). Each query searches only its own sample's row."""
    n = sorted_keys.shape[1]
    pos = torch.searchsorted(sorted_keys, queries).clamp(max=n - 1)
    found = ((torch.gather(sorted_keys, 1, pos) == queries)
             & (queries != INVALID_KEY))
    return torch.where(found, pos.to(torch.int32), -1)


def rulebook_batched(keys, nkeys):
    """(B, N) sorted keys, (B, M, K) neighbour keys → (B, M, K) int32 input
    rows of each (output row, tap) in its own sample, -1 where absent:
    the rulebook of one indice key, built once and shared by every conv
    of that key (JAX's ``VoxelBackbone8x._rulebook``)."""
    b, m, k = nkeys.shape
    return lookup_batched(keys, nkeys.reshape(b, m * k)).reshape(b, m, k)


def gather_conv_batched(feats, rulebook, weights):
    """Plain gather-GEMM sparse conv.

    Args:
        feats: (B, N, Cin); rulebook: (B, M, K) int32 (-1 = no input);
        weights: (K, Cin, Cout).
    Returns:
        (B, M, Cout).
    """
    b, n, cin = feats.shape
    m, k = rulebook.shape[1], rulebook.shape[2]
    valid = rulebook >= 0
    base = (torch.arange(b, device=feats.device) * n)[:, None, None]
    idx = torch.where(valid, rulebook + base, 0).reshape(-1)
    # index_select, not feats[idx]: its CPU backward (index_add_) is
    # deterministic, the indexing backward (index_put_) is not
    gathered = torch.index_select(feats.reshape(b * n, cin), 0, idx
                                  ).reshape(b, m, k, cin)
    gathered = torch.where(valid[..., None], gathered, 0.0)
    out = gathered.reshape(b * m, k * cin) @ weights.reshape(k * cin, -1)
    return out.reshape(b, m, -1)


def to_dense_yxz(feats, keys, spatial_shape):
    """Scatter (B, N, C) sparse rows to a dense (B, Y, X, Z, C) grid —
    the native layout of the y-major keys (the flat key IS the (y, x, z)
    row-major index)."""
    Z, Y, X = spatial_shape
    b, _, c = feats.shape
    dense = feats.new_zeros(b, Y * X * Z + 1, c)
    idx = torch.where(keys == INVALID_KEY, Y * X * Z, keys).long()
    dense.scatter_(1, idx[..., None].expand(-1, -1, c), feats)
    return dense[:, :-1].reshape(b, Y, X, Z, c)


def to_dense(feats, keys, spatial_shape):
    """Scatter (B, N, C) sparse rows to a dense (B, Z, Y, X, C) grid."""
    return to_dense_yxz(feats, keys, spatial_shape).permute(0, 3, 1, 2, 4)


def inverse_neighbor_keys(fine_keys, spatial_shape_fine,
                          spatial_shape_coarse, kernel_size, stride,
                          padding):
    """Neighbour keys of a SparseInverseConv (spconv
    ``SparseInverseConv3d``): the output rows are the fine-grid keys of
    the paired strided conv, and coarse position q feeds fine position p
    under tap k where p = q * stride - pad + k, i.e. q = (p + pad - k) /
    stride, exact divisions only.

    Returns (B, N_fine, K) coarse-grid keys (INVALID_KEY where none).
    Within a tap, distinct fine keys give distinct coarse keys.
    """
    dev = fine_keys.device
    offs = torch.as_tensor(_offsets(_triple(kernel_size)), device=dev)
    stride_ = torch.tensor(_triple(stride), dtype=torch.int32, device=dev)
    pad_ = torch.tensor(_triple(padding), dtype=torch.int32, device=dev)
    num = (_coords(fine_keys, spatial_shape_fine)[:, :, None, :] + pad_
           - offs)
    qc = num // stride_
    shape_c = torch.tensor(spatial_shape_coarse, dtype=torch.int32,
                           device=dev)
    ok = (((num % stride_ == 0) & (qc >= 0) & (qc < shape_c)).all(-1)
          & (fine_keys != INVALID_KEY)[..., None])
    return torch.where(ok, linearize(qc, spatial_shape_coarse), INVALID_KEY)


def sparse_inverse_conv_batched(coarse_feats, coarse_keys, fine_keys,
                                spatial_shape_fine, spatial_shape_coarse,
                                kernel_size, stride, padding, weights):
    """Plain SparseInverseConv: coarse features (B, Nc, C) back onto the
    fine key set (B, Nf) of the paired strided conv; weights
    (K, C, Cout) → (B, Nf, Cout)."""
    nkeys = inverse_neighbor_keys(fine_keys, spatial_shape_fine,
                                  spatial_shape_coarse, kernel_size, stride,
                                  padding)
    return gather_conv_batched(coarse_feats,
                               rulebook_batched(coarse_keys, nkeys), weights)


def sparse_maxpool_batched(feats, in_keys, spatial_shape_in, kernel_size,
                           stride, padding, out_cap):
    """Sparse max pooling (spconv ``SparseMaxPool3d``): the output keys
    are a strided sparse conv's of the same geometry; each output row
    takes the max over its present input taps.

    Args:
        feats: (B, N, C); in_keys: (B, N) sorted.
    Returns:
        (out_feats (B, out_cap, C), out_keys (B, out_cap), counts (B,)).
    """
    geom = (_triple(kernel_size), _triple(stride), _triple(padding))
    shape_out = output_spatial_shape(spatial_shape_in, *geom)
    out_keys, counts = downsample_keys_batched(
        in_keys, spatial_shape_in, shape_out, *geom, out_cap)
    rb = rulebook_batched(in_keys, sparse_neighbor_keys(
        out_keys, spatial_shape_in, shape_out, *geom))
    b, n, c = feats.shape
    m, k = rb.shape[1], rb.shape[2]
    valid = rb >= 0
    base = (torch.arange(b, device=feats.device) * n)[:, None, None]
    idx = torch.where(valid, rb + base, 0).reshape(-1)
    gathered = torch.index_select(feats.reshape(b * n, c), 0, idx
                                  ).reshape(b, m, k, c)
    pooled = torch.where(valid[..., None], gathered, -torch.inf).amax(2)
    keep = (out_keys != INVALID_KEY)[..., None] & torch.isfinite(pooled)
    return torch.where(keep, pooled, 0.0), out_keys, counts
