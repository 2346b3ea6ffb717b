"""VoxelBackbone8x, the sparse 3D conv backbone (counterpart of
``detmatch_tpu/models/pvrcnn/backbone3d.py``; pcdet
``spconv_backbone.py:70-199``).

SubM(4→16) → [SparseConv s2 + 2×SubM] ×3 (16→32→64→64) → SparseConv
(3,1,1)/(2,1,1) z-compression to 128 ch. Each level is a fixed-capacity
sparse buffer with sorted keys; every conv runs through a sparse-conv op
of the given ``ops.cuda.Ops`` (the CUDA kernels by default): the fp32
windowed conv (``conv_impl="window"``, kernel K1), the bf16-operand
key-compare conv (``conv_impl="key"``, kernel K5) or the fp32 rulebook
gather-GEMM (``conv_impl="rulebook"``, kernel K7), the counterparts of
the JAX ``conv_impl`` values ``"pallas_window"``, ``"pallas_key"`` and
``"xla"``. The rulebook path resolves an indice key's neighbour keys to
input rows once (``spconv.rulebook_batched``): one rulebook per subm
pair, shared by both of its convs, and one per strided conv.
Parameter names and the spconv 1.x weight layout (kz, ky, kx, Cin, Cout)
follow pcdet, e.g. ``conv2.0.0.weight``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...ops import spconv
from ...ops.cuda import KERNELS
from ...ops.voxelize import INVALID_KEY
from ..init import he_normal_
from ..layers import masked_bn


class SparseConv3d(nn.Module):
    """Weight holder of a spconv SubMConv3d / SparseConv3d (the geometry
    lives in :class:`VoxelBackbone8x`)."""

    def __init__(self, cin, cout, kernel_size):
        super().__init__()
        ks = spconv._triple(kernel_size)
        self.weight = nn.Parameter(torch.empty(*ks, cin, cout))
        he_normal_(self.weight, math.prod(ks) * cin)

    def taps(self):
        """(K, Cin, Cout) view of the weight, K = kz*ky*kx row-major."""
        w = self.weight
        return w.reshape(-1, w.shape[-2], w.shape[-1])


def _block(cin, cout, kernel_size):
    """pcdet's (conv, BatchNorm1d(eps 1e-3), ReLU) unit; the ReLU has no
    parameters and is applied in :meth:`VoxelBackbone8x.forward`."""
    return nn.ModuleList([SparseConv3d(cin, cout, kernel_size),
                          nn.BatchNorm1d(cout, eps=1e-3, momentum=0.01)])


def level_shapes(spatial_shape):
    """Static (Z, Y, X) of every backbone level."""
    s1 = tuple(spatial_shape)
    s2 = spconv.output_spatial_shape(s1, 3, 2, 1)
    s3 = spconv.output_spatial_shape(s2, 3, 2, 1)
    s4 = spconv.output_spatial_shape(s3, 3, 2, (0, 1, 1))
    s_out = spconv.output_spatial_shape(s4, (3, 1, 1), (2, 1, 1), 0)
    return s1, s2, s3, s4, s_out


CONV_IMPLS = ("window", "key", "rulebook")


class VoxelBackbone8x(nn.Module):
    def __init__(self, spatial_shape, input_channels=4,
                 channels=(16, 16, 32, 64, 64), out_channels=128,
                 caps=(24000, 16000, 10000, 10000), conv_impl="window"):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got "
                             f"{conv_impl!r}")
        self.conv_impl = conv_impl
        self.spatial_shape = tuple(spatial_shape)
        self.caps = tuple(caps)
        c1, c1b, c2, c3, c4 = channels
        self.channels = tuple(channels)
        self.out_channels = out_channels
        self.conv_input = _block(input_channels, c1, 3)
        self.conv1 = nn.ModuleList([_block(c1, c1b, 3)])
        self.conv2 = nn.ModuleList([_block(c1b, c2, 3), _block(c2, c2, 3),
                                    _block(c2, c2, 3)])
        self.conv3 = nn.ModuleList([_block(c2, c3, 3), _block(c3, c3, 3),
                                    _block(c3, c3, 3)])
        self.conv4 = nn.ModuleList([_block(c3, c4, 3), _block(c4, c4, 3),
                                    _block(c4, c4, 3)])
        self.conv_out = _block(c4, out_channels, (3, 1, 1))

    def _rulebook(self, keys, nkeys):
        """The rulebook path's (B, M, K) input rows, else None (the
        kernels of the other paths resolve the keys themselves)."""
        if self.conv_impl != "rulebook":
            return None
        return spconv.rulebook_batched(keys, nkeys)

    def _conv(self, block, ops, feats, keys, nkeys, out_keys, shape_in,
              mask, rb):
        conv, bn = block
        band = int(np.prod(shape_in)) + 1
        if self.conv_impl == "rulebook":
            out = ops.gather_conv_batched(feats, rb, conv.taps())
        elif self.conv_impl == "key":
            out = ops.key_conv_batched(feats, keys, nkeys, conv.taps(), band)
        else:
            out = ops.window_key_conv_batched(feats, keys, nkeys, out_keys,
                                              conv.taps(), band)
        return torch.relu(masked_bn(bn, out, mask))

    def _down(self, block, ops, feats, keys, shape_in, kernel, stride,
              padding, cap):
        shape_out = spconv.output_spatial_shape(shape_in, kernel, stride,
                                                padding)
        geom = (spconv._triple(kernel), spconv._triple(stride),
                spconv._triple(padding))
        out_keys, _ = spconv.downsample_keys_batched(
            keys, shape_in, shape_out, *geom, cap)
        nkeys = spconv.sparse_neighbor_keys(out_keys, shape_in, shape_out,
                                            *geom)
        mask = out_keys != INVALID_KEY
        out = self._conv(block, ops, feats, keys, nkeys, out_keys, shape_in,
                         mask, self._rulebook(keys, nkeys))
        return out, out_keys, mask, shape_out

    def _subm_pair(self, blocks, ops, x, keys, mask, shape):
        nk = spconv.subm_neighbor_keys(keys, shape)
        rb = self._rulebook(keys, nk)
        for block in blocks:
            x = self._conv(block, ops, x, keys, nk, keys, shape, mask, rb)
        return x

    def forward(self, voxel_features, voxel_keys, ops=KERNELS):
        """
        Args:
            voxel_features: (B, N0, C_in) mean-VFE features.
            voxel_keys: (B, N0) sorted int32 keys, INVALID_KEY padded.
        Returns:
            dict x_conv1..4 and 'out' of dict(feats (B, N, C), keys (B, N),
            mask (B, N), shape (Z, Y, X), stride).
        """
        shape1 = self.spatial_shape
        keys1 = voxel_keys
        mask1 = keys1 != INVALID_KEY
        x = self._subm_pair([self.conv_input, self.conv1[0]], ops,
                            voxel_features, keys1, mask1, shape1)
        levels = {"x_conv1": (x, keys1, mask1, shape1, 1)}
        keys, shape = keys1, shape1
        for lvl, blocks, cap, pad in (
                (2, self.conv2, self.caps[0], 1),
                (3, self.conv3, self.caps[1], 1),
                (4, self.conv4, self.caps[2], (0, 1, 1))):
            x, keys, mask, shape = self._down(blocks[0], ops, x, keys, shape,
                                              3, 2, pad, cap)
            x = self._subm_pair(blocks[1:], ops, x, keys, mask, shape)
            levels[f"x_conv{lvl}"] = (x, keys, mask, shape, 2 ** (lvl - 1))
        out, keys, mask, shape = self._down(self.conv_out, ops, x, keys,
                                            shape, (3, 1, 1), (2, 1, 1), 0,
                                            self.caps[3])
        levels["out"] = (out, keys, mask, shape, 8)
        return {name: dict(feats=f, keys=k, mask=m, shape=s, stride=st)
                for name, (f, k, m, s, st) in levels.items()}
