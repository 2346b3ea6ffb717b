"""UNetV2, the sparse-conv backbone of Part-A2 (counterpart of
``detmatch_tpu/models/pvrcnn/unet.py``; pcdet ``spconv_unet.py``): the
VoxelBackbone8x encoder, then a decoder of UR blocks (a SparseBasicBlock
on the lateral features, concat with the bottom-up path, a subm conv
halving the channels plus the residual channel reduction, then a
SparseInverseConv back onto the finer key set) ending in 16-channel
features on the level-1 voxels.

Every one of the 28 convs of a forward (12 in the encoder, 16 in the
decoder) runs through ``ops.window_key_conv_batched`` (kernel K1), the
UR blocks' merge convs at 2C = 128 input channels. An inverse conv is K1
on the coarse key table with :func:`~...ops.spconv.inverse_neighbor_keys`
as the neighbour keys and the fine keys as the output rows: the sum JAX's
``sparse_inverse_conv_batched`` computes, each (fine row, tap) reading at
most one coarse row. The decoder reuses the encoder's key sets, so it
makes none.

Parameter names pcdet's (``conv_input``, ``conv1``…``conv4``,
``conv_out``, ``conv_up_t{k}`` with ``conv1 / bn1 / conv2 / bn2``,
``conv_up_m{k}``, ``inv_conv{k}``, ``conv5``), spconv 1.x weights
(kz, ky, kx, Cin, Cout); batch norm eps 1e-3.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops import spconv
from ...ops.cuda import KERNELS
from ...ops.voxelize import INVALID_KEY
from ..layers import masked_bn
from .backbone3d import SparseConv3d, _block


class SparseBasicBlock(nn.Module):
    """Two subm convs with an identity residual (pcdet
    ``SparseBasicBlock``)."""

    def __init__(self, c):
        super().__init__()
        self.conv1 = SparseConv3d(c, c, 3)
        self.bn1 = nn.BatchNorm1d(c, eps=1e-3, momentum=0.01)
        self.conv2 = SparseConv3d(c, c, 3)
        self.bn2 = nn.BatchNorm1d(c, eps=1e-3, momentum=0.01)


class UNetBackbone(nn.Module):
    def __init__(self, spatial_shape, input_channels=4,
                 channels=(16, 16, 32, 64, 64), out_channels=128,
                 caps=(24000, 16000, 10000, 10000)):
        super().__init__()
        self.spatial_shape = tuple(spatial_shape)
        self.caps = tuple(caps)
        self.channels = tuple(channels)
        self.out_channels = out_channels
        c1, c1b, c2, c3, c4 = channels
        self.conv_input = _block(input_channels, c1, 3)
        self.conv1 = nn.ModuleList([_block(c1, c1b, 3)])
        for lvl, cin, c in ((2, c1b, c2), (3, c2, c3), (4, c3, c4)):
            setattr(self, f"conv{lvl}", nn.ModuleList(
                [_block(cin, c, 3), _block(c, c, 3), _block(c, c, 3)]))
        self.conv_out = _block(c4, out_channels, (3, 1, 1))
        for k, c, cout in ((4, c4, c3), (3, c3, c2), (2, c2, c1b),
                           (1, c1b, None)):
            setattr(self, f"conv_up_t{k}", SparseBasicBlock(c))
            setattr(self, f"conv_up_m{k}", _block(2 * c, c, 3))
            if cout is not None:
                setattr(self, f"inv_conv{k}", _block(c, cout, 3))
        self.conv5 = _block(c1b, c1b, 3)

    @staticmethod
    def _conv(conv, ops, feats, keys, nkeys, out_keys, shape_in):
        return ops.window_key_conv_batched(feats, keys, nkeys, out_keys,
                                           conv.taps(),
                                           int(np.prod(shape_in)) + 1)

    def _subm(self, block, ops, x, keys, nk, mask, shape, relu=True):
        conv, bn = block
        out = masked_bn(bn, self._conv(conv, ops, x, keys, nk, keys, shape),
                        mask)
        return torch.relu(out) if relu else out

    def _basic(self, blk, ops, x, keys, nk, mask, shape):
        out = self._subm((blk.conv1, blk.bn1), ops, x, keys, nk, mask, shape)
        out = self._subm((blk.conv2, blk.bn2), ops, out, keys, nk, mask,
                         shape, relu=False)
        return torch.where(mask[..., None], torch.relu(out + x), 0.0)

    def _down(self, block, ops, x, keys, shape_in, kernel, stride, padding,
              cap):
        geom = (spconv._triple(kernel), spconv._triple(stride),
                spconv._triple(padding))
        shape_out = spconv.output_spatial_shape(shape_in, *geom)
        out_keys, _ = spconv.downsample_keys_batched(keys, shape_in,
                                                     shape_out, *geom, cap)
        nk = spconv.sparse_neighbor_keys(out_keys, shape_in, shape_out,
                                         *geom)
        mask = out_keys != INVALID_KEY
        conv, bn = block
        out = torch.relu(masked_bn(bn, self._conv(conv, ops, x, keys, nk,
                                                  out_keys, shape_in), mask))
        return out, out_keys, mask, shape_out, (shape_in, shape_out, *geom)

    def _inverse(self, block, ops, x, coarse_keys, fine_keys, geo,
                 fine_mask):
        shape_fine, shape_coarse = geo[:2]
        nk = spconv.inverse_neighbor_keys(fine_keys, shape_fine,
                                          shape_coarse, *geo[2:])
        conv, bn = block
        out = self._conv(conv, ops, x, coarse_keys, nk, fine_keys,
                         shape_coarse)
        return torch.relu(masked_bn(bn, out, fine_mask))

    def _ur(self, k, ops, lateral, bottom, keys, nk, mask, shape):
        """UR block core: conv_m(cat) + channel_reduction(cat), the
        reduction summing adjacent channel pairs."""
        trans = self._basic(getattr(self, f"conv_up_t{k}"), ops, lateral,
                            keys, nk, mask, shape)
        cat = torch.cat([bottom, trans], -1)
        m = self._subm(getattr(self, f"conv_up_m{k}"), ops, cat, keys, nk,
                       mask, shape)
        b, n, c2 = cat.shape
        return m + cat.reshape(b, n, c2 // 2, 2).sum(-1)

    def forward(self, voxel_features, voxel_keys, ops=KERNELS):
        """As ``VoxelBackbone8x.forward``, plus ``point_features``
        (B, N0, C1b) on the level-1 keys."""
        shape1 = self.spatial_shape
        keys1 = voxel_keys
        mask1 = keys1 != INVALID_KEY
        nk1 = spconv.subm_neighbor_keys(keys1, shape1)
        x = self._subm(self.conv_input, ops, voxel_features, keys1, nk1,
                       mask1, shape1)
        x1 = self._subm(self.conv1[0], ops, x, keys1, nk1, mask1, shape1)
        levels = {1: (x1, keys1, mask1, shape1, nk1, None)}
        x, keys, shape = x1, keys1, shape1
        for lvl, cap, pad in ((2, self.caps[0], 1), (3, self.caps[1], 1),
                              (4, self.caps[2], (0, 1, 1))):
            blocks = getattr(self, f"conv{lvl}")
            x, keys, mask, shape, geo = self._down(blocks[0], ops, x, keys,
                                                   shape, 3, 2, pad, cap)
            nk = spconv.subm_neighbor_keys(keys, shape)
            for block in blocks[1:]:
                x = self._subm(block, ops, x, keys, nk, mask, shape)
            levels[lvl] = (x, keys, mask, shape, nk, geo)
        out, keys_out, mask_out, shape_out, _ = self._down(
            self.conv_out, ops, x, keys, shape, (3, 1, 1), (2, 1, 1), 0,
            self.caps[3])

        up = levels[4][0]
        for k in (4, 3, 2, 1):
            xk, keys, mask, shape, nk, geo = levels[k]
            m = self._ur(k, ops, xk, up, keys, nk, mask, shape)
            if k > 1:
                fine = levels[k - 1]
                up = self._inverse(getattr(self, f"inv_conv{k}"), ops, m,
                                   keys, fine[1], geo, fine[2])
        point_features = self._subm(self.conv5, ops, m, keys1, nk1, mask1,
                                    shape1)
        res = {f"x_conv{k}": dict(feats=f, keys=kk, mask=mm, shape=s,
                                  stride=2 ** (k - 1))
               for k, (f, kk, mm, s, _, _) in levels.items()}
        res["out"] = dict(feats=out, keys=keys_out, mask=mask_out,
                          shape=shape_out, stride=8)
        res["point_features"] = point_features
        return res
