"""HeightCompression + BaseBEVBackbone (counterpart of
``detmatch_tpu/models/pvrcnn/bev.py``; pcdet ``height_compression.py``
and ``base_bev_backbone.py``), dense NCHW convs.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import spconv
from ..layers import batch_norm_2d, conv


def height_compression(level):
    """Sparse stride-8, z-compressed level → dense BEV (B, C*Z, Y, X),
    channels C-outer (``c * Z + z``) as pcdet's ``dense().view``."""
    dense = spconv.to_dense_yxz(level["feats"], level["keys"],
                                level["shape"])  # (B, Y, X, Z, C)
    b, y, x, z, c = dense.shape
    return dense.permute(0, 4, 3, 1, 2).reshape(b, c * z, y, x)


def _bn2d(c):
    return nn.BatchNorm2d(c, eps=1e-3, momentum=0.01)


class BaseBEVBackbone(nn.Module):
    """Conv pyramid with deconv-upsampled concat output; parameter names
    ``blocks.{i}.{j}`` / ``deblocks.{i}.{j}`` as pcdet. With ``dtype``
    (bfloat16) the convs run in it and the output has it; batch norm
    computes in float32 (the JAX ``ConvBNReLU(dtype=...)``)."""

    def __init__(self, input_channels, layer_nums=(5, 5),
                 layer_strides=(1, 2), num_filters=(128, 256),
                 upsample_strides=(1, 2), num_upsample_filters=(256, 256),
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        cin = input_channels
        for i, n_layers in enumerate(layer_nums):
            nf = num_filters[i]
            layers = [nn.ZeroPad2d(1),
                      nn.Conv2d(cin, nf, 3, stride=layer_strides[i],
                                padding=0, bias=False),
                      _bn2d(nf), nn.ReLU()]
            for _ in range(n_layers):
                layers += [nn.Conv2d(nf, nf, 3, padding=1, bias=False),
                           _bn2d(nf), nn.ReLU()]
            self.blocks.append(nn.Sequential(*layers))
            s = upsample_strides[i]
            self.deblocks.append(nn.Sequential(
                nn.ConvTranspose2d(nf, num_upsample_filters[i], s, stride=s,
                                   bias=False),
                _bn2d(num_upsample_filters[i]), nn.ReLU()))
            cin = nf
        self.num_bev_features = sum(num_upsample_filters)

    def forward(self, x):
        """(B, C, H, W) → (B, sum(num_upsample_filters), H, W). In train
        mode BatchNorm2d takes batch statistics over (B, H, W), global
        under several processes (``layers.batch_norm_2d``): the dense BEV
        has no padding, so this is the JAX ``MaskedBatchNorm`` without a
        mask."""
        ups = []
        for block, deblock in zip(self.blocks, self.deblocks):
            x = self._run(block, x)
            ups.append(self._run(deblock, x))
        return torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]

    def _run(self, seq, x):
        for layer in seq:
            if isinstance(layer, (nn.Conv2d, nn.ConvTranspose2d)):
                x = conv(layer, x, self.dtype)
            elif isinstance(layer, nn.BatchNorm2d):
                x = batch_norm_2d(layer, x)
            else:
                x = layer(x)
        return x
