"""Aligned RoIAlign over an FPN pyramid (counterpart of
``detmatch_tpu/ops/roialign.py``), in plain PyTorch: the JAX package
computes it outside any Pallas kernel.

The JAX package's semantics, not mmcv's: a fixed 2 x 2 sample grid per
output bin (mmcv's ``sampling_ratio=0`` adapts the grid to each RoI's
size), bilinear samples at coordinates shifted by -0.5 (``aligned``),
zero where a sample lies at or beyond one pixel outside the map. Feature
maps are NCHW; the pooled output is (R, C, out, out), float32 whatever
the maps' dtype (bfloat16 samples times float32 weights, as in JAX).
"""
from __future__ import annotations

import torch

from .pointnet import take_rows


def _sample_grid(x1, y1, x2, y2, out_size, sampling):
    """(R,) box corners in feature coordinates → sample x, y (R, ns) in
    the JAX order (bin row, bin col, sample row, sample col)."""
    r = x1.shape[0]
    bw = (x2 - x1) / out_size
    bh = (y2 - y1) / out_size
    ij = torch.arange(out_size, dtype=x1.dtype, device=x1.device)
    sg = (torch.arange(sampling, dtype=x1.dtype, device=x1.device)
          + 0.5) / sampling
    off = ij[None, :, None] + sg[None, None, :]
    sx = x1[:, None, None] + off * bw[:, None, None]  # (R, out, s)
    sy = y1[:, None, None] + off * bh[:, None, None]
    shape = (r, out_size, out_size, sampling, sampling)
    gx = sx[:, None, :, None, :].expand(shape).reshape(r, -1)
    gy = sy[:, :, None, :, None].expand(shape).reshape(r, -1)
    return gx, gy


def _bilinear(table, gx, gy, h, w, base):
    """Sample the (rows, C) flat table of maps of size (h, w) (per-RoI
    (R, 1) tensors) starting at row ``base`` → (R, ns, C)."""
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    x0i = torch.minimum(torch.clamp(x0.long(), min=0), w - 1)
    x1i = torch.minimum(torch.clamp(x0i + 1, min=0), w - 1)
    y0i = torch.minimum(torch.clamp(y0.long(), min=0), h - 1)
    y1i = torch.minimum(torch.clamp(y0i + 1, min=0), h - 1)
    lx = torch.clamp(gx - x0, 0.0, 1.0)
    ly = torch.clamp(gy - y0, 0.0, 1.0)
    out = None
    for yi, xi, wt in ((y0i, x0i, (1 - ly) * (1 - lx)),
                       (y0i, x1i, (1 - ly) * lx),
                       (y1i, x0i, ly * (1 - lx)),
                       (y1i, x1i, ly * lx)):
        term = take_rows(table, base + yi * w + xi) * wt[..., None]
        out = term if out is None else out + term
    inside = ((gx > -1.0) & (gx < w.to(gx.dtype))
              & (gy > -1.0) & (gy < h.to(gy.dtype)))
    return torch.where(inside[..., None], out, 0.0)


def _pool(table, rois, inv_s, h, w, base, out_size, sampling):
    x1 = rois[:, 0] * inv_s - 0.5
    y1 = rois[:, 1] * inv_s - 0.5
    x2 = rois[:, 2] * inv_s - 0.5
    y2 = rois[:, 3] * inv_s - 0.5
    gx, gy = _sample_grid(x1, y1, x2, y2, out_size, sampling)
    v = _bilinear(table, gx, gy, h[:, None], w[:, None], base[:, None])
    r, c = rois.shape[0], table.shape[1]
    v = v.reshape(r, out_size, out_size, sampling * sampling, c).mean(3)
    return v.permute(0, 3, 1, 2).contiguous()


def roi_align(features, rois, spatial_scale, out_size=7, sampling=2):
    """Aligned RoIAlign on one (C, H, W) map of (R, 4) xyxy image-frame
    RoIs → (R, C, out_size, out_size)."""
    c, h, w = features.shape
    r = rois.shape[0]
    dev = rois.device
    table = features.permute(1, 2, 0).reshape(h * w, c)
    inv_s = torch.full((r,), spatial_scale, dtype=rois.dtype, device=dev)
    hh = torch.full((r,), h, dtype=torch.int64, device=dev)
    ww = torch.full((r,), w, dtype=torch.int64, device=dev)
    base = torch.zeros(r, dtype=torch.int64, device=dev)
    return _pool(table, rois, inv_s, hh, ww, base, out_size, sampling)


def multilevel_roi_align(feats_per_level, rois, strides, out_size=7,
                         sampling=2, finest_scale=56):
    """mmdet ``SingleRoIExtractor``: each RoI pools from the level
    ``floor(log2(sqrt(area) / finest_scale + 1e-6))``, clamped to the
    pyramid.

    Args:
        feats_per_level: (C, H_l, W_l) maps of one image, finest first.
        rois: (R, 4) xyxy in image coordinates.
        strides: each level's stride.
    Returns:
        (R, C, out_size, out_size).
    """
    dev = rois.device
    scale = torch.sqrt(torch.clamp(
        (rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1]), min=1e-6))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    lvl = torch.clamp(lvl, 0, len(feats_per_level) - 1).long()
    c = feats_per_level[0].shape[0]
    hs = torch.tensor([f.shape[1] for f in feats_per_level], device=dev)
    ws = torch.tensor([f.shape[2] for f in feats_per_level], device=dev)
    sizes = hs * ws
    offs = torch.cumsum(sizes, 0) - sizes
    table = torch.cat([f.permute(1, 2, 0).reshape(-1, c)
                       for f in feats_per_level], 0)
    inv_s = torch.tensor([1.0 / s for s in strides], dtype=rois.dtype,
                         device=dev)[lvl]
    return _pool(table, rois, inv_s, hs[lvl], ws[lvl], offs[lvl], out_size,
                 sampling)
