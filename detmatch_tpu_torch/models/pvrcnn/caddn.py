"""CaDDN, the monocular 3D detector (counterpart of
``detmatch_tpu/models/pvrcnn/caddn.py``; pcdet ``detectors/caddn.py``,
``vfe/image_vfe.py``, ``ffn/ddn``, ``f2v/frustum_to_voxel`` and
``map_to_bev/conv2d_collapse.py``):

image → DDN (caffe ResNet-50 trunk + ASPP head → stride-4 image features
and per-pixel depth logits over D + 1 bins) → frustum features (feature ×
depth probability) → trilinear frustum-to-voxel sampling through the
calibration → Conv2DCollapse BEV → BaseBEVBackbone → AnchorHeadSingle;
the depth distribution is supervised by a focal loss balanced between
foreground (inside a 2D gt box) and background pixels.

The port follows JAX, not pcdet, where they differ:

* the collapse flattens each voxel column Z-major, then C (JAX
  ``_collapse`` after its ``(B, Y, X, Z, C)`` transpose); pcdet's is
  C-major;
* the trunk is the port's frozen caffe ResNet-50 (``frozen_stages=1``)
  and the head :class:`ASPPLite`, not torchvision's DeepLabV3.

Batch (JAX's): images (B, H, W, 3) caffe BGR (mean-subtracted, as the
Faster R-CNN's canvas), lidar2cam (B, 4, 4) (``R0 @ Tr_velo_to_cam``),
cam2img (B, 3, 4) (``P2``); for training gt_boxes (B, G, 8), depth_maps
(B, H', W') at the stride-4 feature size and gt_boxes2d (B, G', 4) xyxy
in image pixels (all-zero rows are padding).

The depth loss's normaliser counts one process's pixels: CaDDN refuses
several processes (:meth:`CaDDN.loss`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import process_count
from ..frcnn.resnet import ResNet50
from ..layers import batch_norm_2d
from .anchor_head import AnchorHeadSingle
from .bev import BaseBEVBackbone, _bn2d
from .pvrcnn import DEFAULT_ANCHOR_CONFIGS
from .second import check_mode, total

# CaDDN's anchors live on the stride-2 BEV map (upstream ``CaDDN.yaml``)
CADDN_ANCHOR_CONFIGS = tuple(
    dict(cfg, feature_map_stride=2) for cfg in DEFAULT_ANCHOR_CONFIGS)


def bin_depths(depth, mode, d_min, d_max, num_bins, clamp=True):
    """Continuous depth → (fractional) bin index, float32 (pcdet
    ``transform_utils.bin_depths``). UD: uniform bins; LID: linearly
    increasing widths, ``-0.5`` for every depth at or below
    ``d_min - bin_size / 8``. With ``clamp`` a depth out of
    [bin 0, bin ``num_bins - 1``] or non-finite goes to bin ``num_bins``
    (the targets); without it the index is left as is (the sampling)."""
    if mode == "UD":
        idx = (depth - d_min) / ((d_max - d_min) / num_bins)
    elif mode == "LID":
        bin_size = 2 * (d_max - d_min) / (num_bins * (1 + num_bins))
        idx = -0.5 + 0.5 * torch.sqrt(
            torch.clamp(1 + 8 * (depth - d_min) / bin_size, min=0.0))
    else:
        raise NotImplementedError(mode)
    if clamp:
        idx = torch.where((idx < 0) | (idx > num_bins - 1)
                          | ~torch.isfinite(idx), float(num_bins), idx)
    return idx


def trilinear_sample(vol, d, v, u):
    """vol (D, H, W, C); d, v, u (...,) continuous indices → (..., C).

    The eight corners in JAX's order and arithmetic: a corner outside
    the volume contributes 0 (``grid_sample``'s zero padding with
    ``align_corners=True``), so d = -0.5 takes half of bin 0. A
    non-finite index gives NaN in every channel, as in JAX (its weight
    is non-finite and ``nan * 0`` is NaN). Indices are formed in float32
    (exact below 2^24 voxels), so no out-of-range integer cast occurs.
    """
    D, H, W, C = vol.shape
    shape = d.shape
    flat_vol = vol.reshape(-1, C)
    d0, v0, u0 = torch.floor(d), torch.floor(v), torch.floor(u)
    fd, fv, fu = ((d - d0)[..., None], (v - v0)[..., None],
                  (u - u0)[..., None])
    out = None
    for dd in (0, 1):
        for dv in (0, 1):
            for du in (0, 1):
                di, vi, ui = d0 + dd, v0 + dv, u0 + du
                inb = ((di >= 0) & (di <= D - 1) & (vi >= 0) & (vi <= H - 1)
                       & (ui >= 0) & (ui <= W - 1))
                flat = torch.where(inb, (di * H + vi) * W + ui, 0.0).long()
                vals = torch.index_select(flat_vol, 0, flat.reshape(-1))
                corner = torch.where(inb[..., None],
                                     vals.reshape(shape + (C,)), 0.0)
                w = ((fd if dd else 1 - fd) * (fv if dv else 1 - fv)
                     * (fu if du else 1 - fu))
                out = w * corner if out is None else out + w * corner
    return out


class ASPPLite(nn.Module):
    """Compact atrous pyramid head (JAX ``ASPPLite``, its submodule
    names): 3 × 3 convs ``aspp{r}`` at dilations ``rates`` (padding = r),
    each with batch norm ``aspp{r}_bn`` and ReLU, concatenated, a 1 × 1
    projection ``proj`` with ``proj_bn`` and ReLU."""

    def __init__(self, in_channels=2048, features=256, rates=(1, 6, 12)):
        super().__init__()
        self.rates = tuple(rates)
        for r in self.rates:
            setattr(self, f"aspp{r}", nn.Conv2d(
                in_channels, features, 3, padding=r, dilation=r, bias=False))
            setattr(self, f"aspp{r}_bn", _bn2d(features))
        self.proj = nn.Conv2d(features * len(self.rates), features, 1,
                              bias=False)
        self.proj_bn = _bn2d(features)

    def forward(self, x):
        branches = [F.relu(batch_norm_2d(getattr(self, f"aspp{r}_bn"),
                                         getattr(self, f"aspp{r}")(x)))
                    for r in self.rates]
        return F.relu(batch_norm_2d(self.proj_bn,
                                    self.proj(torch.cat(branches, 1))))


class DDN(nn.Module):
    """Depth distribution network (JAX ``DDN``): the ResNet-50 trunk, the
    ASPP head on C5 → depth logits over ``num_bins + 1`` bins, upsampled
    bilinearly (half-pixel centres, ``jax.image.resize``) to the C2 size;
    C2 reduced to ``feat_channels`` features (1 × 1 conv, batch norm,
    ReLU)."""

    def __init__(self, num_bins=80, feat_channels=64):
        super().__init__()
        self.trunk = ResNet50()
        self.aspp = ASPPLite(2048)
        self.depth_out = nn.Conv2d(256, num_bins + 1, 1)
        self.channel_reduce = nn.Conv2d(256, feat_channels, 1, bias=False)
        self.channel_reduce_bn = _bn2d(feat_channels)

    def forward(self, images):
        """(B, 3, H, W) → features (B, C, H', W'), logits
        (B, D + 1, H', W'), (H', W') the C2 size."""
        c2, _, _, c5 = self.trunk(images)
        logits = self.depth_out(self.aspp(c5))
        logits = F.interpolate(logits, size=c2.shape[-2:], mode="bilinear",
                               align_corners=False)
        feats = F.relu(batch_norm_2d(self.channel_reduce_bn,
                                     self.channel_reduce(c2)))
        return feats, logits


class CaDDN(nn.Module):
    """Batch norm follows the module mode (``model.train()`` /
    ``model.eval()``). Submodules: ``ddn``, ``collapse`` (``conv``,
    ``bn``), ``backbone_2d`` (strides 2, 2, 2; upsampling 1, 2, 4 → 384
    channels at stride 2), ``dense_head``."""

    def __init__(self, num_classes=3,
                 point_cloud_range=(2.0, -30.08, -3.0, 46.8, 30.08, 1.0),
                 voxel_size=(0.16, 0.16, 0.16), grid_size=(280, 376, 25),
                 depth_bins=80, depth_range=(2.0, 46.8), depth_mode="LID",
                 downsample=4, bev_features=64,
                 anchor_configs=CADDN_ANCHOR_CONFIGS, ddn_weight=3.0,
                 fg_weight=13.0, bg_weight=1.0):
        super().__init__()
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.grid_size = tuple(grid_size)
        self.depth_bins = depth_bins
        self.depth_range = tuple(depth_range)
        self.depth_mode = depth_mode
        self.downsample = downsample
        self.ddn_weight, self.fg_weight, self.bg_weight = (
            ddn_weight, fg_weight, bg_weight)
        self.ddn = DDN(num_bins=depth_bins)
        self.collapse = nn.Module()
        self.collapse.conv = nn.Conv2d(grid_size[2] * 64,
                                       bev_features, 1, bias=False)
        self.collapse.bn = _bn2d(bev_features)
        self.backbone_2d = BaseBEVBackbone(
            bev_features, layer_nums=(10, 10, 10), layer_strides=(2, 2, 2),
            num_filters=(64, 128, 256), upsample_strides=(1, 2, 4),
            num_upsample_filters=(128, 128, 128))
        self.dense_head = AnchorHeadSingle(
            self.backbone_2d.num_bev_features, num_classes=num_classes,
            anchor_configs=anchor_configs,
            point_cloud_range=point_cloud_range, grid_size=grid_size)
        self.register_buffer("voxel_centers", self._voxel_centers(),
                             persistent=False)

    def _voxel_centers(self):
        """Homogeneous voxel centres (Y, X, Z, 4), float32 as JAX's."""
        gx, gy, gz = self.grid_size
        pcr, vs = self.point_cloud_range, self.voxel_size
        axes = [pcr[i] + (torch.arange(n, dtype=torch.float32) + 0.5) * vs[i]
                for i, n in enumerate((gx, gy, gz))]
        yy, xx, zz = torch.meshgrid(axes[1], axes[0], axes[2], indexing="ij")
        return torch.stack([xx, yy, zz, torch.ones_like(xx)], -1)

    def frustum_to_voxels(self, frustum, lidar2cam, cam2img):
        """frustum (B, D, H', W', C) → voxel features (B, Y, X, Z, C): each
        voxel centre through the calibration to (bin, row, column) of the
        frustum (JAX's ``per_sample``)."""
        out = []
        for fr, l2c, c2i in zip(frustum, lidar2cam, cam2img):
            cam = self.voxel_centers @ l2c.T
            img = cam @ c2i.T
            depth = img[..., 2]
            u = img[..., 0] / torch.clamp(depth, min=1e-3) / self.downsample
            v = img[..., 1] / torch.clamp(depth, min=1e-3) / self.downsample
            d = bin_depths(depth, self.depth_mode, self.depth_range[0],
                           self.depth_range[1], self.depth_bins, clamp=False)
            out.append(trilinear_sample(fr, d, v, u))
        return torch.stack(out)

    def forward(self, batch, train=None, generator=None):
        """→ dict(head_preds, batch_box_preds (B, A, 7), batch_cls_preds
        (B, A, C) logits, depth_logits (B, H', W', D + 1))."""
        check_mode(self, train, generator, needs_generator=False)
        feats, logits = self.ddn(batch["images"].permute(0, 3, 1, 2))
        probs = torch.softmax(logits, dim=1)[:, :self.depth_bins]
        frustum = probs[..., None] * feats.permute(0, 2, 3, 1)[:, None]
        vox = self.frustum_to_voxels(frustum, batch["lidar2cam"],
                                     batch["cam2img"])
        bev = self._collapse(vox)
        head_preds = self.dense_head(self.backbone_2d(bev))
        boxes, cls = self.dense_head.decode_boxes(head_preds)
        return dict(head_preds=head_preds, batch_box_preds=boxes,
                    batch_cls_preds=cls,
                    depth_logits=logits.permute(0, 2, 3, 1))

    def _collapse(self, vox):
        """Conv2DCollapse: (B, Y, X, Z, C) → Z-major, then C channels → 1 × 1
        conv (applied on the channels-last map), batch norm, ReLU →
        (B, bev_features, Y, X)."""
        b, y, x = vox.shape[:3]
        w = self.collapse.conv.weight
        flat = F.linear(vox.reshape(b, y, x, -1), w.reshape(w.shape[:2]))
        return F.relu(batch_norm_2d(self.collapse.bn,
                                    flat.permute(0, 3, 1, 2)))

    def depth_targets(self, depth_maps):
        """(B, H', W') depths → int64 bins, ``depth_bins`` out of range."""
        return bin_depths(depth_maps, self.depth_mode, self.depth_range[0],
                          self.depth_range[1], self.depth_bins,
                          clamp=True).long()

    def foreground(self, gt_boxes2d, h, w):
        """(B, H', W') bool: feature pixels inside (edges included) any
        valid 2D gt box scaled to the feature size."""
        boxes = gt_boxes2d / self.downsample
        valid = (boxes[..., 2:] > boxes[..., :2]).any(-1)
        uu = torch.arange(w, dtype=torch.float32,
                          device=boxes.device)[None, None, :, None]
        vv = torch.arange(h, dtype=torch.float32,
                          device=boxes.device)[None, :, None, None]
        bx = boxes[:, None, None]
        inside = ((uu >= bx[..., 0]) & (uu <= bx[..., 2])
                  & (vv >= bx[..., 1]) & (vv <= bx[..., 3])
                  & valid[:, None, None])
        return inside.any(-1)

    def ddn_loss(self, depth_logits, depth_maps, gt_boxes2d):
        """Focal (γ = 2) cross entropy on the depth bins, weighted
        ``fg_weight`` inside the 2D gt boxes and ``bg_weight`` outside,
        over ``fg_weight · |fg| + bg_weight · |bg|`` (at least 1), times
        ``ddn_weight`` (pcdet ``ddn_loss.py`` + ``balancer.py``)."""
        _, h, w, _ = depth_logits.shape
        tgt = self.depth_targets(depth_maps)[..., None]
        logp = torch.log_softmax(depth_logits, dim=-1)
        p_t = torch.softmax(depth_logits, dim=-1).gather(-1, tgt)[..., 0]
        ce = -logp.gather(-1, tgt)[..., 0]
        focal = ((1 - p_t) ** 2.0) * ce
        fg = self.foreground(gt_boxes2d, h, w)
        w_map = torch.where(fg, self.fg_weight, self.bg_weight)
        norm = (self.fg_weight * fg.sum() + self.bg_weight * (~fg).sum())
        return ((focal * w_map).sum() / torch.clamp(norm, min=1.0)
                * self.ddn_weight)

    def loss(self, out, batch):
        """The anchor head's terms + ``ddn_loss`` (pcdet
        ``caddn.py:get_training_loss``); one process only."""
        n = process_count()
        if n > 1:
            raise NotImplementedError(
                f"CaDDN under {n} processes: ddn_loss's normaliser counts "
                "one process's pixels; train CaDDN in one process")
        losses = self.dense_head.loss(
            out["head_preds"], self.dense_head.targets(batch["gt_boxes"]))
        losses["ddn_loss"] = self.ddn_loss(
            out["depth_logits"], batch["depth_maps"], batch["gt_boxes2d"])
        return total(losses)
