"""PointPillars (counterpart of
``detmatch_tpu/models/pvrcnn/pointpillars.py``; pcdet ``pointpillar.py``,
``pillar_vfe.py`` and ``pointpillar_scatter.py``): PillarVFE (augmented
point features → Linear + BN + ReLU → max over each pillar) → dense BEV
scatter → a three-level BEV pyramid → AnchorHeadSingle with anchors at
feature-map stride 2.

The pillars are the voxelizer's (``ops.voxelize.voxelize_mean`` with a
pillar spec, z one cell): its grouped per-point view feeds the VFE, and
the batch carries the whole voxelizer dict under ``pillars``. The
pillar max is a ``scatter_reduce("amax")`` into a -1e10 fill, as JAX's
``.at[].max``.

The BEV scatter places each pillar by its key in the voxelizer's own
spatial shape (Z = 2: the grid's one z cell plus the backbone's extra
one). JAX's scatters with Z = 1 (``pointpillars.py:124-126``), which
moves pillar (y, x) to the cell of flat index 2 (y X + x) and drops the
upper half of the map.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import spconv
from ...ops.cuda import KERNELS
from ...ops.voxelize import INVALID_KEY
from ..init import init_like_jax
from ..layers import masked_bn
from .anchor_head import AnchorHeadSingle
from .bev import BaseBEVBackbone
from .pvrcnn import DEFAULT_ANCHOR_CONFIGS
from .second import check_mode, total

PILLAR_PCR = (0, -39.68, -3, 69.12, 39.68, 1)
PILLAR_VOXEL = (0.16, 0.16, 4.0)


class PFNLayer(nn.Module):
    """pcdet's ``PFNLayer`` parameters: a bias-free ``linear`` and its
    ``norm`` (BatchNorm1d, eps 1e-3)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=False)
        self.norm = nn.BatchNorm1d(cout, eps=1e-3, momentum=0.01)


class PillarVFE(nn.Module):
    """Per point [x, y, z, i, Δ pillar mean (3), Δ pillar center (2),
    |xyz|] → Linear + BN (over the contributing points) + ReLU → max
    over each pillar; pillars without points are 0."""

    def __init__(self, num_point_features=4, out_features=64,
                 voxel_size=PILLAR_VOXEL, point_cloud_range=PILLAR_PCR):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.pfn_layers = nn.ModuleList(
            [PFNLayer(num_point_features + 6, out_features)])

    def forward(self, vox):
        """``vox``: the batched voxelizer dict → (B, V, out_features)."""
        b, v = vox["keys"].shape
        pts = vox["point_feats"].reshape(-1, vox["point_feats"].shape[-1])
        base = torch.arange(b, device=pts.device)[:, None] * v
        vid = (vox["point_voxel_id"] + base).reshape(-1)
        contrib = vox["point_contrib"].reshape(-1)
        means = vox["features"].reshape(b * v, -1)
        vid_c = torch.clamp(vid, 0, b * v - 1).long()
        vs = torch.tensor(self.voxel_size, dtype=pts.dtype, device=pts.device)
        origin = torch.tensor(self.point_cloud_range[:3], dtype=pts.dtype,
                              device=pts.device)
        centers = ((vox["coords"].reshape(b * v, 3).flip(-1).to(pts.dtype)
                    + 0.5) * vs + origin)
        f = torch.cat([pts, pts[:, :3] - means[vid_c, :3],
                       pts[:, :2] - centers[vid_c, :2],
                       torch.linalg.norm(pts[:, :3], dim=-1, keepdim=True)],
                      -1)
        f = torch.where(contrib[:, None], f, 0.0)
        pfn = self.pfn_layers[0]
        x = torch.relu(masked_bn(pfn.norm, pfn.linear(f), contrib))
        sid = torch.where(contrib, vid_c, b * v)
        pooled = x.new_full((b * v + 1, x.shape[-1]), -1e10).scatter_reduce(
            0, sid[:, None].expand_as(x), x, "amax", include_self=True)
        has = (vox["keys"] != INVALID_KEY).reshape(-1, 1)
        return torch.where(has, pooled[:-1], 0.0).reshape(b, v, -1)


class PointPillars(nn.Module):
    """One-stage pillar detector (pcdet ``pointpillar.yaml`` widths).
    ``grid_size`` is the pillar grid (X, Y, 1); the forward's ``train``
    as PV-RCNN's."""

    def __init__(self, num_classes=3, point_cloud_range=PILLAR_PCR,
                 voxel_size=PILLAR_VOXEL, grid_size=(432, 496, 1),
                 max_voxels=12000, anchor_configs=DEFAULT_ANCHOR_CONFIGS,
                 num_point_features=4, layer_nums=(3, 5, 5),
                 layer_strides=(2, 2, 2), num_filters=(64, 128, 256),
                 upsample_strides=(1, 2, 4),
                 num_upsample_filters=(128, 128, 128)):
        super().__init__()
        self.ops = KERNELS  # no kernel of the table runs here
        self.max_voxels = max_voxels
        # the voxelizer's spatial shape (Z + 1, Y, X)
        self.key_shape = (grid_size[2] + 1, grid_size[1], grid_size[0])
        self.vfe = PillarVFE(num_point_features, voxel_size=voxel_size,
                             point_cloud_range=point_cloud_range)
        c = self.vfe.pfn_layers[0].linear.out_features
        self.backbone_2d = BaseBEVBackbone(
            c, layer_nums=layer_nums, layer_strides=layer_strides,
            num_filters=num_filters, upsample_strides=upsample_strides,
            num_upsample_filters=num_upsample_filters)
        # anchors on the stride-2 output of the pillar BEV pyramid
        cfgs = tuple(dict(cfg, feature_map_stride=2)
                     for cfg in anchor_configs)
        self.dense_head = AnchorHeadSingle(
            self.backbone_2d.num_bev_features, num_classes=num_classes,
            anchor_configs=cfgs, point_cloud_range=point_cloud_range,
            grid_size=grid_size)
        init_like_jax(self)

    def forward(self, batch, train=None, generator=None):
        """``batch["pillars"]``: ``voxelize_mean`` of the points with the
        pillar spec (max_voxels = this model's)."""
        check_mode(self, train, generator, needs_generator=False)
        vox = batch["pillars"]
        feats = self.vfe(vox)
        dense = spconv.to_dense_yxz(feats, vox["keys"], self.key_shape)
        bev = self.backbone_2d(dense[:, :, :, 0].permute(0, 3, 1, 2))
        head_preds = self.dense_head(bev)
        boxes, cls = self.dense_head.decode_boxes(head_preds)
        return dict(pillar_features=feats, bev_features=bev,
                    head_preds=head_preds, batch_box_preds=boxes,
                    batch_cls_preds=cls)

    def loss(self, out, batch):
        return total(self.dense_head.loss(
            out["head_preds"], self.dense_head.targets(batch["gt_boxes"])))
