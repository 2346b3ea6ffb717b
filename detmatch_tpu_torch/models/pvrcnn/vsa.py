"""VoxelSetAbstraction (counterpart of ``detmatch_tpu/models/pvrcnn/vsa.py``;
pcdet ``voxel_set_abstraction.py``).

FPS picks the keypoints from the raw points, then per-keypoint features
come from bilinear BEV interpolation, set abstraction over the raw points
and over the voxel centers of x_conv1..4 (two radius groups each), and a
Linear+BN+ReLU fusion to 128 channels. FPS and every ball query go
through the given :class:`~detmatch_tpu_torch.ops.cuda.Ops`.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import pointnet
from ...ops.cuda import KERNELS
from ...ops.cuda.ball_query import pack_table, sort_points_by_y
from ...ops.voxelize import INVALID_KEY, delinearize
from ..layers import bn_pairs, masked_bn, mlp, pointwise

DEFAULT_SA_CFG = {
    "raw_points": dict(radii=(0.4, 0.8), nsamples=(16, 16),
                       mlps=((16, 16), (16, 16))),
    "x_conv1": dict(radii=(0.4, 0.8), nsamples=(16, 16),
                    mlps=((16, 16), (16, 16))),
    "x_conv2": dict(radii=(0.8, 1.2), nsamples=(16, 32),
                    mlps=((32, 32), (32, 32))),
    "x_conv3": dict(radii=(1.2, 2.4), nsamples=(16, 32),
                    mlps=((64, 64), (64, 64))),
    "x_conv4": dict(radii=(2.4, 4.8), nsamples=(16, 32),
                    mlps=((64, 64), (64, 64))),
}


def voxel_centers(keys, spatial_shape, stride, voxel_size,
                  point_cloud_range):
    """Sparse keys → (..., 3) xyz voxel centers."""
    zyx = delinearize(torch.where(keys == INVALID_KEY, 0, keys),
                      spatial_shape)
    xyz = zyx.flip(-1).to(torch.float32)
    vs = torch.tensor(voxel_size, dtype=torch.float32,
                      device=keys.device) * stride
    origin = torch.tensor(point_cloud_range[:3], dtype=torch.float32,
                          device=keys.device)
    return (xyz + 0.5) * vs + origin


def bilinear_interpolate_batched(im, x, y):
    """im (B, H, W, C); x, y (B, N) continuous pixel coords → (B, N, C),
    clamped corners (pcdet ``bilinear_interpolate_torch``)."""
    b, h, w, c = im.shape
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    flat = im.reshape(b, h * w, c)

    def g(yy, xx):
        return pointnet.gather_rows(flat, yy * w + xx)

    x0f, x1f = x0.to(x.dtype), x1.to(x.dtype)
    y0f, y1f = y0.to(y.dtype), y1.to(y.dtype)
    wa = (x1f - x) * (y1f - y)
    wb = (x1f - x) * (y - y0f)
    wc = (x - x0f) * (y1f - y)
    wd = (x - x0f) * (y - y0f)
    return (g(y0, x0) * wa[..., None] + g(y1, x0) * wb[..., None]
            + g(y0, x1) * wc[..., None] + g(y1, x1) * wd[..., None])


def group_mlp(layers, centers, xyz, feats, idx, slot_valid):
    """Shared MLP over grouped neighbours (batch norm over the valid slots
    only in train mode).

    The first (bias-free) layer is linear, so for neighbour n of center
    m: ``W [p_n - c_m | f_n] = W [p_n | f_n] - W [c_m | 0]`` — the table
    is transformed once per point and once per center, and the grouped
    tensor gathers the transformed table.

    Args:
        layers: list of (conv, bn) modules; centers (B, M, 3);
            xyz (B, N, 3); feats (B, N, C) or None; idx (B, M, ns);
            slot_valid (B, M, ns).
    Returns:
        (x (B, M, ns, C'), empty (C',)) — ``empty`` is the MLP stack of a
        zero input, the eval output of an empty ball; in train mode an
        empty ball pools to zero and ``empty`` is None (no batch
        statistics are taken of it).
    """
    conv0 = layers[0][0]
    w0 = conv0.weight.reshape(conv0.weight.shape[0], -1)
    table = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
    pre = torch.nn.functional.linear(table, w0)
    cen = torch.nn.functional.linear(centers, w0[:, :3])
    z = pointnet.gather_rows(pre, idx) - cen[:, :, None, :]
    x = torch.where(slot_valid[..., None], z, 0.0)
    train = layers[0][1].training
    e = None if train else x.new_zeros(w0.shape[0])
    for i, (conv, bn) in enumerate(layers):
        if i > 0:
            x = pointwise(conv, x)
            if e is not None:
                e = pointwise(conv, e)
        x = torch.relu(masked_bn(bn, x, slot_valid))
        if e is not None:
            e = torch.relu(masked_bn(bn, e))
    return x, e


class StackSAModuleMSG(nn.Module):
    """Multi-radius set abstraction with pcdet's parameter layout
    (``mlps.{g}.{3k}`` 1x1 Conv2d, ``mlps.{g}.{3k+1}`` BatchNorm2d with the
    torch-default eps 1e-5 and the JAX model's momentum 0.01)."""

    def __init__(self, radii, nsamples, mlps, in_channels):
        super().__init__()
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.mlps = nn.ModuleList()
        for spec in mlps:
            layers, cin = [], in_channels + 3
            for cout in spec:
                layers += [nn.Conv2d(cin, cout, 1, bias=False),
                           nn.BatchNorm2d(cout, momentum=0.01), nn.ReLU()]
                cin = cout
            self.mlps.append(nn.Sequential(*layers))
        self.out_channels = sum(spec[-1] for spec in mlps)

    def pool(self, g, centers, xyz, feats, idx, cnt, nsample):
        """One radius group: grouped MLP, masked max-pool, and the
        empty-ball fill (eval: the MLP stack of zero; train: zero)
        → (B, M, C')."""
        slots = torch.arange(nsample, device=idx.device)
        slot_valid = slots < cnt[..., None]
        x, empty = group_mlp(bn_pairs(self.mlps[g]), centers, xyz, feats,
                             idx, slot_valid)
        x = torch.where(slot_valid[..., None], x, -pointnet.BIG_DIST)
        pooled = x.amax(dim=2)  # ties share the gradient, as jnp.max
        return torch.where((cnt > 0)[..., None], pooled,
                           0.0 if empty is None else empty)

    def forward(self, centers, centers_valid, xyz, xyz_valid, feats,
                ops=KERNELS):
        """Queries every radius against one y-sort of the table."""
        xyz_s, xv_s, perm = sort_points_by_y(xyz, xyz_valid)
        table = pack_table(xyz_s, xv_s, perm)
        outs = []
        for g, (r, ns) in enumerate(zip(self.radii, self.nsamples)):
            idx, cnt = ops.ball_query_batched(centers, centers_valid, xyz_s,
                                              xv_s, r, ns, point_perm=perm,
                                              table=table)
            outs.append(self.pool(g, centers, xyz, feats, idx, cnt, ns))
        return torch.cat(outs, dim=-1)


class VoxelSetAbstraction(nn.Module):
    def __init__(self, num_bev_features, level_channels,
                 num_rawpoint_features=1, num_keypoints=2048,
                 num_out_features=128, voxel_size=(0.05, 0.05, 0.1),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1), sa_cfg=None):
        super().__init__()
        sa_cfg = sa_cfg or DEFAULT_SA_CFG
        self.num_keypoints = num_keypoints
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.SA_rawpoints = StackSAModuleMSG(in_channels=num_rawpoint_features,
                                             **sa_cfg["raw_points"])
        self.SA_layers = nn.ModuleList(
            StackSAModuleMSG(in_channels=c, **sa_cfg[f"x_conv{i + 1}"])
            for i, c in enumerate(level_channels))
        c_in = (num_bev_features + self.SA_rawpoints.out_channels
                + sum(sa.out_channels for sa in self.SA_layers))
        self.num_point_features_before_fusion = c_in
        self.vsa_point_feature_fusion = nn.Sequential(
            nn.Linear(c_in, num_out_features, bias=False),
            nn.BatchNorm1d(num_out_features, momentum=0.01), nn.ReLU())

    def forward(self, points, points_valid, bev_features, ms_features,
                ops=KERNELS):
        """
        Args:
            points: (B, P, 4) raw points; points_valid: (B, P) bool.
            bev_features: (B, C, H, W) stride-8 HeightCompression output.
            ms_features: backbone output (x_conv1..4 levels).
        Returns:
            dict(keypoints (B, M, 3), kp_valid (B, M), point_features
            (B, M, 128), point_features_before_fusion (B, M, C_in)).
        """
        xyz = points[..., :3].contiguous()
        kp_idx = ops.fps_batched(xyz, points_valid, self.num_keypoints)
        keypoints = pointnet.gather_rows(xyz, kp_idx)
        kp_valid = points_valid.any(dim=1)[:, None].expand(
            -1, self.num_keypoints).contiguous()

        pcr = self.point_cloud_range
        x_idx = (keypoints[..., 0] - pcr[0]) / self.voxel_size[0] / 8.0
        y_idx = (keypoints[..., 1] - pcr[1]) / self.voxel_size[1] / 8.0
        feats = [bilinear_interpolate_batched(
            bev_features.permute(0, 2, 3, 1), x_idx, y_idx)]
        feats.append(self.SA_rawpoints(keypoints, kp_valid, xyz,
                                       points_valid, points[..., 3:], ops))
        for i, sa in enumerate(self.SA_layers):
            lv = ms_features[f"x_conv{i + 1}"]
            centers = voxel_centers(lv["keys"], lv["shape"], lv["stride"],
                                    self.voxel_size, pcr)
            feats.append(sa(keypoints, kp_valid, centers, lv["mask"],
                            lv["feats"], ops))
        before_fusion = torch.cat(feats, dim=-1)
        fused = mlp(bn_pairs(self.vsa_point_feature_fusion), before_fusion,
                    kp_valid)
        return dict(keypoints=keypoints, kp_valid=kp_valid,
                    point_features=fused,
                    point_features_before_fusion=before_fusion)
