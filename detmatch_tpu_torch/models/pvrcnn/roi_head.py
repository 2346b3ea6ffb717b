"""PVRCNNHead, eval path (counterpart of
``detmatch_tpu/models/pvrcnn/roi_head.py``; pcdet ``pvrcnn_head.py``):
proposal NMS, RoI-grid pooling on ball query, second-stage refinement
and the box decode.

Invalid proposal slots are zero boxes (pcdet zero-inits its
NMS_POST_MAXSIZE buffer), and their grid points are queried like any
other.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core import geometry, nms as nms_mod
from ...core.coders import ResidualCoder
from ...ops.cuda import KERNELS
from ...ops.cuda.ball_query import sort_points_by_y
from ..layers import bn_pairs, mlp, pointwise
from .vsa import StackSAModuleMSG


def proposal_layer(batch_box_preds, batch_cls_preds, nms_pre, nms_post,
                   nms_thresh):
    """Class-agnostic NMS over decoded dense-head boxes.

    Args:
        batch_box_preds: (B, A, 7); batch_cls_preds: (B, A, C) logits.
    Returns:
        dict(rois (B, nms_post, 7), roi_scores, roi_labels (1-based int32),
        roi_scores_full (B, nms_post, C), roi_valid); invalid slots zero.
    """
    out = {k: [] for k in ("rois", "roi_scores", "roi_labels",
                           "roi_scores_full", "roi_valid")}
    for boxes, cls in zip(batch_box_preds, batch_cls_preds):
        scores, labels = cls.max(dim=-1)
        k = min(nms_pre, scores.shape[0])
        # stable descending sort = lax.top_k order (ties: lower index)
        top_scores, top_idx = torch.sort(scores, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:k], top_idx[:k]
        idx, valid = nms_mod.nms_bev(boxes[top_idx], top_scores, nms_thresh,
                                     nms_post)
        sel = top_idx[idx.long()]
        out["rois"].append(torch.where(valid[:, None], boxes[sel], 0.0))
        out["roi_scores"].append(torch.where(valid, scores[sel], 0.0))
        out["roi_labels"].append(torch.where(
            valid, labels[sel].to(torch.int32) + 1, 0))
        out["roi_scores_full"].append(torch.where(valid[:, None], cls[sel],
                                                  0.0))
        out["roi_valid"].append(valid)
    return {k: torch.stack(v) for k, v in out.items()}


def roi_grid_points(rois, grid_size):
    """(B, N, 7) rois → (B, N*G^3, 3) global grid points, x-major."""
    b, n = rois.shape[:2]
    g = grid_size
    idx = np.stack(np.meshgrid(np.arange(g), np.arange(g), np.arange(g),
                               indexing="ij"), axis=-1).reshape(-1, 3)
    dense_idx = torch.as_tensor(idx, dtype=torch.float32, device=rois.device)
    sizes = rois[..., 3:6][:, :, None, :]
    local = (dense_idx + 0.5) / g * sizes - sizes / 2
    rot = geometry.rotate_points_z(local.reshape(b * n, -1, 3),
                                   rois[..., 6].reshape(-1))
    return (rot.reshape(b, n, -1, 3) + rois[..., None, 0:3]).reshape(b, -1,
                                                                     3)


def decode_roi_boxes(rois, rcnn_reg):
    """Refined boxes: decode against the RoI at the origin (heading kept,
    so the decode already adds the RoI yaw), rotate, translate."""
    local_roi = torch.cat([torch.zeros_like(rois[..., 0:3]), rois[..., 3:7]],
                          dim=-1)
    dec = ResidualCoder().decode(rcnn_reg, local_roi)
    b, n = rois.shape[:2]
    rot = geometry.rotate_points_z(dec[..., 0:3].reshape(b * n, 1, 3),
                                   rois[..., 6].reshape(-1)).reshape(b, n, 3)
    return torch.cat([rot + rois[..., 0:3], dec[..., 3:]], dim=-1)


def _fc_layers(cin, channels, dropout_after):
    """pcdet fc stacks: (Conv1d, BatchNorm1d, ReLU) per layer, Dropout
    after the layers ``dropout_after`` selects."""
    layers = []
    for k, c in enumerate(channels):
        layers += [nn.Conv1d(cin, c, 1, bias=False), nn.BatchNorm1d(c),
                   nn.ReLU()]
        if dropout_after(k):
            layers.append(nn.Dropout(0.3))
        cin = c
    return layers, cin


class PVRCNNHead(nn.Module):
    """``target_cfg`` (RoI sampling) is accepted so the JAX configs load
    unchanged; it belongs to the training slice, not ported yet."""

    def __init__(self, input_channels, num_classes=3, grid_size=6,
                 shared_fc=(256, 256), cls_fc=(256, 256), reg_fc=(256, 256),
                 pool_radii=(0.8, 1.6), pool_nsamples=(16, 16),
                 pool_mlps=((64, 64), (64, 64)), target_cfg=None):
        super().__init__()
        self.grid_size = grid_size
        self.roi_grid_pool_layer = StackSAModuleMSG(
            pool_radii, pool_nsamples, pool_mlps, input_channels)
        c = self.roi_grid_pool_layer.out_channels * grid_size ** 3
        layers, c = _fc_layers(c, shared_fc,
                               lambda k: k != len(shared_fc) - 1)
        self.shared_fc_layer = nn.Sequential(*layers)
        for name, fcs, out in (("cls_layers", cls_fc, 1),
                               ("reg_layers", reg_fc, 7)):
            layers, cin = _fc_layers(c, fcs, lambda k: k == 0)
            layers.append(nn.Conv1d(cin, out, 1, bias=True))
            setattr(self, name, nn.Sequential(*layers))
        nn.init.normal_(self.reg_layers[-1].weight, std=0.001)

    def forward(self, rois, keypoints, kp_valid, point_features,
                point_cls_scores, ops=KERNELS):
        """Second-stage refinement.

        Args:
            rois (B, N, 7); keypoints (B, M, 3); kp_valid (B, M);
            point_features (B, M, C); point_cls_scores (B, M) sigmoid.
        Returns:
            (rcnn_cls (B, N, 1), rcnn_reg (B, N, 7)).
        """
        b, n = rois.shape[:2]
        pool = self.roi_grid_pool_layer
        pf = point_features * point_cls_scores[..., None]
        grid = roi_grid_points(rois, self.grid_size)
        grid_valid = torch.ones(grid.shape[:2], dtype=torch.bool,
                                device=grid.device)
        kp_s, kv_s, kperm = sort_points_by_y(keypoints, kp_valid)
        outs = []
        for g, (r, ns) in enumerate(zip(pool.radii, pool.nsamples)):
            idx, cnt = ops.ball_query_batched(grid, grid_valid, kp_s, kv_s,
                                              r, ns, point_perm=kperm)
            outs.append(pool.pool(g, grid, keypoints, pf, idx, cnt, ns))
        pooled = torch.cat(outs, dim=-1)  # (B, N*G^3, C)
        # pcdet flattens (C, G^3), channel-major
        c = pooled.shape[-1]
        x = pooled.reshape(b, n, self.grid_size ** 3, c).transpose(2, 3)
        shared = mlp(bn_pairs(self.shared_fc_layer), x.reshape(b, n, -1))
        return tuple(pointwise(seq[-1], mlp(bn_pairs(seq), shared))
                     for seq in (self.cls_layers, self.reg_layers))

    decode_boxes = staticmethod(decode_roi_boxes)
