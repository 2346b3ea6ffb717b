"""PVRCNNHead (counterpart of ``detmatch_tpu/models/pvrcnn/roi_head.py``;
pcdet ``pvrcnn_head.py``, ``roi_head_template.py`` and
``proposal_target_layer.py``): proposal NMS, RoI-grid pooling on ball
query, second-stage refinement and the box decode; for training the RoI
sampling and target assignment, dropout, and the RoI losses.

Invalid proposal slots are zero boxes (pcdet zero-inits its
NMS_POST_MAXSIZE buffer), and their grid points are queried like any
other; they also act as easy-background candidates in RoI sampling.

RoI sampling draws from a ``torch.Generator`` (``_pick``): it cannot give
``jax.random``'s numbers, so the tests hand the JAX package's picks to
the port and compare everything that follows from them. Under several
processes the picks and the dropout masks are drawn for every global
sample, in global order, and each process keeps its own; the loss
denominators are global (``parallel``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core import geometry, iou as iou_mod, losses, nms as nms_mod
from ...core.coders import ResidualCoder
from ...ops.cuda import KERNELS
from ...ops.cuda.ball_query import pack_table, sort_points_by_y
from ...parallel import for_each_global_row, global_sum
from ..layers import dropout, masked_bn, pointwise
from .vsa import StackSAModuleMSG


def proposal_layer(batch_box_preds, batch_cls_preds, nms_pre, nms_post,
                   nms_thresh):
    """Class-agnostic NMS over decoded dense-head boxes.

    Args:
        batch_box_preds: (B, A, 7); batch_cls_preds: (B, A, C) logits.
    Returns:
        dict(rois (B, nms_post, 7), roi_scores, roi_labels (1-based int32),
        roi_scores_full (B, nms_post, C), roi_valid); invalid slots zero.
        rois and roi_scores carry no gradient; roi_scores_full does (a
        DetMatch change, ``roi_head_template.py:98-104``).
    """
    out = {k: [] for k in ("rois", "roi_scores", "roi_labels",
                           "roi_scores_full", "roi_valid")}
    for boxes, cls in zip(batch_box_preds.detach(), batch_cls_preds):
        scores, labels = cls.detach().max(dim=-1)
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


def default_target_cfg():
    return dict(roi_per_image=128, fg_ratio=0.5, reg_fg_thresh=0.55,
                cls_fg_thresh=0.75, cls_bg_thresh=0.25,
                cls_bg_thresh_lo=0.1, hard_bg_ratio=0.8)


def _pick(generator, cand_mask, n_slots, with_replacement):
    """Random picks from a masked candidate set, static shape.

    Returns (idx (n_slots,) int64, avail () = candidate count). Without
    replacement: candidates in random order, the first n_slots
    (meaningless past ``avail``). With replacement: uniform draws over the
    candidates.
    """
    n = cand_mask.shape[0]
    dev = cand_mask.device
    avail = cand_mask.sum()
    if with_replacement:
        order = torch.argsort((~cand_mask).to(torch.uint8), stable=True)
        top = torch.clamp(avail, min=1)
        u = torch.rand(n_slots, generator=generator, device=dev)
        draws = torch.minimum((u * top).to(torch.int64), top - 1)
        return order[draws], avail
    r = torch.rand(n, generator=generator, device=dev)
    order = torch.argsort(torch.where(cand_mask, r, 2.0), stable=True)
    return order[:n_slots], avail


def sample_rois_single(generator, rois, roi_labels, roi_scores, roi_full,
                       gt_boxes, cfg):
    """pcdet ProposalTargetLayer (sample_rois_for_rcnn + subsample_rois)
    for one sample, with a static ``roi_per_image`` output: same-class 3D
    IoU, fg picks without replacement (repeated draws past the fg count),
    hard and easy bg with replacement, roi_iou soft class labels. Its
    draws depend on the shapes only (``parallel.for_each_global_row``)."""
    gt_cls = gt_boxes[:, 7].to(torch.int64)
    gt_valid = gt_cls > 0
    ious = iou_mod.iou3d(rois, gt_boxes[:, :7])  # (R, G)
    same = roi_labels[:, None].to(torch.int64) == gt_cls[None, :]
    ious = torch.where(same & gt_valid[None, :], ious, 0.0)
    max_ov = ious.amax(dim=1)
    gt_assign = torch.argmax(ious, dim=1)

    fg_mask = max_ov >= min(cfg["reg_fg_thresh"], cfg["cls_fg_thresh"])
    easy_bg = max_ov < cfg["cls_bg_thresh_lo"]
    hard_bg = (max_ov < cfg["reg_fg_thresh"]) & (
        max_ov >= cfg["cls_bg_thresh_lo"])

    n_sample = cfg["roi_per_image"]
    fg_cap = int(np.round(cfg["fg_ratio"] * n_sample))
    fg_idx, n_fg = _pick(generator, fg_mask, n_sample, False)
    fg_rep_idx, _ = _pick(generator, fg_mask, n_sample, True)
    hard_idx, n_hard = _pick(generator, hard_bg, n_sample, True)
    easy_idx, n_easy = _pick(generator, easy_bg, n_sample, True)
    n_bg = n_hard + n_easy

    # if there is no bg at all but some fg: every slot is fg
    only_fg = (n_fg > 0) & (n_bg == 0)
    fg_take = torch.where(only_fg, n_sample, torch.clamp(n_fg, max=fg_cap))
    bg_needed = n_sample - fg_take
    hard_take = torch.where(
        (n_hard > 0) & (n_easy > 0),
        torch.minimum((bg_needed.to(torch.float32) * cfg["hard_bg_ratio"]
                       ).to(torch.int64), n_hard),
        torch.where(n_hard > 0, bg_needed, 0))

    slots = torch.arange(n_sample, device=rois.device)
    is_fg_slot = slots < fg_take
    is_hard_slot = (slots >= fg_take) & (slots < fg_take + hard_take)
    # fewer proposals than slots: index past the end clamps, as JAX's
    # gather does
    fg_sel = torch.where(slots < n_fg,
                         fg_idx[torch.clamp(slots, max=len(fg_idx) - 1)],
                         fg_rep_idx)
    sel = torch.where(is_fg_slot, fg_sel,
                      torch.where(is_hard_slot, hard_idx, easy_idx))
    slot_valid = (n_fg + n_bg) > 0
    sel = torch.where(slot_valid, sel, 0)

    iou_sel = max_ov[sel]
    fg_m = iou_sel > cfg["cls_fg_thresh"]
    bg_m = iou_sel < cfg["cls_bg_thresh"]
    soft = torch.where(
        fg_m, 1.0, torch.where(
            ~fg_m & ~bg_m, (iou_sel - cfg["cls_bg_thresh"])
            / (cfg["cls_fg_thresh"] - cfg["cls_bg_thresh"]), 0.0))
    return dict(
        rois=rois[sel], roi_labels=roi_labels[sel],
        roi_scores=roi_scores[sel], roi_scores_full=roi_full[sel],
        roi_ious=iou_sel, gt_of_rois=gt_boxes[gt_assign[sel]],
        reg_valid_mask=(iou_sel > cfg["reg_fg_thresh"]) & slot_valid,
        rcnn_cls_labels=torch.where(slot_valid, soft, -1.0))


def canonical_transform(targets):
    """gt_of_rois → the RoI-canonical frame, heading flipped into
    [-pi/2, pi/2] (``roi_head_template.py:109-135``)."""
    rois, gt = targets["rois"], targets["gt_of_rois"]
    roi_ry = rois[..., 6] % (2 * np.pi)
    b, n = rois.shape[:2]
    local = geometry.rotate_points_z(
        (gt[..., 0:3] - rois[..., 0:3]).reshape(-1, 1, 3),
        -roi_ry.reshape(-1)).reshape(b, n, 3)
    heading = (gt[..., 6] - roi_ry) % (2 * np.pi)
    opposite = (heading > np.pi * 0.5) & (heading < np.pi * 1.5)
    heading = torch.where(opposite, (heading + np.pi) % (2 * np.pi), heading)
    heading = torch.where(heading > np.pi, heading - 2 * np.pi, heading)
    heading = torch.clamp(heading, -np.pi / 2, np.pi / 2)
    return torch.cat([local, gt[..., 3:6], heading[..., None]], dim=-1)


def assign_roi_targets(generator, proposals, gt_boxes, cfg=None,
                       row_groups=1):
    """RoI sampling and target assignment over the batch (samples in
    global order, each drawing from ``generator``; the picks of another
    process's samples are drawn and dropped, ``row_groups`` as
    ``parallel.for_each_global_row``); no gradient flows out."""
    cfg = cfg or default_target_cfg()
    rois = proposals["rois"]
    with torch.no_grad():
        per = for_each_global_row(rois.shape[0], lambda i: sample_rois_single(
            generator, rois[i], proposals["roi_labels"][i],
            proposals["roi_scores"][i], proposals["roi_scores_full"][i],
            gt_boxes[i], cfg), row_groups)
        targets = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        targets["gt_of_rois_src"] = targets["gt_of_rois"]
        targets["gt_of_rois_ct"] = canonical_transform(targets)
    return targets


def second_stage_rois(proposals, gt_boxes, train, generator,
                      target_cfg=None, row_groups=1):
    """The RoIs a two-stage head refines: in train mode the sampled RoIs
    of :func:`assign_roi_targets` (``roi_targets`` holds their targets),
    else the proposals themselves. Returns the forward's ``rois``,
    ``roi_labels``, ``roi_scores_full`` (and ``roi_scores`` or
    ``roi_targets``)."""
    if train:
        t = assign_roi_targets(generator, proposals, gt_boxes, target_cfg,
                               row_groups)
        return dict(roi_targets=t, rois=t["rois"], roi_labels=t["roi_labels"],
                    roi_scores_full=t["roi_scores_full"])
    return dict(rois=proposals["rois"], roi_labels=proposals["roi_labels"],
                roi_scores=proposals["roi_scores"],
                roi_scores_full=proposals["roi_scores_full"])


def roi_head_loss_terms(rcnn_cls, rcnn_reg, targets):
    """Per-sample (numerator, denominator) pairs of the RoI losses (all
    weights 1, as the JAX defaults)."""
    cls_labels = targets["rcnn_cls_labels"]
    cls_valid = (cls_labels >= 0).to(torch.float32)
    p = torch.sigmoid(rcnn_cls[..., 0])
    eps = 1e-7
    bce = -(cls_labels * torch.log(torch.clamp(p, eps, 1.0))
            + (1 - cls_labels) * torch.log(torch.clamp(1 - p, eps, 1.0)))
    cls_numer = (bce * cls_valid).sum(dim=1)
    cls_denom = cls_valid.sum(dim=1)

    fg = targets["reg_valid_mask"].to(torch.float32)
    rois = targets["rois"]
    rois_anchor = torch.cat([torch.zeros_like(rois[..., 0:3]),
                             rois[..., 3:6], torch.zeros_like(rois[..., 6:7])],
                            dim=-1)
    reg_targets = ResidualCoder().encode(targets["gt_of_rois_ct"][..., :7],
                                         rois_anchor)
    reg_loss = losses.weighted_smooth_l1(rcnn_reg, reg_targets,
                                         code_weights=(1.0,) * 7)
    reg_numer = (reg_loss.sum(dim=-1) * fg).sum(dim=1)

    # the corner loss decodes the foreground RoIs only, as pcdet's
    # ``get_box_reg_layer_loss`` does (it decodes ``rcnn_reg[fg_mask]``):
    # a background RoI's regression takes no loss, and a size channel past
    # log(FLT_MAX) ~ 88.72 decodes to an infinite box whose masked corner
    # term is 0 * inf = NaN (JAX's ``roi_head.py:274-280`` multiplies the
    # mask in after the decode)
    decoded = decode_roi_boxes(rois, torch.where(
        targets["reg_valid_mask"][..., None], rcnn_reg, 0.0))
    b, n = decoded.shape[:2]
    corner = losses.corner_loss_lidar(
        decoded.reshape(-1, 7),
        targets["gt_of_rois_src"][..., :7].reshape(-1, 7))
    corner_numer = (corner.reshape(b, n) * fg).sum(dim=1)
    fg_denom = fg.sum(dim=1)
    return dict(rcnn_loss_cls=(cls_numer, cls_denom),
                rcnn_loss_reg=(reg_numer, fg_denom),
                rcnn_loss_corner=(corner_numer, fg_denom))


def roi_head_loss(rcnn_cls, rcnn_reg, targets):
    """BCE on the roi_iou soft labels + smooth-L1 reg + corner loss, each
    normalised over the global batch (``roi_head_template.py:140-230``)."""
    terms = roi_head_loss_terms(rcnn_cls, rcnn_reg, targets)
    denoms = global_sum(torch.stack([d.sum() for _, d in terms.values()]))
    return {k: numer.sum() / torch.clamp(den, min=1.0)
            for (k, (numer, _)), den in zip(terms.items(), denoms)}


def _fc_layers(cin, channels, dropout_after, dp_ratio, eps=1e-5):
    """pcdet fc stacks: (Conv1d, BatchNorm1d, ReLU) per layer, Dropout
    after the layers ``dropout_after`` selects; ``eps`` the batch norm's
    (the zoo's heads take JAX's ``MaskedBatchNorm`` default, 1e-3)."""
    layers = []
    for k, c in enumerate(channels):
        layers += [nn.Conv1d(cin, c, 1, bias=False),
                   nn.BatchNorm1d(c, eps=eps, momentum=0.01), nn.ReLU()]
        if dropout_after(k):
            layers.append(nn.Dropout(dp_ratio))
        cin = c
    return layers, cin


def _apply_fc(seq, x, generator, dtype=None, row_groups=1):
    """A pcdet fc stack over the last axis of (B, N, C) ``x``: batch norm
    over all B*N rows, dropout (train mode only) with masks from
    ``generator`` (``row_groups`` as ``layers.dropout``'s). Its layers run
    in ``dtype`` but a closing output layer, which computes in float32
    (JAX's ``{cls,reg}_out`` have no dtype)."""
    last = len(seq) - 1
    for i, layer in enumerate(seq):
        if isinstance(layer, nn.Conv1d):
            x = pointwise(layer, x, None if i == last else dtype)
        elif isinstance(layer, nn.BatchNorm1d):
            x = masked_bn(layer, x)
        elif isinstance(layer, nn.ReLU):
            x = torch.relu(x)
        elif isinstance(layer, nn.Dropout) and layer.training:
            x = dropout(x, layer.p, generator, row_groups)
    return x


class PVRCNNHead(nn.Module):
    """``target_cfg`` sets the RoI sampling (``default_target_cfg``);
    ``dp_ratio`` the dropout of the fc stacks (train mode only);
    ``dtype`` (bfloat16) the compute dtype of the RoI-grid pool's MLPs and
    of the fc stacks (JAX's ``PVRCNNHead(dtype=...)``): the pooled
    features stay in it, the two outputs are float32."""

    def __init__(self, input_channels, num_classes=3, grid_size=6,
                 shared_fc=(256, 256), cls_fc=(256, 256), reg_fc=(256, 256),
                 dp_ratio=0.3, pool_radii=(0.8, 1.6), pool_nsamples=(16, 16),
                 pool_mlps=((64, 64), (64, 64)), target_cfg=None,
                 dtype=None):
        super().__init__()
        self.grid_size = grid_size
        self.dtype = dtype
        self.target_cfg = dict(target_cfg or default_target_cfg())
        self.roi_grid_pool_layer = StackSAModuleMSG(
            pool_radii, pool_nsamples, pool_mlps, input_channels, dtype)
        c = self.roi_grid_pool_layer.out_channels * grid_size ** 3
        layers, c = _fc_layers(c, shared_fc,
                               lambda k: k != len(shared_fc) - 1, dp_ratio)
        self.shared_fc_layer = nn.Sequential(*layers)
        for name, fcs, out in (("cls_layers", cls_fc, 1),
                               ("reg_layers", reg_fc, 7)):
            layers, cin = _fc_layers(c, fcs, lambda k: k == 0, dp_ratio)
            layers.append(nn.Conv1d(cin, out, 1, bias=True))
            setattr(self, name, nn.Sequential(*layers))

    def init_explicit(self):
        """JAX's N(0, 0.001) weights of the box regressor's output
        layer (the class output keeps flax's LeCun default)."""
        nn.init.normal_(self.reg_layers[-1].weight, std=0.001)

    def forward(self, rois, keypoints, kp_valid, point_features,
                point_cls_scores, ops=KERNELS, generator=None,
                row_groups=1):
        """Second-stage refinement.

        Args:
            rois (B, N, 7); keypoints (B, M, 3); kp_valid (B, M);
            point_features (B, M, C); point_cls_scores (B, M) sigmoid;
            generator: the dropout masks' source in train mode;
            row_groups: the batch's parts (``parallel.global_rows``).
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
        table = pack_table(kp_s, kv_s, kperm)
        outs = []
        for g, (r, ns) in enumerate(zip(pool.radii, pool.nsamples)):
            idx, cnt = ops.ball_query_batched(grid, grid_valid, kp_s, kv_s,
                                              r, ns, point_perm=kperm,
                                              table=table)
            outs.append(pool.pool(g, grid, keypoints, pf, idx, cnt, ns))
        pooled = torch.cat(outs, dim=-1)  # (B, N*G^3, C)
        # pcdet flattens (C, G^3), channel-major
        c = pooled.shape[-1]
        x = pooled.reshape(b, n, self.grid_size ** 3, c).transpose(2, 3)
        shared = _apply_fc(self.shared_fc_layer, x.reshape(b, n, -1),
                           generator, self.dtype, row_groups)
        return tuple(_apply_fc(seq, shared, generator, self.dtype,
                               row_groups)
                     for seq in (self.cls_layers, self.reg_layers))

    decode_boxes = staticmethod(decode_roi_boxes)
    loss = staticmethod(roi_head_loss)
