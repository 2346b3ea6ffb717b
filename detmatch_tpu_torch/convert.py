"""JAX model variables → the port's state dicts: PV-RCNN (pcdet names),
the LiDAR zoo and CaDDN (``FROM_JAX``, by registry name, and the
multi-group anchor head), Faster R-CNN (mmdet names) and the SSL
detector's teacher and student.

:func:`from_jax_pvrcnn` is the exact inverse of
``tools/model_converters/import_torch_ckpt.py:convert_pvrcnn`` (pcdet
state dict → JAX ``params``/``batch_stats``), undoing each of its layout
bridges:

* Dense (in, out) → Linear (out, in) / 1x1 Conv (out, in, 1[, 1]);
* flax Conv (kh, kw, in, out) → Conv2d (out, in, kh, kw);
* ConvTranspose: flax applies the kernel unflipped, torch's is the
  gradient of a conv — mirror the spatial axes back;
* HeightCompression channel order: the JAX BEV input is (Z, C) Z-outer,
  pcdet's (C, Z) C-outer — the first BEV conv's input channels and the
  BEV rows of the VSA fusion are permuted back;
* RoI shared-fc input: JAX flattens (G^3, C), pcdet (C, G^3);
* spconv weights (K, in, out) → (kz, ky, kx, in, out).

Every bridge is linear (a transpose, a reshape, a flip or a row
permutation), so the same function also maps JAX **gradients** (a
``jax.grad`` tree shaped like ``params``) onto the port's parameters,
which is how the training tests compare the two packages' gradients.

:func:`from_jax_frcnn` is the inverse of ``convert_frcnn`` there: flax
convs (kh, kw, in, out) → (out, in, kh, kw), Dense (in, out) → Linear
(out, in), FrozenBN's {scale, bias, mean, var} → weight, bias,
running_mean, running_var, and the first shared FC's input rows from the
JAX (7, 7, C) flatten back to mmdet's (C, 7, 7).

:func:`to_jax_pvrcnn`, :func:`to_jax_frcnn` and :func:`to_jax_ssl` are the
exact inverses of ``from_jax_pvrcnn``, ``from_jax_frcnn`` and
``from_jax_ssl`` (numpy only): they carry the port's weights to the JAX
package, so that a state of the port can be replayed through JAX.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .models.pvrcnn.backbone3d import level_shapes


def _hc_perm(z, c):
    """JAX (Z-outer) BEV channel j → pcdet (C-outer) channel perm[j]."""
    return np.asarray([ci * z + zi for zi in range(z) for ci in range(c)],
                      np.int64)


def _unpermute(rows, perm):
    """``out[perm] = rows`` — inverse of the converter's ``rows[perm]``."""
    out = np.empty_like(rows)
    out[perm] = rows
    return out


class _Writer:
    """Builds a state dict from JAX leaves, undoing the layout bridges."""

    def __init__(self):
        self.sd = OrderedDict()

    def put(self, key, arr):
        self.sd[key] = torch.from_numpy(np.array(arr, order="C"))

    def bn(self, key, p, s):
        self.put(key + ".weight", p["scale"])
        self.put(key + ".bias", p["bias"])
        self.put(key + ".running_mean", s["mean"])
        self.put(key + ".running_var", s["var"])
        self.sd[key + ".num_batches_tracked"] = torch.tensor(0)

    def frozen_bn(self, key, f):
        """JAX ``FrozenBN`` constants → the port's ``FrozenBN`` buffers."""
        for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                             ("running_mean", "mean"),
                             ("running_var", "var")):
            self.put(f"{key}.{ours}", f[theirs])

    def linear(self, key, p, shape_tail=()):
        """Dense (in, out) → Linear (out, in) / 1x1 conv (out, in, 1...)."""
        k = np.asarray(p["kernel"]).T
        self.put(key + ".weight", k.reshape(k.shape + shape_tail))
        if "bias" in p:
            self.put(key + ".bias", p["bias"])

    def conv2d(self, key, p):
        self.put(key + ".weight",
                 np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            self.put(key + ".bias", p["bias"])

    def spconv(self, key, p3, s3, name, ks=(3, 3, 3)):
        """A (conv, BN) block: (K, in, out) → (kz, ky, kx, in, out)."""
        w = np.asarray(p3[name + "_w"])
        self.put(key + ".0.weight", w.reshape(ks + w.shape[1:]))
        self.bn(key + ".1", p3[name + "_bn"], s3[name + "_bn"])

    def mlp(self, key, p, s, stride=3, shape_tail=()):
        """JAX ``MLP`` / ``SAGroupMLP`` ``dense{k}`` / ``bn{k}`` →
        ``{key}.{stride*k}`` / ``{key}.{stride*k+1}``."""
        for kk in range(len([n for n in p if n.startswith("dense")])):
            self.linear(f"{key}.{stride * kk}", p[f"dense{kk}"], shape_tail)
            self.bn(f"{key}.{stride * kk + 1}", p[f"bn{kk}"], s[f"bn{kk}"])

    def fc_stack(self, key, p, s, out):
        """JAX ``MLP`` + a closing Dense ``out`` → pcdet
        ``make_fc_layers``."""
        self.mlp(key, p, s)
        n = len([k for k in p if k.startswith("dense")])
        self.linear(f"{key}.{3 * n}", out)


def _voxel_backbone(w, p3, s3):
    w.spconv("backbone_3d.conv_input", p3, s3, "conv_input")
    w.spconv("backbone_3d.conv1.0", p3, s3, "conv1_0")
    for lvl in (2, 3, 4):
        w.spconv(f"backbone_3d.conv{lvl}.0", p3, s3, f"conv{lvl}_down")
        for j in (0, 1):
            w.spconv(f"backbone_3d.conv{lvl}.{j + 1}", p3, s3,
                     f"conv{lvl}_{j}")
    w.spconv("backbone_3d.conv_out", p3, s3, "conv_out", (3, 1, 1))


def _bev(w, p2, s2, layer_nums, hc=None):
    """BaseBEVBackbone; ``hc`` the HeightCompression permutation of the
    first conv's input channels (None for a pillar BEV)."""
    for i, n_layers in enumerate(layer_nums):
        blk = p2[f"block{i}_0"]
        kernel = np.asarray(blk["conv"]["kernel"])
        if i == 0 and hc is not None:  # consumes the HeightCompression
            kernel = _unpermute(kernel.transpose(2, 0, 1, 3), hc
                                ).transpose(1, 2, 0, 3)
        w.conv2d(f"backbone_2d.blocks.{i}.1", dict(kernel=kernel))
        w.bn(f"backbone_2d.blocks.{i}.2", blk["bn"], s2[f"block{i}_0"]["bn"])
        for j in range(n_layers):
            idx = 4 + 3 * j
            w.conv2d(f"backbone_2d.blocks.{i}.{idx}",
                     p2[f"block{i}_{j + 1}"]["conv"])
            w.bn(f"backbone_2d.blocks.{i}.{idx + 1}",
                 p2[f"block{i}_{j + 1}"]["bn"],
                 s2[f"block{i}_{j + 1}"]["bn"])
        k = np.asarray(p2[f"deblock{i}"]["conv"]["kernel"])
        w.put(f"backbone_2d.deblocks.{i}.0.weight",
              k[::-1, ::-1].transpose(2, 3, 0, 1))
        w.bn(f"backbone_2d.deblocks.{i}.1", p2[f"deblock{i}"]["bn"],
             s2[f"deblock{i}"]["bn"])


def _dense_head(w, ph):
    for ours, ref in (("conv_cls", "conv_cls"), ("conv_box", "conv_box"),
                      ("conv_dir", "conv_dir_cls")):
        w.conv2d(f"dense_head.{ref}", ph[ours])


def _hc(cfg, out_channels=128):
    grid = cfg.get("grid_size", (1408, 1600, 40))
    hc_z = level_shapes((grid[2] + 1, grid[1], grid[0]))[-1][0]
    return hc_z, out_channels


def from_jax_pvrcnn(params, batch_stats, cfg):
    """(params, batch_stats) of the JAX ``PVRCNN`` → pcdet state dict.

    Args:
        params, batch_stats: nested dicts of arrays (numpy or anything
            ``np.asarray`` takes).
        cfg: the ``PVRCNN`` keyword config the variables were made for
            (``model.detector_3d`` of a config file, or ``TINY_PV_CFG``).
    Returns:
        OrderedDict of float32 tensors that ``PVRCNN(**cfg)`` loads with
        ``load_state_dict``.
    """
    w = _Writer()
    _voxel_backbone(w, params["backbone3d"], batch_stats["backbone3d"])
    hc_z, hc_c = _hc(cfg, (cfg.get("backbone3d_cfg") or {}).get(
        "out_channels", 128))
    hc = _hc_perm(hc_z, hc_c)
    _bev(w, params["backbone2d"], batch_stats["backbone2d"],
         (cfg.get("bev_cfg") or {}).get("layer_nums", (5, 5)), hc)
    _dense_head(w, params["dense_head"])

    # ---- pfe ----
    pp, sp = params["pfe"], batch_stats["pfe"]

    def sa_branch(key, name):
        for g in sorted(int(n[3:]) for n in pp[name] if n.startswith("mlp")):
            w.mlp(f"{key}.mlps.{g}", pp[name][f"mlp{g}"],
                  sp[name][f"mlp{g}"], shape_tail=(1, 1))

    sa_branch("pfe.SA_rawpoints", "sa_raw_points")
    for li in range(4):
        sa_branch(f"pfe.SA_layers.{li}", f"sa_x_conv{li + 1}")
    fusion = np.asarray(pp["fusion"]["kernel"])  # (in, out), JAX order
    n_bev = hc_z * hc_c
    fusion = np.concatenate([_unpermute(fusion[:n_bev], hc),
                             fusion[n_bev:]])
    w.linear("pfe.vsa_point_feature_fusion.0", dict(kernel=fusion))
    w.bn("pfe.vsa_point_feature_fusion.1", pp["fusion_bn"], sp["fusion_bn"])

    # ---- point_head ----
    ph, sh = params["point_head"], batch_stats["point_head"]
    n_fc = len([n for n in ph["cls_mlp"] if n.startswith("dense")])
    for kk in range(n_fc):
        p = ph["cls_mlp"][f"dense{kk}"]
        if kk == 0:
            # its input is point_features_before_fusion, whose BEV slice
            # has the same (Z, C) / (C, Z) order split as the fusion's —
            # a bridge convert_pvrcnn lacks (it copies these rows as is)
            k0 = np.asarray(p["kernel"])
            p = dict(kernel=np.concatenate([_unpermute(k0[:n_bev], hc),
                                            k0[n_bev:]]))
        w.linear(f"point_head.cls_layers.{3 * kk}", p)
        w.bn(f"point_head.cls_layers.{3 * kk + 1}", ph["cls_mlp"][f"bn{kk}"],
             sh["cls_mlp"][f"bn{kk}"])
    w.linear(f"point_head.cls_layers.{3 * n_fc}", ph["cls_out"])

    # ---- roi_head ----
    pr, sr = params["roi_head"], batch_stats["roi_head"]
    for g in sorted(int(n[8:]) for n in pr if n.startswith("pool_mlp")):
        w.mlp(f"roi_head.roi_grid_pool_layer.mlps.{g}", pr[f"pool_mlp{g}"],
              sr[f"pool_mlp{g}"], shape_tail=(1, 1))
    g3 = (cfg.get("roi_head_cfg") or {}).get("grid_size", 6) ** 3
    fc0 = np.asarray(pr["shared_fc0"]["kernel"])  # (G^3 * C, out)
    cin = fc0.shape[0] // g3
    perm = np.asarray([ci * g3 + gi for gi in range(g3) for ci in range(cin)],
                      np.int64)
    _roi_fcs(w, pr, sr, "roi_head", shared_fc0=_unpermute(fc0, perm))
    return w.sd


def _roi_fcs(w, pr, sr, key, heads=(("cls", "cls_layers"),
                                    ("reg", "reg_layers")),
             shared_fc0=None):
    """The RoI heads' fc stacks: JAX ``shared_fc{k}`` / ``shared_bn{k}``
    and per head ``{name}_fc{k}`` / ``{name}_bn{k}`` / ``{name}_out`` →
    ``shared_fc_layer`` and the heads' ``_fc_layers`` Sequentials
    (Conv1d, BN, ReLU per layer; a Dropout after the shared layers but
    the last and after each head's first)."""
    n_shared = len([n for n in pr if n.startswith("shared_fc")])
    idx = 0
    for kk in range(n_shared):
        p = (dict(kernel=shared_fc0) if kk == 0 and shared_fc0 is not None
             else pr[f"shared_fc{kk}"])
        w.linear(f"{key}.shared_fc_layer.{idx}", p, (1,))
        w.bn(f"{key}.shared_fc_layer.{idx + 1}", pr[f"shared_bn{kk}"],
             sr[f"shared_bn{kk}"])
        idx += 4 if kk < n_shared - 1 else 3
    for name, ref in heads:
        n_fc = len([n for n in pr if n.startswith(f"{name}_fc")])
        idx = 0
        for kk in range(n_fc):
            w.linear(f"{key}.{ref}.{idx}", pr[f"{name}_fc{kk}"], (1,))
            w.bn(f"{key}.{ref}.{idx + 1}", pr[f"{name}_bn{kk}"],
                 sr[f"{name}_bn{kk}"])
            idx += 4 if kk == 0 else 3  # Dropout after the first layer
        w.linear(f"{key}.{ref}.{idx}", pr[f"{name}_out"], (1,))


def _anchor_stack(w, params, batch_stats, cfg):
    """Sparse backbone, BEV and anchor head of the zoo's voxel models."""
    _voxel_backbone(w, params["backbone3d"], batch_stats["backbone3d"])
    _bev(w, params["backbone2d"], batch_stats["backbone2d"], (5, 5),
         _hc_perm(*_hc(cfg)))
    _dense_head(w, params["dense_head"])


def from_jax_second(params, batch_stats, cfg):
    """JAX ``SECOND`` / ``SECONDIoU`` variables → the port's state dict
    (``cfg`` the model's keyword config). The RoI head's fc input stays
    in JAX's (g², C) order, which the port keeps."""
    w = _Writer()
    _anchor_stack(w, params, batch_stats, cfg)
    if "roi_head" in params:
        _roi_fcs(w, params["roi_head"], batch_stats["roi_head"], "roi_head",
                 heads=(("iou", "iou_layers"),))
    return w.sd


def from_jax_voxelrcnn(params, batch_stats, cfg):
    """JAX ``VoxelRCNN`` variables → the port's state dict."""
    w = _Writer()
    _anchor_stack(w, params, batch_stats, cfg)
    pr, sr = params["roi_head"], batch_stats["roi_head"]
    for g in sorted(int(n[8:]) for n in pr if n.startswith("pool_mlp")):
        w.mlp(f"roi_head.roi_grid_pool_layers.{g}.mlps.0",
              pr[f"pool_mlp{g}"], sr[f"pool_mlp{g}"], shape_tail=(1, 1))
    _roi_fcs(w, pr, sr, "roi_head")
    return w.sd


def from_jax_parta2(params, batch_stats, cfg):
    """JAX ``PartA2`` variables → the port's state dict (UNet names
    pcdet's; dense 3D conv kernels (3, 3, 3, in, out) → (out, in, 3, 3,
    3))."""
    w = _Writer()
    p3, s3 = params["backbone3d"], batch_stats["backbone3d"]
    _anchor_stack(w, params, batch_stats, cfg)
    for k in (1, 2, 3, 4):
        for c, ours in (("c1", "conv1"), ("c2", "conv2")):
            name = f"up{k}_t_{c}"
            wt = np.asarray(p3[name + "_w"])
            w.put(f"backbone_3d.conv_up_t{k}.{ours}.weight",
                  wt.reshape((3, 3, 3) + wt.shape[1:]))
            w.bn(f"backbone_3d.conv_up_t{k}.bn{ours[-1]}", p3[name + "_bn"],
                 s3[name + "_bn"])
        w.spconv(f"backbone_3d.conv_up_m{k}", p3, s3, f"up{k}_m")
        if k > 1:
            w.spconv(f"backbone_3d.inv_conv{k}", p3, s3, f"inv{k}")
    w.spconv("backbone_3d.conv5", p3, s3, "conv5")
    ph, sh = params["point_head"], batch_stats["point_head"]
    w.fc_stack("point_head.cls_layers", ph["cls_mlp"], sh["cls_mlp"],
               ph["cls_out"])
    w.fc_stack("point_head.part_reg_layers", ph["part_mlp"], sh["part_mlp"],
               ph["part_out"])
    pr, sr = params["roi_head"], batch_stats["roi_head"]
    for tower, ours in (("part", "conv_part"), ("rpn", "conv_rpn")):
        for i in (0, 1):
            blk = f"{tower}_c{i}"
            w.put(f"roi_head.{ours}.{i}.conv.weight", np.asarray(
                pr[blk]["conv"]["kernel"]).transpose(4, 3, 0, 1, 2))
            w.bn(f"roi_head.{ours}.{i}.bn", pr[blk]["bn"], sr[blk]["bn"])
    _roi_fcs(w, pr, sr, "roi_head")
    return w.sd


def from_jax_pointpillars(params, batch_stats, cfg):
    """JAX ``PointPillars`` variables → the port's state dict."""
    w = _Writer()
    w.linear("vfe.pfn_layers.0.linear", params["vfe"]["pfn"])
    w.bn("vfe.pfn_layers.0.norm", params["vfe"]["pfn_bn"],
         batch_stats["vfe"]["pfn_bn"])
    _bev(w, params["backbone2d"], batch_stats["backbone2d"],
         cfg.get("layer_nums", (3, 5, 5)))
    _dense_head(w, params["dense_head"])
    return w.sd


def from_jax_pointrcnn(params, batch_stats, cfg):
    """JAX ``PointRCNN`` variables → the port's state dict."""
    w = _Writer()
    pb, sb = params["backbone3d"], batch_stats["backbone3d"]

    def sa(key, p, s):
        for g in sorted(int(n[3:]) for n in p if n.startswith("mlp")):
            w.mlp(f"{key}.mlps.{g}", p[f"mlp{g}"], s[f"mlp{g}"],
                  shape_tail=(1, 1))

    for lv in sorted(int(n[2:]) for n in pb if n.startswith("sa")):
        sa(f"backbone_3d.SA_modules.{lv}", pb[f"sa{lv}"], sb[f"sa{lv}"])
    for lv in sorted(int(n[2:]) for n in pb if n.startswith("fp")):
        w.mlp(f"backbone_3d.FP_modules.{lv}", pb[f"fp{lv}"], sb[f"fp{lv}"])
    ph, sh = params["point_head"], batch_stats["point_head"]
    w.fc_stack("point_head.cls_layers", ph["cls_mlp"], sh["cls_mlp"],
               ph["cls_out"])
    w.fc_stack("point_head.box_layers", ph["reg_mlp"], sh["reg_mlp"],
               ph["reg_out"])
    pr, sr = params["roi_head"], batch_stats["roi_head"]
    w.mlp("roi_head.xyz_up_layer", pr["xyz_up"], sr["xyz_up"])
    w.mlp("roi_head.merge_down_layer", pr["merge_down"], sr["merge_down"])
    for lv in sorted(int(n[2:]) for n in pr if n.startswith("sa")):
        sa(f"roi_head.SA_modules.{lv}", pr[f"sa{lv}"], sr[f"sa{lv}"])
    for name, ref in (("cls", "cls_layers"), ("reg", "reg_layers")):
        w.fc_stack(f"roi_head.{ref}", pr[f"{name}_mlp"], sr[f"{name}_mlp"],
                   pr[f"{name}_out"])
    return w.sd


def from_jax_anchor_head_multi(params, key="dense_head"):
    """JAX ``AnchorHeadMulti`` params → the port's ``AnchorHeadMulti``
    state dict (under ``key`` if given): ``shared_conv`` and
    ``rpn_heads.{i}.conv_cls / conv_box / conv_dir_cls``."""
    w = _Writer()
    pre = f"{key}." if key else ""
    w.conv2d(pre + "shared_conv", params["shared_conv"])
    for i in range(len([n for n in params if n.endswith("_cls")
                        and n.startswith("head")])):
        for ours, ref in (("cls", "conv_cls"), ("box", "conv_box"),
                          ("dir", "conv_dir_cls")):
            w.conv2d(f"{pre}rpn_heads.{i}.{ref}", params[f"head{i}_{ours}"])
    return w.sd


def _resnet(w, pb, fb, key, blocks=(3, 4, 6, 3)):
    """JAX ``ResNet50`` params ``pb`` and frozen constants ``fb`` → the
    port's ``ResNet50`` under ``key`` (mmdet names)."""
    w.conv2d(f"{key}.conv1", pb["conv1"])
    w.frozen_bn(f"{key}.bn1", fb["bn1"])
    for stage, n in enumerate(blocks):
        for b in range(n):
            ours, name = f"{key}.layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            for c in ("1", "2", "3"):
                w.conv2d(f"{ours}.conv{c}", pb[name][f"conv{c}"])
                w.frozen_bn(f"{ours}.bn{c}", fb[name][f"bn{c}"])
            if "ds_conv" in pb[name]:
                w.conv2d(f"{ours}.downsample.0", pb[name]["ds_conv"])
                w.frozen_bn(f"{ours}.downsample.1", fb[name]["ds_bn"])


def from_jax_caddn(params, batch_stats, frozen, cfg=None):
    """(params, batch_stats, frozen) of the JAX ``CaDDN`` → the port's
    state dict: the DDN's trunk as the Faster R-CNN's (``frozen`` its
    FrozenBN constants), the ASPP head and the collapse under JAX's
    names, the BEV (layer_nums (10, 10, 10); the collapse's Z-major
    channels are JAX's order, so no permutation) and the anchor head.
    ``cfg`` (the model's keyword config) is not needed: every width
    comes with the arrays."""
    w = _Writer()
    pd, sd = params["ddn"], batch_stats["ddn"]
    _resnet(w, pd["trunk"], frozen["ddn"]["trunk"], "ddn.trunk")
    pa, sa = pd["aspp"], sd["aspp"]
    for name in sorted(n for n in pa if not n.endswith("_bn")):
        w.conv2d(f"ddn.aspp.{name}", pa[name])
        w.bn(f"ddn.aspp.{name}_bn", pa[f"{name}_bn"], sa[f"{name}_bn"])
    w.conv2d("ddn.depth_out", pd["depth_out"])
    w.conv2d("ddn.channel_reduce", pd["channel_reduce"])
    w.bn("ddn.channel_reduce_bn", pd["channel_reduce_bn"],
         sd["channel_reduce_bn"])
    w.conv2d("collapse.conv", params["collapse"]["conv"])
    w.bn("collapse.bn", params["collapse"]["bn"], batch_stats["collapse"]["bn"])
    _bev(w, params["backbone2d"], batch_stats["backbone2d"], (10, 10, 10))
    _dense_head(w, params["dense_head"])
    return w.sd


FROM_JAX = {"PVRCNN": from_jax_pvrcnn, "SECOND": from_jax_second,
            "SECONDNetIoU": from_jax_second,
            "PointPillar": from_jax_pointpillars,
            "PartA2Net": from_jax_parta2, "VoxelRCNN": from_jax_voxelrcnn,
            "PointRCNN": from_jax_pointrcnn,
            # (params, batch_stats, frozen, cfg): its trunk's FrozenBN
            "CaDDN": from_jax_caddn}


def from_jax_frcnn(params, frozen, cfg=None):
    """(params, frozen) of the JAX ``FasterRCNN`` → mmdet state dict.

    Args:
        params, frozen: nested dicts of arrays.
        cfg: the ``FasterRCNN`` keyword config (``backbone_cfg``'s
            ``stage_blocks`` sets the depth; (3, 4, 6, 3) by default).
    Returns:
        OrderedDict of float32 tensors that ``FasterRCNN(**cfg)`` loads.
    """
    w = _Writer()
    blocks = ((cfg or {}).get("backbone_cfg") or {}).get(
        "stage_blocks", (3, 4, 6, 3))
    _resnet(w, params["backbone"], frozen["backbone"], "backbone", blocks)
    for i in range(4):
        w.conv2d(f"neck.lateral_convs.{i}.conv", params["neck"][f"lateral{i}"])
        w.conv2d(f"neck.fpn_convs.{i}.conv", params["neck"][f"fpn_conv{i}"])
    for name in ("rpn_conv", "rpn_cls", "rpn_reg"):
        w.conv2d(f"rpn_head.{name}", params["rpn_head"][name])
    ph = params["bbox_head"]
    fc0 = np.asarray(ph["shared_fc0"]["kernel"])  # rows in (7, 7, C) order
    c = 256
    o = int(round(np.sqrt(fc0.shape[0] // c)))
    fc0 = fc0.reshape(o, o, c, -1).transpose(2, 0, 1, 3).reshape(
        fc0.shape[0], -1)
    w.linear("roi_head.bbox_head.shared_fcs.0",
             dict(ph["shared_fc0"], kernel=fc0))
    for ours, theirs in (("shared_fcs.1", "shared_fc1"),
                         ("fc_cls", "fc_cls"), ("fc_reg", "fc_reg")):
        w.linear(f"roi_head.bbox_head.{ours}", ph[theirs])
    return w.sd


def from_jax_ssl(state, pv_cfg, fr_cfg):
    """The JAX SSL state ``{"student"|"teacher": {"det3d": {"params",
    "batch_stats"}, "det2d": {"params", "frozen"}}}`` → the state dict of
    the port's ``SSLDetector`` (``{student,teacher}.{det3d,det2d}.*``)."""
    sd = OrderedDict()
    for half in ("student", "teacher"):
        v3, v2 = state[half]["det3d"], state[half]["det2d"]
        for k, t in from_jax_pvrcnn(v3["params"], v3["batch_stats"],
                                    pv_cfg).items():
            sd[f"{half}.det3d.{k}"] = t
        for k, t in from_jax_frcnn(v2["params"], v2["frozen"],
                                   fr_cfg).items():
            sd[f"{half}.det2d.{k}"] = t
    return sd


# ---- the port's state dicts → JAX variables (the inverses) ----

class _Reader:
    """Builds JAX variable trees from a port state dict, applying each
    layout bridge of :class:`_Writer` backwards (numpy only)."""

    def __init__(self, sd):
        self.sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                       else np.asarray(v)) for k, v in sd.items()}

    def get(self, key):
        return self.sd[key]

    def has(self, key):
        return key in self.sd

    def count(self, prefix, stride):
        """How many layers ``{prefix}.{stride*k + 1}`` hold a batch norm's
        running mean (k = 0, 1, ...)."""
        n = 0
        while f"{prefix}.{stride * n + 1}.running_mean" in self.sd:
            n += 1
        return n

    def bn(self, key):
        return (dict(scale=self.get(key + ".weight"),
                     bias=self.get(key + ".bias")),
                dict(mean=self.get(key + ".running_mean"),
                     var=self.get(key + ".running_var")))

    def frozen_bn(self, key):
        return {theirs: self.get(f"{key}.{ours}") for ours, theirs in (
            ("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
            ("running_var", "var"))}

    def _with_bias(self, key, out):
        if self.has(key + ".bias"):
            out["bias"] = self.get(key + ".bias")
        return out

    def linear(self, key):
        """Linear (out, in) / 1x1 conv (out, in, 1...) → Dense (in, out)."""
        w = self.get(key + ".weight")
        return self._with_bias(key, dict(
            kernel=np.ascontiguousarray(w.reshape(w.shape[0], -1).T)))

    def conv2d(self, key):
        return self._with_bias(key, dict(kernel=np.ascontiguousarray(
            self.get(key + ".weight").transpose(2, 3, 1, 0))))

    def spconv(self, key, p3, s3, name):
        w = self.get(key + ".0.weight")
        p3[name + "_w"] = np.ascontiguousarray(
            w.reshape((-1,) + w.shape[-2:]))
        p3[name + "_bn"], s3[name + "_bn"] = self.bn(key + ".1")

    def mlp(self, key, stride=3):
        """``{key}.{stride*k}`` / ``{key}.{stride*k+1}`` → JAX ``MLP``
        ``dense{k}`` / ``bn{k}`` (params, batch_stats)."""
        p, s = {}, {}
        for kk in range(self.count(key, stride)):
            p[f"dense{kk}"] = self.linear(f"{key}.{stride * kk}")
            p[f"bn{kk}"], s[f"bn{kk}"] = self.bn(f"{key}.{stride * kk + 1}")
        return p, s


def _voxel_backbone_jax(r):
    p3, s3 = {}, {}
    r.spconv("backbone_3d.conv_input", p3, s3, "conv_input")
    r.spconv("backbone_3d.conv1.0", p3, s3, "conv1_0")
    for lvl in (2, 3, 4):
        r.spconv(f"backbone_3d.conv{lvl}.0", p3, s3, f"conv{lvl}_down")
        for j in (0, 1):
            r.spconv(f"backbone_3d.conv{lvl}.{j + 1}", p3, s3,
                     f"conv{lvl}_{j}")
    r.spconv("backbone_3d.conv_out", p3, s3, "conv_out")
    return p3, s3


def _bev_jax(r, layer_nums, hc=None):
    """The inverse of :func:`_bev`."""
    p2, s2 = {}, {}
    for i, n_layers in enumerate(layer_nums):
        conv = r.conv2d(f"backbone_2d.blocks.{i}.1")
        if i == 0 and hc is not None:
            conv["kernel"] = np.ascontiguousarray(
                conv["kernel"].transpose(2, 0, 1, 3)[hc].transpose(1, 2, 0, 3))
        bp, bs = r.bn(f"backbone_2d.blocks.{i}.2")
        p2[f"block{i}_0"], s2[f"block{i}_0"] = dict(conv=conv, bn=bp), dict(
            bn=bs)
        for j in range(n_layers):
            idx = 4 + 3 * j
            bp, bs = r.bn(f"backbone_2d.blocks.{i}.{idx + 1}")
            p2[f"block{i}_{j + 1}"] = dict(
                conv=r.conv2d(f"backbone_2d.blocks.{i}.{idx}"), bn=bp)
            s2[f"block{i}_{j + 1}"] = dict(bn=bs)
        k = r.get(f"backbone_2d.deblocks.{i}.0.weight")
        bp, bs = r.bn(f"backbone_2d.deblocks.{i}.1")
        p2[f"deblock{i}"] = dict(conv=dict(kernel=np.ascontiguousarray(
            k.transpose(2, 3, 0, 1)[::-1, ::-1])), bn=bp)
        s2[f"deblock{i}"] = dict(bn=bs)
    return p2, s2


def to_jax_pvrcnn(sd, cfg):
    """The port's PV-RCNN state dict → (params, batch_stats) of the JAX
    ``PVRCNN``: the exact inverse of :func:`from_jax_pvrcnn` (numpy
    arrays; ``cfg`` the model's keyword config)."""
    r = _Reader(sd)
    params, stats = {}, {}
    params["backbone3d"], stats["backbone3d"] = _voxel_backbone_jax(r)
    hc_z, hc_c = _hc(cfg, (cfg.get("backbone3d_cfg") or {}).get(
        "out_channels", 128))
    hc = _hc_perm(hc_z, hc_c)
    params["backbone2d"], stats["backbone2d"] = _bev_jax(
        r, (cfg.get("bev_cfg") or {}).get("layer_nums", (5, 5)), hc)
    params["dense_head"] = {ours: r.conv2d(f"dense_head.{ref}")
                            for ours, ref in (("conv_cls", "conv_cls"),
                                              ("conv_box", "conv_box"),
                                              ("conv_dir", "conv_dir_cls"))}

    pp, sp = {}, {}

    def sa_branch(key, name):
        pp[name], sp[name] = {}, {}
        g = 0
        while r.has(f"{key}.mlps.{g}.1.running_mean"):
            pp[name][f"mlp{g}"], sp[name][f"mlp{g}"] = r.mlp(
                f"{key}.mlps.{g}")
            g += 1

    sa_branch("pfe.SA_rawpoints", "sa_raw_points")
    for li in range(4):
        sa_branch(f"pfe.SA_layers.{li}", f"sa_x_conv{li + 1}")
    n_bev = hc_z * hc_c
    fusion = r.linear("pfe.vsa_point_feature_fusion.0")["kernel"]
    pp["fusion"] = dict(kernel=np.concatenate([fusion[:n_bev][hc],
                                               fusion[n_bev:]]))
    pp["fusion_bn"], sp["fusion_bn"] = r.bn("pfe.vsa_point_feature_fusion.1")
    params["pfe"], stats["pfe"] = pp, sp

    mlp_p, mlp_s = r.mlp("point_head.cls_layers")
    k0 = mlp_p["dense0"]["kernel"]
    mlp_p["dense0"] = dict(mlp_p["dense0"], kernel=np.concatenate(
        [k0[:n_bev][hc], k0[n_bev:]]))
    n_fc = len(mlp_s)
    params["point_head"] = dict(
        cls_mlp=mlp_p, cls_out=r.linear(f"point_head.cls_layers.{3 * n_fc}"))
    stats["point_head"] = dict(cls_mlp=mlp_s)

    pr, sr = {}, {}
    g = 0
    while r.has(f"roi_head.roi_grid_pool_layer.mlps.{g}.1.running_mean"):
        pr[f"pool_mlp{g}"], sr[f"pool_mlp{g}"] = r.mlp(
            f"roi_head.roi_grid_pool_layer.mlps.{g}")
        g += 1
    g3 = (cfg.get("roi_head_cfg") or {}).get("grid_size", 6) ** 3
    _roi_fcs_jax(r, pr, sr, "roi_head", g3=g3)
    params["roi_head"], stats["roi_head"] = pr, sr
    return params, stats


def _roi_fcs_jax(r, pr, sr, key, heads=(("cls", "cls_layers"),
                                        ("reg", "reg_layers")), g3=None):
    """The inverse of :func:`_roi_fcs`; ``g3`` (the RoI grid's G^3) undoes
    the shared fc's (C, G^3) input order."""
    idx = kk = 0
    while r.has(f"{key}.shared_fc_layer.{idx + 1}.running_mean"):
        pr[f"shared_fc{kk}"] = r.linear(f"{key}.shared_fc_layer.{idx}")
        pr[f"shared_bn{kk}"], sr[f"shared_bn{kk}"] = r.bn(
            f"{key}.shared_fc_layer.{idx + 1}")
        kk += 1
        idx += 4 if r.has(f"{key}.shared_fc_layer.{idx + 4}.weight") else 3
    if g3 is not None:
        fc0 = pr["shared_fc0"]["kernel"]
        cin = fc0.shape[0] // g3
        perm = np.asarray([ci * g3 + gi for gi in range(g3)
                           for ci in range(cin)], np.int64)
        pr["shared_fc0"] = dict(pr["shared_fc0"], kernel=fc0[perm])
    for name, ref in heads:
        idx = kk = 0
        while r.has(f"{key}.{ref}.{idx + 1}.running_mean"):
            pr[f"{name}_fc{kk}"] = r.linear(f"{key}.{ref}.{idx}")
            pr[f"{name}_bn{kk}"], sr[f"{name}_bn{kk}"] = r.bn(
                f"{key}.{ref}.{idx + 1}")
            idx += 4 if kk == 0 else 3
            kk += 1
        pr[f"{name}_out"] = r.linear(f"{key}.{ref}.{idx}")


def _resnet_jax(r, key, blocks=(3, 4, 6, 3)):
    """The inverse of :func:`_resnet`: (params, frozen)."""
    pb, fb = dict(conv1=r.conv2d(f"{key}.conv1")), dict(
        bn1=r.frozen_bn(f"{key}.bn1"))
    for stage, n in enumerate(blocks):
        for b in range(n):
            ours, name = f"{key}.layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            pb[name], fb[name] = {}, {}
            for c in ("1", "2", "3"):
                pb[name][f"conv{c}"] = r.conv2d(f"{ours}.conv{c}")
                fb[name][f"bn{c}"] = r.frozen_bn(f"{ours}.bn{c}")
            if r.has(f"{ours}.downsample.0.weight"):
                pb[name]["ds_conv"] = r.conv2d(f"{ours}.downsample.0")
                fb[name]["ds_bn"] = r.frozen_bn(f"{ours}.downsample.1")
    return pb, fb


def to_jax_frcnn(sd, cfg=None):
    """The port's Faster R-CNN state dict → (params, frozen) of the JAX
    ``FasterRCNN``: the exact inverse of :func:`from_jax_frcnn`."""
    r = _Reader(sd)
    blocks = ((cfg or {}).get("backbone_cfg") or {}).get(
        "stage_blocks", (3, 4, 6, 3))
    pb, fb = _resnet_jax(r, "backbone", blocks)
    params = dict(backbone=pb, neck={}, rpn_head={}, bbox_head={})
    for i in range(4):
        params["neck"][f"lateral{i}"] = r.conv2d(f"neck.lateral_convs.{i}.conv")
        params["neck"][f"fpn_conv{i}"] = r.conv2d(f"neck.fpn_convs.{i}.conv")
    for name in ("rpn_conv", "rpn_cls", "rpn_reg"):
        params["rpn_head"][name] = r.conv2d(f"rpn_head.{name}")
    ph = params["bbox_head"]
    fc0 = r.linear("roi_head.bbox_head.shared_fcs.0")
    k = fc0["kernel"]  # rows in mmdet's (C, 7, 7) order
    c = 256
    o = int(round(np.sqrt(k.shape[0] // c)))
    ph["shared_fc0"] = dict(fc0, kernel=np.ascontiguousarray(
        k.reshape(c, o, o, -1).transpose(1, 2, 0, 3).reshape(k.shape[0], -1)))
    for ours, theirs in (("shared_fcs.1", "shared_fc1"),
                         ("fc_cls", "fc_cls"), ("fc_reg", "fc_reg")):
        ph[theirs] = r.linear(f"roi_head.bbox_head.{ours}")
    return params, dict(backbone=fb)


def to_jax_ssl(sd, pv_cfg, fr_cfg):
    """The port's ``SSLDetector`` state dict → the JAX SSL state
    ``{"student"|"teacher": {"det3d": {"params", "batch_stats"},
    "det2d": {"params", "frozen"}}}``: the inverse of :func:`from_jax_ssl`."""
    state = {}
    for half in ("student", "teacher"):
        def part(det):
            pre = f"{half}.{det}."
            return {k[len(pre):]: v for k, v in sd.items()
                    if k.startswith(pre)}
        p3, s3 = to_jax_pvrcnn(part("det3d"), pv_cfg)
        p2, f2 = to_jax_frcnn(part("det2d"), fr_cfg)
        state[half] = dict(det3d=dict(params=p3, batch_stats=s3),
                           det2d=dict(params=p2, frozen=f2))
    return state
