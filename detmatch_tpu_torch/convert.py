"""JAX model variables → the port's state dicts: PV-RCNN (pcdet names),
Faster R-CNN (mmdet names) and the SSL detector's teacher and student.

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
    sd = OrderedDict()

    def put(key, arr):
        sd[key] = torch.from_numpy(np.array(arr, order="C"))

    def bn(key, p, s):
        put(key + ".weight", p["scale"])
        put(key + ".bias", p["bias"])
        put(key + ".running_mean", s["mean"])
        put(key + ".running_var", s["var"])
        sd[key + ".num_batches_tracked"] = torch.tensor(0)

    def linear(key, p, shape_tail=()):
        k = np.asarray(p["kernel"]).T
        put(key + ".weight", k.reshape(k.shape + shape_tail))
        if "bias" in p:
            put(key + ".bias", p["bias"])

    def conv2d(key, p):
        put(key + ".weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            put(key + ".bias", p["bias"])

    # ---- backbone_3d ----
    p3, s3 = params["backbone3d"], batch_stats["backbone3d"]

    def spconv(key, name, ks=(3, 3, 3)):
        w = np.asarray(p3[name + "_w"])
        put(key + ".0.weight", w.reshape(ks + w.shape[1:]))
        bn(key + ".1", p3[name + "_bn"], s3[name + "_bn"])

    spconv("backbone_3d.conv_input", "conv_input")
    spconv("backbone_3d.conv1.0", "conv1_0")
    for lvl in (2, 3, 4):
        spconv(f"backbone_3d.conv{lvl}.0", f"conv{lvl}_down")
        for j in (0, 1):
            spconv(f"backbone_3d.conv{lvl}.{j + 1}", f"conv{lvl}_{j}")
    spconv("backbone_3d.conv_out", "conv_out", (3, 1, 1))

    # ---- backbone_2d ----
    grid = cfg.get("grid_size", (1408, 1600, 40))
    hc_z = level_shapes((grid[2] + 1, grid[1], grid[0]))[-1][0]
    hc_c = (cfg.get("backbone3d_cfg") or {}).get("out_channels", 128)
    hc = _hc_perm(hc_z, hc_c)
    p2, s2 = params["backbone2d"], batch_stats["backbone2d"]
    layer_nums = (cfg.get("bev_cfg") or {}).get("layer_nums", (5, 5))
    for i, n_layers in enumerate(layer_nums):
        blk = p2[f"block{i}_0"]
        kernel = np.asarray(blk["conv"]["kernel"])
        if i == 0:  # consumes the HeightCompression output
            kernel = _unpermute(kernel.transpose(2, 0, 1, 3), hc
                                ).transpose(1, 2, 0, 3)
        conv2d(f"backbone_2d.blocks.{i}.1", dict(kernel=kernel))
        bn(f"backbone_2d.blocks.{i}.2", blk["bn"],
           s2[f"block{i}_0"]["bn"])
        for j in range(n_layers):
            idx = 4 + 3 * j
            conv2d(f"backbone_2d.blocks.{i}.{idx}",
                   p2[f"block{i}_{j + 1}"]["conv"])
            bn(f"backbone_2d.blocks.{i}.{idx + 1}",
               p2[f"block{i}_{j + 1}"]["bn"], s2[f"block{i}_{j + 1}"]["bn"])
        k = np.asarray(p2[f"deblock{i}"]["conv"]["kernel"])
        put(f"backbone_2d.deblocks.{i}.0.weight",
            k[::-1, ::-1].transpose(2, 3, 0, 1))
        bn(f"backbone_2d.deblocks.{i}.1", p2[f"deblock{i}"]["bn"],
           s2[f"deblock{i}"]["bn"])

    # ---- dense_head ----
    for ours, ref in (("conv_cls", "conv_cls"), ("conv_box", "conv_box"),
                      ("conv_dir", "conv_dir_cls")):
        conv2d(f"dense_head.{ref}", params["dense_head"][ours])

    # ---- pfe ----
    pp, sp = params["pfe"], batch_stats["pfe"]

    def sa_branch(key, name):
        for g in sorted(int(n[3:]) for n in pp[name] if n.startswith("mlp")):
            mp, ms = pp[name][f"mlp{g}"], sp[name][f"mlp{g}"]
            for kk in range(len([n for n in mp if n.startswith("dense")])):
                linear(f"{key}.mlps.{g}.{3 * kk}", mp[f"dense{kk}"], (1, 1))
                bn(f"{key}.mlps.{g}.{3 * kk + 1}", mp[f"bn{kk}"],
                   ms[f"bn{kk}"])

    sa_branch("pfe.SA_rawpoints", "sa_raw_points")
    for li in range(4):
        sa_branch(f"pfe.SA_layers.{li}", f"sa_x_conv{li + 1}")
    fusion = np.asarray(pp["fusion"]["kernel"])  # (in, out), JAX order
    n_bev = hc_z * hc_c
    fusion = np.concatenate([_unpermute(fusion[:n_bev], hc),
                             fusion[n_bev:]])
    linear("pfe.vsa_point_feature_fusion.0", dict(kernel=fusion))
    bn("pfe.vsa_point_feature_fusion.1", pp["fusion_bn"], sp["fusion_bn"])

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
        linear(f"point_head.cls_layers.{3 * kk}", p)
        bn(f"point_head.cls_layers.{3 * kk + 1}", ph["cls_mlp"][f"bn{kk}"],
           sh["cls_mlp"][f"bn{kk}"])
    linear(f"point_head.cls_layers.{3 * n_fc}", ph["cls_out"])

    # ---- roi_head ----
    pr, sr = params["roi_head"], batch_stats["roi_head"]
    for g in sorted(int(n[8:]) for n in pr if n.startswith("pool_mlp")):
        mp, ms = pr[f"pool_mlp{g}"], sr[f"pool_mlp{g}"]
        for kk in range(len([n for n in mp if n.startswith("dense")])):
            linear(f"roi_head.roi_grid_pool_layer.mlps.{g}.{3 * kk}",
                   mp[f"dense{kk}"], (1, 1))
            bn(f"roi_head.roi_grid_pool_layer.mlps.{g}.{3 * kk + 1}",
               mp[f"bn{kk}"], ms[f"bn{kk}"])
    g3 = (cfg.get("roi_head_cfg") or {}).get("grid_size", 6) ** 3
    fc0 = np.asarray(pr["shared_fc0"]["kernel"])  # (G^3 * C, out)
    cin = fc0.shape[0] // g3
    perm = np.asarray([ci * g3 + gi for gi in range(g3) for ci in range(cin)],
                      np.int64)
    n_shared = len([n for n in pr if n.startswith("shared_fc")])
    for kk in range(n_shared):
        p = (dict(kernel=_unpermute(fc0, perm)) if kk == 0
             else pr[f"shared_fc{kk}"])
        # Conv1d, BN, ReLU per layer, Dropout between layers
        linear(f"roi_head.shared_fc_layer.{4 * kk}", p, (1,))
        bn(f"roi_head.shared_fc_layer.{4 * kk + 1}", pr[f"shared_bn{kk}"],
           sr[f"shared_bn{kk}"])
    for name, ref in (("cls", "cls_layers"), ("reg", "reg_layers")):
        n_fc = len([n for n in pr if n.startswith(f"{name}_fc")])
        idx = 0
        for kk in range(n_fc):
            linear(f"roi_head.{ref}.{idx}", pr[f"{name}_fc{kk}"], (1,))
            bn(f"roi_head.{ref}.{idx + 1}", pr[f"{name}_bn{kk}"],
               sr[f"{name}_bn{kk}"])
            idx += 4 if kk == 0 else 3  # Dropout after the first layer
        linear(f"roi_head.{ref}.{idx}", pr[f"{name}_out"], (1,))
    return sd


def from_jax_frcnn(params, frozen, cfg=None):
    """(params, frozen) of the JAX ``FasterRCNN`` → mmdet state dict.

    Args:
        params, frozen: nested dicts of arrays.
        cfg: the ``FasterRCNN`` keyword config (``backbone_cfg``'s
            ``stage_blocks`` sets the depth; (3, 4, 6, 3) by default).
    Returns:
        OrderedDict of float32 tensors that ``FasterRCNN(**cfg)`` loads.
    """
    sd = OrderedDict()

    def put(key, arr):
        sd[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    def conv(key, p):
        put(key + ".weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            put(key + ".bias", p["bias"])

    def frozen_bn(key, f):
        for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                             ("running_mean", "mean"),
                             ("running_var", "var")):
            put(f"{key}.{ours}", f[theirs])

    def linear(key, p, kernel=None):
        k = np.asarray(p["kernel"]) if kernel is None else kernel
        put(key + ".weight", k.T)
        put(key + ".bias", p["bias"])

    pb, fb = params["backbone"], frozen["backbone"]
    conv("backbone.conv1", pb["conv1"])
    frozen_bn("backbone.bn1", fb["bn1"])
    blocks = ((cfg or {}).get("backbone_cfg") or {}).get(
        "stage_blocks", (3, 4, 6, 3))
    for stage, n in enumerate(blocks):
        for b in range(n):
            key, name = f"backbone.layer{stage + 1}.{b}", \
                f"layer{stage + 1}_{b}"
            for c in ("1", "2", "3"):
                conv(f"{key}.conv{c}", pb[name][f"conv{c}"])
                frozen_bn(f"{key}.bn{c}", fb[name][f"bn{c}"])
            if "ds_conv" in pb[name]:
                conv(f"{key}.downsample.0", pb[name]["ds_conv"])
                frozen_bn(f"{key}.downsample.1", fb[name]["ds_bn"])
    for i in range(4):
        conv(f"neck.lateral_convs.{i}.conv", params["neck"][f"lateral{i}"])
        conv(f"neck.fpn_convs.{i}.conv", params["neck"][f"fpn_conv{i}"])
    for name in ("rpn_conv", "rpn_cls", "rpn_reg"):
        conv(f"rpn_head.{name}", params["rpn_head"][name])
    ph = params["bbox_head"]
    fc0 = np.asarray(ph["shared_fc0"]["kernel"])  # rows in (7, 7, C) order
    c = 256
    o = int(round(np.sqrt(fc0.shape[0] // c)))
    fc0 = fc0.reshape(o, o, c, -1).transpose(2, 0, 1, 3).reshape(
        fc0.shape[0], -1)
    linear("roi_head.bbox_head.shared_fcs.0", ph["shared_fc0"], fc0)
    linear("roi_head.bbox_head.shared_fcs.1", ph["shared_fc1"])
    linear("roi_head.bbox_head.fc_cls", ph["fc_cls"])
    linear("roi_head.bbox_head.fc_reg", ph["fc_reg"])
    return sd


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
