"""CPU parity of the port's Part-A2 against the JAX package
(``torch_port_zoo_fixture``; weights through ``convert.from_jax_parta2``):
the UNet's levels and point features (its 28 convs on K1's twin, the
three inverse convs among them), the point head, proposals, the RoI head
(RoI-aware pooling, the dense 3D conv towers) and the detections in eval
mode; the point-head targets, sampled RoIs, every loss term of both
train passes and every gradient.

Tolerances: the UNet's features, point-head outputs, dense outputs,
RoIs, refined boxes and post-processed boxes / scores within 1e-4 of
each tensor's largest magnitude, the kept sets, labels and point labels
exactly; loss terms within 1e-4 relative; each gradient of the
frozen-BN pass within 1e-3 of its largest magnitude; batch-norm running
statistics within 1e-4.
"""
import numpy as np
import pytest
import torch

import torch_port_zoo_fixture as zf
from torch_port_ssl_fixture import one_torch_thread  # noqa: F401

from detmatch_tpu.models.pvrcnn import parta2 as jpa
from detmatch_tpu.models.pvrcnn.pvrcnn import post_processing as jpost
from detmatch_tpu_torch.models.pvrcnn.pvrcnn import post_processing

CFG = dict(zf.CFG, **zf.NMS)
LEVELS = ("x_conv1", "x_conv2", "x_conv3", "x_conv4", "out")


def _jpost(out):
    return dict(jpost(out), **{k: out[k] for k in (
        "point_cls_logits", "point_part_reg", "point_coords")})


@pytest.fixture(scope="module")
def parta2():
    pts, valid, gt = zf.scene(4)
    jb, tb = zf.voxel_batches(pts, valid, gt)
    ref = zf.run_jax(jpa.PartA2(**CFG), jb, _jpost)
    port = zf.run_port("PartA2Net", CFG, ref, tb, post_processing)
    return ref, port, gt


def test_eval_forward_and_detections(parta2):
    ref, port, _ = parta2
    ev, rev = port["eval"], ref["eval"]
    zf.check_dense(ev, rev)
    for k in ("point_cls_logits", "point_part_reg", "point_coords"):
        assert zf.rel(ev[k], ref["post"][k]) <= zf.OUT_TOL, k
    np.testing.assert_array_equal(ev["proposals"]["roi_valid"].numpy(),
                                  rev["proposals"]["roi_valid"])
    for k in ("rois", "rcnn_cls", "rcnn_reg", "batch_box_preds_rcnn"):
        assert zf.rel(ev[k], rev[k]) <= zf.OUT_TOL, k
    zf.check_post(port["post"], ref["post"])


def test_train_targets_losses_and_grads(parta2):
    ref, port, gt = parta2
    zf.check_anchor_targets(port, ref, gt)
    out = port["train_out"]
    labels, parts = port["model"].point_head.targets(
        out["point_coords"], out["point_valid"], torch.from_numpy(gt))
    assert (labels > 0).any()
    zf.check_sampled_rois(port, ref)
    assert len(ref["masks"].masks) == 3
    zf.check_losses(port, ref)
    zf.check_grads("PartA2Net", CFG, port, ref)
    for name in ("backbone_3d.inv_conv2.0.weight",
                 "backbone_3d.conv_up_m4.0.weight",
                 "roi_head.conv_part.0.conv.weight"):
        assert port["frozen"]["grads"][name].abs().max() > 0, name
