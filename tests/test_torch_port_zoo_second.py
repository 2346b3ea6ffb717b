"""CPU parity of the port's SECOND and SECOND-IoU against the JAX package
(``torch_port_zoo_fixture``: tiny scenes, JAX's weights brought over by
``convert.from_jax_second``, JAX's RoI picks and dropout masks handed
over).

Tolerances: dense head outputs and post-processed boxes / scores within
1e-4 of each tensor's largest magnitude, the kept set and labels
exactly; each loss term of both train passes within 1e-4 relative; each
gradient of the frozen-BN pass within 1e-3 of its largest magnitude (two
frameworks sum ~200 terms in other orders); batch-norm running
statistics after the pass with batch statistics within 1e-4. SECOND-IoU's sampled
RoIs are JAX's picks (labels and regression mask exactly).
"""
import numpy as np
import pytest
import torch

import torch_port_zoo_fixture as zf
from torch_port_ssl_fixture import one_torch_thread  # noqa: F401

from detmatch_tpu.models.pvrcnn import second as jsecond
from detmatch_tpu.models.pvrcnn.pvrcnn import post_processing as jpost
from detmatch_tpu_torch.models.pvrcnn.pvrcnn import post_processing
from detmatch_tpu_torch.models.pvrcnn.second import second_post_processing

ONE_STAGE_POST = dict(nms_pre=64, nms_post=16, score_thresh=0.1)
IOU_CFG = dict(zf.CFG, **zf.NMS)


def _one_stage_jax(out):
    return jsecond.second_post_processing(out, **ONE_STAGE_POST)


def _one_stage_port(out):
    return second_post_processing(out, **ONE_STAGE_POST)


@pytest.fixture(scope="module")
def second():
    pts, valid, gt = zf.scene(0)
    jb, tb = zf.voxel_batches(pts, valid, gt)
    ref = zf.run_jax(jsecond.SECOND(**zf.CFG), jb, _one_stage_jax)
    return ref, zf.run_port("SECOND", zf.CFG, ref, tb, _one_stage_port)


@pytest.fixture(scope="module")
def second_iou():
    pts, valid, gt = zf.scene(1)
    jb, tb = zf.voxel_batches(pts, valid, gt)
    ref = zf.run_jax(jsecond.SECONDIoU(**IOU_CFG), jb, jpost)
    return ref, zf.run_port("SECONDNetIoU", IOU_CFG, ref, tb,
                            post_processing)


def test_second_eval_forward_and_post(second):
    ref, port = second
    zf.check_dense(port["eval"], ref["eval"])
    for k in ("batch_box_preds", "batch_cls_preds"):
        assert zf.rel(port["eval"][k], ref["eval"][k]) <= zf.OUT_TOL, k
    zf.check_post(port["post"], ref["post"])


def test_second_train_losses_and_grads(second):
    ref, port = second
    zf.check_losses(port, ref)
    zf.check_grads("SECOND", zf.CFG, port, ref)


def test_second_iou_eval(second_iou):
    """Proposals, the IoU head's logits and the detections."""
    ref, port = second_iou
    ev, rev = port["eval"], ref["eval"]
    zf.check_dense(ev, rev)
    np.testing.assert_array_equal(ev["proposals"]["roi_valid"].numpy(),
                                  rev["proposals"]["roi_valid"])
    assert zf.rel(ev["rois"], rev["rois"]) <= zf.OUT_TOL
    assert zf.rel(ev["rcnn_iou"], rev["rcnn_iou"]) <= zf.OUT_TOL
    zf.check_post(port["post"], ref["post"])


def test_second_iou_train(second_iou):
    """The sampled RoIs, every loss term and every gradient."""
    ref, port = second_iou
    zf.check_sampled_rois(port, ref)
    assert len(ref["masks"].masks) == 2  # shared fc0, iou fc0
    zf.check_losses(port, ref)
    zf.check_grads("SECONDNetIoU", IOU_CFG, port, ref)


def test_second_iou_voxel_size_default():
    """The port's default voxel size is pcdet's: the IoU head's BEV cell
    is the BEV map's (8 voxels of 0.05 m), not the JAX default's 4 m."""
    from detmatch_tpu_torch.models.pvrcnn.second import SECONDIoU
    head = SECONDIoU(grid_size=(176, 200, 40)).roi_head
    assert head.cell == pytest.approx((0.4, 0.4))
    assert jsecond.SECONDIoU.voxel_size == (0.5, 0.5, 0.1)
    assert torch.is_tensor(head.shared_fc_layer[0].weight)
