"""CPU parity of the port's PointRCNN against the JAX package
(``torch_port_zoo_fixture``; weights through
``convert.from_jax_pointrcnn``), at the tiny widths of JAX's own
PointRCNN test (``tests/test_pointrcnn.py``): backbone features (FPS K3's
and ball query K2's twins, 3-NN interpolation), point-head boxes,
proposals, the RoI head over pooled in-box points (RoI point pooling,
FPS over B·R problems, some of them empty, the group-all level) and the
detections in eval mode; the sampled RoIs, every loss term of both
train passes and every gradient.

Tolerances: features, point-head outputs, RoIs, refined boxes and
post-processed boxes / scores within 1e-4 of each tensor's largest
magnitude, the kept sets and labels exactly; loss terms within 1e-4
relative; each gradient of the frozen-BN pass within 1e-3 of its largest
magnitude; batch-norm running statistics within 1e-4.
"""
import numpy as np
import pytest

import torch_port_zoo_fixture as zf
from torch_port_ssl_fixture import one_torch_thread  # noqa: F401

from detmatch_tpu.models.pvrcnn import pointrcnn as jpr
from detmatch_tpu.models.pvrcnn.pvrcnn import post_processing as jpost
from detmatch_tpu_torch.models.pvrcnn.pvrcnn import post_processing

NMS = dict(train_nms=dict(nms_pre=128, nms_post=32, nms_thresh=0.8),
           test_nms=dict(nms_pre=128, nms_post=16, nms_thresh=0.7))
BB = dict(npoints=(64, 32, 16, 8),
          mlps=(((8, 8), (8, 8)), ((16, 16), (16, 16)),
                ((16, 16), (16, 16)), ((16, 16), (16, 16))),
          fp_mlps=((16, 16), (16, 16), (32, 32), (32, 32)))
PH = dict(cls_fc=(16,), reg_fc=(16,))
RH = dict(num_sampled=32, sa_npoints=(16, 8, -1), sa_nsamples=(8, 8, 32),
          sa_mlps=((16, 16), (16, 32), (32, 64)), xyz_up=(16, 16),
          cls_fc=(16,), reg_fc=(16,))
CFG = dict(num_classes=3, backbone_cfg=BB, point_head_cfg=PH,
           roi_head_cfg=RH, **NMS)


class TinyPointRCNN(jpr.PointRCNN):
    """JAX's PointRCNN at the widths above (its test's ``TinyPointRCNN``)."""

    def setup(self):
        self.backbone = jpr.PointNet2MSG(name="backbone3d", **BB)
        self.point_head = jpr.PointHeadBox(num_classes=3, name="point_head",
                                           **PH)
        self.roi_head = jpr.PointRCNNHead(name="roi_head", **RH)


def _jpost(out):
    return dict(jpost(out), **{k: out[k] for k in (
        "point_cls_logits", "point_box_reg")})


@pytest.fixture(scope="module")
def pointrcnn():
    pts, valid, gt = zf.scene(5, p=256)
    valid[1, 200:] = False
    jb, tb = zf.voxel_batches(pts, valid, gt)
    ref = zf.run_jax(TinyPointRCNN(**NMS), jb, _jpost,
                     spread=(("point_head", "cls_out"),))
    port = zf.run_port("PointRCNN", CFG, ref, tb, post_processing)
    return ref, port


def test_eval_forward_and_detections(pointrcnn):
    ref, port = pointrcnn
    ev, rev = port["eval"], ref["eval"]
    for k in ("point_cls_logits", "point_box_reg"):
        assert zf.rel(ev[k], ref["post"][k]) <= zf.OUT_TOL, k
    np.testing.assert_array_equal(ev["proposals"]["roi_valid"].numpy(),
                                  rev["proposals"]["roi_valid"])
    for k in ("rois", "rcnn_cls", "rcnn_reg", "batch_box_preds_rcnn"):
        assert zf.rel(ev[k], rev[k]) <= zf.OUT_TOL, k
    zf.check_post(port["post"], ref["post"])


def test_train_losses_and_grads(pointrcnn):
    ref, port = pointrcnn
    zf.check_sampled_rois(port, ref)
    zf.check_losses(port, ref)
    zf.check_grads("PointRCNN", CFG, port, ref)
