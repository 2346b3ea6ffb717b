"""CPU parity of the port's Voxel R-CNN against the JAX package
(``torch_port_zoo_fixture``; weights through
``convert.from_jax_voxelrcnn``): proposals, the RoI-grid pooling on the
voxel-centre tables of x_conv2/3/4 (ball query K2's twin), the refined
boxes and detections in eval mode; the sampled RoIs (JAX's picks), every
loss term and every gradient in train mode.

Tolerances: dense outputs, RoIs, refined boxes and post-processed boxes /
scores within 1e-4 of each tensor's largest magnitude, the kept sets and
labels exactly; ball-query indices and counts exactly; loss terms within
1e-4 relative; each gradient of the frozen-BN pass within 1e-3 of its
largest magnitude; batch-norm running statistics within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_zoo_fixture as zf
from torch_port_ssl_fixture import one_torch_thread  # noqa: F401

from detmatch_tpu.models.pvrcnn import voxelrcnn as jvr
from detmatch_tpu.models.pvrcnn.pvrcnn import post_processing as jpost
from detmatch_tpu.models.pvrcnn.vsa import voxel_centers as jcenters
from detmatch_tpu.ops.pallas.ball_query import ball_query_batched as jbq
from detmatch_tpu_torch.models.pvrcnn.pvrcnn import post_processing
from detmatch_tpu_torch.models.pvrcnn.roi_head import roi_grid_points
from detmatch_tpu_torch.models.pvrcnn.vsa import voxel_centers
from detmatch_tpu_torch.ops.cuda import KERNELS

CFG = dict(zf.CFG, **zf.NMS)


@pytest.fixture(scope="module")
def voxelrcnn():
    pts, valid, gt = zf.scene(3)
    jb, tb = zf.voxel_batches(pts, valid, gt)
    ref = zf.run_jax(jvr.VoxelRCNN(**CFG), jb, jpost)
    port = zf.run_port("VoxelRCNN", CFG, ref, tb, post_processing)
    return ref, port, gt


def test_eval_forward_and_detections(voxelrcnn):
    ref, port, _ = voxelrcnn
    ev, rev = port["eval"], ref["eval"]
    zf.check_dense(ev, rev)
    np.testing.assert_array_equal(ev["proposals"]["roi_valid"].numpy(),
                                  rev["proposals"]["roi_valid"])
    for k in ("rois", "rcnn_cls", "rcnn_reg", "batch_box_preds_rcnn"):
        assert zf.rel(ev[k], rev[k]) <= zf.OUT_TOL, k
    zf.check_post(port["post"], ref["post"])


def test_voxel_center_ball_query_matches_jax(voxelrcnn):
    """K2's twin on each level's voxel-centre table (masked rows: the
    level's padding) against JAX's ball query, indices and counts
    exactly, at the eval RoIs' grid points."""
    ref, port, _ = voxelrcnn
    ms = port["eval"]["backbone"]
    grid = roi_grid_points(port["eval"]["rois"], 6)
    valid = torch.ones(grid.shape[:2], dtype=torch.bool)
    masked = False
    for name, r in (("x_conv2", 0.4), ("x_conv3", 0.8), ("x_conv4", 1.6)):
        lv = ms[name]
        c = voxel_centers(lv["keys"], lv["shape"], lv["stride"], zf.VS,
                          zf.PCR)
        jc = jcenters(jnp.asarray(lv["keys"].numpy()), lv["shape"],
                      lv["stride"], zf.VS, zf.PCR)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        idx, cnt = KERNELS.ball_query_batched(grid, valid, c, lv["mask"], r,
                                              16)
        jidx, jcnt = jbq(jnp.asarray(grid.numpy()), jnp.asarray(
            valid.numpy()), jc, jnp.asarray(lv["mask"].numpy()), r, 16)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert (cnt > 0).any()
        masked |= not lv["mask"].all()
    assert masked  # some level's table has padded rows

def test_train_losses_and_grads(voxelrcnn):
    ref, port, gt = voxelrcnn
    zf.check_anchor_targets(port, ref, gt)
    zf.check_sampled_rois(port, ref)
    assert len(ref["masks"].masks) == 3  # shared fc0, cls fc0, reg fc0
    zf.check_losses(port, ref)
    zf.check_grads("VoxelRCNN", CFG, port, ref)
