"""CPU parity of the port's PointPillars against the JAX package
(``torch_port_zoo_fixture``; weights through
``convert.from_jax_pointpillars``): the voxelizer's grouped per-point
view, the pillar features, the eval forward and post-processing, the
train losses and every gradient.

JAX's BEV scatter places pillars with a Z of 1 while the voxelizer keys
them with Z = 2 (``pointpillars.py:124-126``), which misplaces them; the
port keys them in the voxelizer's shape. The reference run here scatters
as the port does (``spconv.to_dense`` patched for the run), and
:func:`test_jax_scatter_misplaces_pillars` shows the fault.

Tolerances: the grouped view exactly; pillar features, dense outputs and
post-processed boxes / scores within 1e-4 of each tensor's largest
magnitude, the kept set and labels exactly; loss terms within 1e-4
relative; each gradient of the frozen-BN pass within 1e-3 of its largest
magnitude; batch-norm running statistics within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_zoo_fixture as zf
from torch_port_ssl_fixture import one_torch_thread  # noqa: F401

from detmatch_tpu.models.pvrcnn import pointpillars as jpp
from detmatch_tpu.models.pvrcnn.second import second_post_processing as jss
from detmatch_tpu.ops import spconv as jspconv
from detmatch_tpu_torch.models.pvrcnn.second import second_post_processing
from detmatch_tpu_torch.ops import spconv
from detmatch_tpu_torch.ops.voxelize import INVALID_KEY

PILLAR_VS = (0.5, 0.5, 4.0)
CFG = dict(num_classes=3, point_cloud_range=zf.PCR, voxel_size=PILLAR_VS,
           grid_size=(32, 32, 1), max_voxels=256)
SPEC = (zf.PCR, PILLAR_VS, 256, 32)
POST = dict(nms_pre=64, nms_post=16, score_thresh=0.1)
GROUPED = ("point_feats", "point_voxel_id", "point_contrib", "voxel_counts",
           "features", "coords", "keys")


def _fixed_to_dense(st, spatial_shape):
    """JAX's scatter in the voxelizer's own shape (Z + 1 = 2), z = 0."""
    z, y, x = spatial_shape
    return jspconv.to_dense_yxz(st, (z + 1, y, x)).transpose(2, 0, 1, 3)[:z]


@pytest.fixture(scope="module")
def pillars():
    pts, valid, gt = zf.scene(2)
    jv = zf.jax_voxelize(pts, valid, SPEC)
    pv = zf.port_voxelize(pts, valid, SPEC)
    jb = dict(pillars=jv, gt_boxes=jnp.asarray(gt))
    tb = dict(pillars=pv, gt_boxes=torch.from_numpy(gt))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jspconv, "to_dense", _fixed_to_dense)
        ref = zf.run_jax(jpp.PointPillars(**CFG), jb,
                         lambda o: jss(o, **POST))
    port = zf.run_port("PointPillar", CFG, ref, tb,
                       lambda o: second_post_processing(o, **POST))
    return dict(ref=ref, port=port, jv=jax.tree.map(np.asarray, jv), pv=pv)


def test_grouped_voxelize_view_matches_jax(pillars):
    """The per-point view the VFE reads, exactly, at 32 points a pillar."""
    for k in GROUPED:
        np.testing.assert_array_equal(pillars["pv"][k].numpy(),
                                      pillars["jv"][k], err_msg=k)
    assert pillars["jv"]["point_contrib"].sum() > 0


def test_pillar_features_and_eval(pillars):
    ref, port = pillars["ref"], pillars["port"]
    zf.check_dense(port["eval"], ref["eval"])
    for k in ("batch_box_preds", "batch_cls_preds"):
        assert zf.rel(port["eval"][k], ref["eval"][k]) <= zf.OUT_TOL, k
    zf.check_post(port["post"], ref["post"])


def test_train_losses_and_grads(pillars):
    ref, port = pillars["ref"], pillars["port"]
    zf.check_losses(port, ref)
    zf.check_grads("PointPillar", CFG, port, ref)
    vfe = port["frozen"]["grads"]["vfe.pfn_layers.0.linear.weight"]
    assert vfe.abs().max() > 0


def test_jax_scatter_misplaces_pillars(pillars):
    """JAX's Z = 1 scatter keeps fewer occupied BEV cells than there are
    pillars (those keyed past Y·X are dropped, the rest moved); the
    port's BEV input has one cell a pillar, at the pillar's (y, x)."""
    jv = pillars["jv"]
    feats = np.ones(jv["keys"].shape + (1,), np.float32)
    shape = (1, 32, 32)
    n = (jv["keys"] != INVALID_KEY).sum(1)
    bad = jax.vmap(jspconv.to_dense, (0, None))(
        jspconv.SparseTensor(jnp.asarray(feats), jnp.asarray(jv["keys"]),
                             jnp.asarray(n)), shape)
    assert (np.asarray(bad).reshape(2, -1).sum(1) < n).all()
    keys = torch.from_numpy(jv["keys"])
    good = spconv.to_dense(torch.from_numpy(feats), keys, (2, 32, 32))[:, 0]
    assert (good.reshape(2, -1).sum(1).numpy() == n).all()
    coords = jv["coords"][0][:n[0]]
    assert (good[0, coords[:, 1], coords[:, 2], 0] == 1).all()
