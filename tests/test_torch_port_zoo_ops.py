"""CPU parity of the zoo's ops and building blocks in the port against
the JAX package: the UNet's
inverse conv (on K1's twin, as the UNet runs it), sparse max pooling,
the dense scatter, RoI-aware pooling (both methods), RoI point pooling,
3-NN and its interpolation, the point-anchored box coder, the
multi-group anchor head, the registry and ``convert.FROM_JAX``.

Tolerances: discrete outputs exactly (the grouped view, keys, pool index
sets through their pooled values' supports, 3-NN indices, the empty
flags); convs within 1e-5 of the output's largest magnitude (fp32 sums
in another order); pooled and interpolated values and the coder within
1e-6 absolute; the anchor head's outputs, targets and losses within
1e-5 of their largest magnitude.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.core.coders import PointResidualCoder as JCoder  # noqa
from detmatch_tpu.models.pvrcnn.anchor_head_multi import (  # noqa: E402
    AnchorHeadMulti as JMulti)
from detmatch_tpu.models.pvrcnn.pvrcnn import (  # noqa: E402
    DEFAULT_ANCHOR_CONFIGS)
from detmatch_tpu.ops import pointnet as jpointnet  # noqa: E402
from detmatch_tpu.ops import spconv as jspconv  # noqa: E402
from detmatch_tpu.ops import roiaware_pool as jroiaware  # noqa: E402
from detmatch_tpu.ops import roipoint_pool as jroipoint  # noqa: E402
from detmatch_tpu_torch.apis.build import DETECTORS, build_detector  # noqa
from detmatch_tpu_torch.convert import (FROM_JAX,  # noqa: E402
                                        from_jax_anchor_head_multi)
from detmatch_tpu_torch.core.coders import PointResidualCoder  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.anchor_head_multi import (  # noqa
    AnchorHeadMulti)
from detmatch_tpu_torch.ops import pointnet, spconv  # noqa: E402
from detmatch_tpu_torch.ops.cuda import KERNELS  # noqa: E402
from detmatch_tpu_torch.ops.roiaware_pool import (  # noqa: E402
    roiaware_pool_capped)
from detmatch_tpu_torch.ops.roipoint_pool import roipoint_pool  # noqa: E402
from detmatch_tpu_torch.ops.voxelize import INVALID_KEY  # noqa: E402
import torch_port_zoo_fixture as zf  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

CONV_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def levels():
    """The tiny scene's level-1 keys and the stride-2 level above them
    (the UNet's conv2 geometry), in both packages."""
    pts, valid, _ = zf.scene(6)
    vox = zf.jax_voxelize(pts, valid, zf.VOX)
    keys = np.asarray(vox["keys"])
    shape1 = (41, 32, 32)
    geom = ((3, 3, 3), (2, 2, 2), (1, 1, 1))
    shape2 = jspconv.output_spatial_shape(shape1, *geom)
    k2, _ = jspconv.downsample_keys_batched(jnp.asarray(keys), shape1,
                                            shape2, *geom, 384)
    return dict(keys1=keys, keys2=np.asarray(k2), shape1=shape1,
                shape2=shape2, geom=geom)


def test_inverse_neighbor_keys_and_conv(levels):
    """The inverse conv's neighbour keys exactly; the conv through the
    UNet's route (``window_key_conv_batched`` on the coarse table, its
    twin here) and through ``sparse_inverse_conv_batched`` against
    JAX's; no coarse row repeats within a tap."""
    lv = levels
    args = (lv["shape1"], lv["shape2"], *lv["geom"])
    jn = jspconv.inverse_neighbor_keys(jnp.asarray(lv["keys1"]), *args)
    tn = spconv.inverse_neighbor_keys(_t(lv["keys1"]), *args)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    rb = spconv.rulebook_batched(_t(lv["keys2"]), tn)
    for b in range(rb.shape[0]):
        for k in range(rb.shape[2]):
            rows = rb[b, :, k][rb[b, :, k] >= 0]
            assert len(rows.unique()) == len(rows)
    assert (rb >= 0).sum() > 0
    rng = np.random.RandomState(0)
    feats = rng.randn(2, lv["keys2"].shape[1], 64).astype(np.float32)
    feats[lv["keys2"] == INVALID_KEY] = 0.0
    w = (rng.randn(27, 64, 32) * 0.1).astype(np.float32)
    want = np.asarray(jspconv.sparse_inverse_conv_batched(
        jnp.asarray(feats), jnp.asarray(lv["keys2"]),
        jnp.asarray(lv["keys1"]), *args, jnp.asarray(w)))
    band = int(np.prod(lv["shape2"])) + 1
    got = KERNELS.window_key_conv_batched(_t(feats), _t(lv["keys2"]), tn,
                                          _t(lv["keys1"]), _t(w), band)
    plain = spconv.sparse_inverse_conv_batched(
        _t(feats), _t(lv["keys2"]), _t(lv["keys1"]), *args, _t(w))
    for out in (got, plain):
        assert zf.rel(out, want) <= CONV_TOL


def test_sparse_maxpool_and_to_dense(levels):
    lv = levels
    rng = np.random.RandomState(1)
    feats = rng.randn(2, lv["keys1"].shape[1], 8).astype(np.float32)
    jf, jk, jc = jspconv.sparse_maxpool_batched(
        jnp.asarray(feats), jnp.asarray(lv["keys1"]), lv["shape1"],
        *lv["geom"], 300)
    tf, tk, tc = spconv.sparse_maxpool_batched(
        _t(feats), _t(lv["keys1"]), lv["shape1"], *lv["geom"], 300)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert int(tc.max()) == 300  # the cap binds
    dense = spconv.to_dense(_t(feats), _t(lv["keys1"]), lv["shape1"])
    jd = jax.vmap(jspconv.to_dense, (0, None))(
        jspconv.SparseTensor(jnp.asarray(feats), jnp.asarray(lv["keys1"]),
                             jnp.zeros(2, jnp.int32)), lv["shape1"])
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jd))


@pytest.fixture(scope="module")
def boxes_scene():
    """B=2: 600 points (the last 80 of frame 1 padding), 12 boxes a
    frame, three of them empty (far away) and two the same box."""
    rng = np.random.RandomState(2)
    pts = (rng.rand(2, 600, 3) * [20, 16, 4] + [0, -8, -3]).astype(
        np.float32)
    valid = np.ones((2, 600), bool)
    valid[1, 520:] = False
    boxes = np.concatenate([
        rng.rand(2, 12, 3) * [18, 14, 2] + [1, -7, -2.5],
        rng.rand(2, 12, 3) * [3, 2, 1.5] + [1.5, 1, 1],
        rng.rand(2, 12, 1) * 6 - 3], -1).astype(np.float32)
    boxes[:, 9:, 0] += 100.0  # empty
    boxes[:, 1] = boxes[:, 0]
    feats = rng.randn(2, 600, 5).astype(np.float32)
    return pts, valid, boxes, feats


@pytest.mark.parametrize("method", ["max", "avg"])
def test_roiaware_pool_capped(boxes_scene, method):
    """The capped RoI-aware pool against JAX's one-hot first-K, with a
    cap that binds (max_pts 8 of up to ~60 in-box points)."""
    pts, valid, boxes, feats = boxes_scene
    want = jax.vmap(lambda b, p, f, v: jroiaware.roiaware_pool_capped(
        b, p, f, v, grid_size=4, max_pts=8, method=method))(
        jnp.asarray(boxes), jnp.asarray(pts), jnp.asarray(feats),
        jnp.asarray(valid))
    got = roiaware_pool_capped(_t(boxes), _t(pts), _t(feats), _t(valid),
                               grid_size=4, max_pts=8, method=method)
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (want[:, 9:] == 0).all() and (want[:, :9] != 0).any()


def test_roipoint_pool(boxes_scene):
    """First-K in-box points with the repeat of the first and the empty
    flag, enlarged boxes, K above and below the in-box counts."""
    pts, valid, boxes, feats = boxes_scene
    for k in (16, 128):
        jp, je = jax.vmap(lambda b, p, f, v: jroipoint.roipoint_pool(
            b, p, f, v, num_sampled=k, extra_width=(0.2, 0.2, 0.2)))(
            jnp.asarray(boxes), jnp.asarray(pts), jnp.asarray(feats),
            jnp.asarray(valid))
        tp, te = roipoint_pool(_t(boxes), _t(pts), _t(feats), _t(valid),
                               num_sampled=k, extra_width=(0.2, 0.2, 0.2))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert te[:, 9:].all() and not te[:, :9].all()


def test_three_nn_and_interpolate():
    """Ties (duplicated points) go to the lower index; invalid queries
    and fewer than three valid points, as JAX's."""
    rng = np.random.RandomState(3)
    pts = rng.rand(2, 40, 3).astype(np.float32)
    pts[:, 20:24] = pts[:, 10:14]  # exact ties
    valid = np.ones((2, 40), bool)
    valid[1, 2:] = False  # two valid points only
    q = rng.rand(2, 70, 3).astype(np.float32)
    q[:, :4] = pts[:, 10:14]
    qv = np.ones((2, 70), bool)
    qv[0, 60:] = False
    jd, ji = jax.vmap(jpointnet.three_nn)(jnp.asarray(q), jnp.asarray(qv),
                                          jnp.asarray(pts),
                                          jnp.asarray(valid))
    td, ti = pointnet.three_nn(_t(q), _t(qv), _t(pts), _t(valid), chunk=32)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    feats = rng.randn(2, 40, 6).astype(np.float32)
    jout = jax.vmap(jpointnet.three_interpolate)(jnp.asarray(feats), ji, jd)
    tout = pointnet.three_interpolate(_t(feats), ti, td)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-6)


def test_point_residual_coder():
    rng = np.random.RandomState(4)
    gt = np.concatenate([rng.randn(50, 3) * 5,
                         rng.rand(50, 3) * 3 + 0.5,
                         rng.rand(50, 1) * 6 - 3], -1).astype(np.float32)
    pts = (gt[:, :3] + rng.randn(50, 3)).astype(np.float32)
    cls = rng.randint(1, 4, 50)
    for use_mean in (True, False):
        jc, tc = JCoder(use_mean_size=use_mean), PointResidualCoder(
            use_mean_size=use_mean)
        je = np.asarray(jc.encode(jnp.asarray(gt), jnp.asarray(pts),
                                  jnp.asarray(cls)))
        te = tc.encode(_t(gt), _t(pts), _t(cls))
        np.testing.assert_allclose(te.numpy(), je, rtol=0, atol=1e-6)
        dec = tc.decode(te, _t(pts), _t(cls))
        jdec = np.asarray(jc.decode(jnp.asarray(je), jnp.asarray(pts),
                                    jnp.asarray(cls)))
        np.testing.assert_allclose(dec.numpy(), jdec, rtol=0, atol=1e-5)
        np.testing.assert_allclose(dec.numpy(), gt, rtol=0, atol=1e-4)


def test_anchor_head_multi():
    """Forward, targets, losses and the decode, groups ((Car,),
    (Pedestrian, Cyclist)); off-group logits stay -1e9."""
    kw = dict(num_classes=3, point_cloud_range=(0, -8, -3, 16, 8, 1),
              grid_size=(32, 32, 40), anchor_configs=DEFAULT_ANCHOR_CONFIGS)
    groups = (("Car",), ("Pedestrian", "Cyclist"))
    jhead = JMulti(head_groups=groups, **kw)
    rng = np.random.RandomState(5)
    bev = rng.randn(2, 4, 4, 32).astype(np.float32)
    v = jax.jit(jhead.init)(jax.random.PRNGKey(0), jnp.asarray(bev))
    gt = np.zeros((2, 4, 8), np.float32)
    gt[:, 0] = [5, 0, -1, 3.9, 1.6, 1.56, 0.2, 3]
    gt[:, 1] = [10, -3, -0.6, 0.8, 0.6, 1.73, 1.0, 1]
    jp = jax.jit(jhead.apply)(v, jnp.asarray(bev))
    # op by op: see torch_port_zoo_fixture.run_jax on jitted targets
    jt = jhead.apply(v, jnp.asarray(gt), method=JMulti.targets)
    jl, (jb, jc) = jax.jit(lambda p, t: (
        jhead.apply(v, p, t, method=JMulti.loss),
        jhead.apply(v, p, method=JMulti.decode_boxes)))(jp, jt)

    head = AnchorHeadMulti(32, head_groups=groups, **kw)
    head.load_state_dict(from_jax_anchor_head_multi(v["params"], key=None))
    tp = head(_t(bev).permute(0, 3, 1, 2))
    for k in ("cls_preds", "box_preds", "dir_preds"):
        assert zf.rel(tp[k].detach(), jp[k]) <= CONV_TOL, k
    cp = tp["cls_preds"].detach().numpy().reshape(2, 16, 3, 2, 3)
    assert (cp[:, :, 2, :, 0] <= -1e8).all()  # Car anchor, Ped logit
    tt = head.targets(_t(gt))
    np.testing.assert_array_equal(tt[0].numpy(), np.asarray(jt[0]))
    np.testing.assert_allclose(tt[1].numpy(), np.asarray(jt[1]), atol=1e-6)
    tl = head.loss(tp, tt)
    for k, want in jl.items():
        assert abs(float(tl[k]) - float(want)) <= 1e-5 * abs(float(want)), k
    tb, tc = head.decode_boxes(tp)
    assert zf.rel(tb.detach(), jb) <= CONV_TOL


ZOO = ("SECOND", "SECONDNetIoU", "PointPillar", "PartA2Net", "VoxelRCNN",
       "PointRCNN")


@pytest.mark.parametrize("kind", ZOO)
def test_registry_builds_zoo_on_device(kind):
    """``build_detector`` builds each zoo type under JAX's registry name,
    on the device it is given, in eval mode, with the kernel ops."""
    model = build_detector({"model": {"detector_3d": dict(type=kind)}},
                           device="cpu")
    assert isinstance(model, DETECTORS[kind]) and not model.training
    assert model.ops is KERNELS
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_registry_refuses_caddn_and_unknown():
    """CaDDN, once refused, now builds (as ``detector_3d`` under its
    registry name, and as the monocular demo's ``detector_mono`` by
    default) on the CPU in eval mode; an unknown name still raises."""
    for key, det in (("detector_3d", dict(type="CaDDN")),
                     ("detector_mono", {})):
        model = build_detector({"model": {key: det}}, device="cpu", key=key)
        assert isinstance(model, DETECTORS["CaDDN"]) and not model.training
        assert all(p.device.type == "cpu" for p in model.parameters())
    with pytest.raises(KeyError):
        build_detector({"model": {"detector_3d": dict(type="Nope")}},
                       device="cpu")


class _Reads(dict):
    """A params tree that records the leaves a converter reads."""

    def __init__(self, tree, seen, path=()):
        super().__init__()
        for k, v in tree.items():
            self[k] = (_Reads(v, seen, path + (k,)) if isinstance(v, dict)
                       else v)
        self.seen, self.path = seen, path

    def __getitem__(self, k):
        v = dict.__getitem__(self, k)
        if not isinstance(v, dict):
            self.seen.add(self.path + (k,))
        return v


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,)


@pytest.mark.parametrize("kind", ZOO[:-1])
def test_convert_covers_every_leaf(kind):
    """``FROM_JAX[kind]`` fills every tensor of the port's model (a
    strict load) and reads every JAX leaf, each into a tensor of the
    same number of elements (full widths, JAX's shapes from
    ``jax.eval_shape``; no program is compiled)."""
    from detmatch_tpu.models.pvrcnn import (parta2, pointpillars, second,
                                            voxelrcnn)
    jcls = dict(SECOND=second.SECOND, SECONDNetIoU=second.SECONDIoU,
                PointPillar=pointpillars.PointPillars,
                PartA2Net=parta2.PartA2, VoxelRCNN=voxelrcnn.VoxelRCNN)[kind]
    cfg = (dict(zf.CFG) if kind != "PointPillar" else
           dict(num_classes=3, point_cloud_range=zf.PCR,
                voxel_size=(0.5, 0.5, 4.0), grid_size=(32, 32, 1),
                max_voxels=256))
    if kind == "PointPillar":
        pts, valid, gt = zf.scene(0)
        batch = dict(pillars=zf.jax_voxelize(pts, valid, (
            zf.PCR, (0.5, 0.5, 4.0), 256, 32)), gt_boxes=jnp.asarray(gt))
    else:
        pts, valid, gt = zf.scene(0)
        batch = zf.voxel_batches(pts, valid, gt)[0]
    v = zf.random_variables(jcls(**cfg), batch, 0, ())
    seen = set()
    sd = FROM_JAX[kind](_Reads(v["params"], seen),
                        _Reads(v.get("batch_stats", {}), seen), cfg)
    model = build_detector({"model": {"detector_3d": dict(type=kind,
                                                           **cfg)}}, "cpu")
    model.load_state_dict(sd)  # strict
    leaves = set(_leaves(v["params"])) | set(_leaves(v.get("batch_stats",
                                                           {})))
    assert leaves == seen, leaves ^ seen
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(v))
    n_port = sum(t.numel() for k, t in sd.items()
                 if not k.endswith("num_batches_tracked"))
    assert n_jax == n_port
