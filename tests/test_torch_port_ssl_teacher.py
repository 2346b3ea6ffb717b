"""CPU parity of the port's DetMatch teacher phase (``detmatch_tpu_torch/
ssl``) against the JAX package: the BoxSet ops, the augmentation
transforms, the 3D → 2D projection, the match costs, the fusion
Hungarian matching, and ``SSLDetector.teacher_pseudo_labels`` stage by
stage and whole, with every ConfThr switch.

The models are the tiny PV-RCNN and Faster R-CNN (``utils/tiny.py``) at
B=2, with seeded fan-in-scaled random weights made in numpy for the JAX
variable shapes and brought over by ``from_jax_ssl``. Continuous outputs
agree within RTOL of their largest magnitude, discrete ones (validity,
matched slots) exactly.

The 2D teacher stage is held to JAX's multiclass NMS on the port's own
pre-NMS boxes, and JAX's phase is handed the port's 2D stage output:
overlapping proposals of different pyramid levels get near-equal scores
from random weights, and 1e-6 noise between the two packages reorders
such ties at the NMS. The 3D stage and everything after the 2D stage run
independently in both packages.
"""
import functools
import inspect
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.core import geometry as jgeom  # noqa: E402
from detmatch_tpu.core import losses as jlosses  # noqa: E402
from detmatch_tpu.core import transforms as jtf  # noqa: E402
from detmatch_tpu.models.frcnn import roi_head2d as jroi  # noqa: E402
from detmatch_tpu.models.frcnn.faster_rcnn import (  # noqa: E402
    FasterRCNN as JFasterRCNN)
from detmatch_tpu.models.pvrcnn.pvrcnn import PVRCNN as JPVRCNN  # noqa: E402
from detmatch_tpu.ssl import boxset as jboxset  # noqa: E402
from detmatch_tpu.ssl import modules as jmodules  # noqa: E402
from detmatch_tpu.ssl.detector import SSLConfig as JSSLConfig  # noqa: E402
from detmatch_tpu.ssl.detector import (  # noqa: E402
    SSLDetector as JSSLDetector)
from detmatch_tpu.train.ssl_step import (  # noqa: E402
    voxelize_views as j_voxelize_views)
from detmatch_tpu.utils import tiny as jtiny  # noqa: E402
from detmatch_tpu_torch.apis.build import build_ssl  # noqa: E402
from detmatch_tpu_torch.convert import from_jax_ssl  # noqa: E402
from detmatch_tpu_torch.core import geometry, losses, transforms  # noqa: E402
from detmatch_tpu_torch.ops.voxelize import VoxelizerSpec  # noqa: E402
from detmatch_tpu_torch.ssl import boxset, modules  # noqa: E402
from detmatch_tpu_torch.ssl.detector import SSLConfig  # noqa: E402
from detmatch_tpu_torch.train.ssl_step import (  # noqa: E402
    to_device_views, voxelize_views)
from detmatch_tpu_torch.utils import tiny  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

RTOL = 1e-4
B = 2
L2I = np.array([[0, -700, 0, 6200], [0, 0, -700, 1800], [1, 0, 0, 0],
                [0, 0, 0, 1]], np.float32)
ORI = np.array([375.0, 1242.0], np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_close(out, ref, name):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(out), fin, err_msg=name)
    np.testing.assert_array_equal(out[~fin], ref[~fin], err_msg=name)
    if not fin.any():
        return
    scale = max(float(np.abs(ref[fin]).max()), 1e-6)
    err = float(np.abs(out[fin] - ref[fin]).max()) / scale
    assert err <= RTOL, f"{name}: relative error {err:.3e}"


def assert_boxset(ours, ref, name):
    np.testing.assert_array_equal(ours["valid"].numpy(),
                                  np.asarray(ref["valid"]), err_msg=name)
    for k in ("boxes", "scores"):
        assert_close(ours[k], ref[k], f"{name}.{k}")


# ---------------------------------------------------------------- data --

def boxes3d(rng, b, k):
    """Car-sized boxes in front of the camera of L2I."""
    out = np.zeros((b, k, 7), np.float32)
    out[..., 0] = rng.rand(b, k) * 30 + 8
    out[..., 1] = rng.rand(b, k) * 12 - 6
    out[..., 2] = -1.0
    out[..., 3:6] = [3.9, 1.6, 1.56]
    out[..., 6] = rng.rand(b, k) * 6 - 3
    return out


def random_set(rng, b, k, d, n_valid, c=3):
    boxes = boxes3d(rng, b, k) if d == 7 else None
    if d == 4:
        xy = rng.rand(b, k, 2) * np.array([1100.0, 300.0])
        boxes = np.concatenate([xy, xy + rng.rand(b, k, 2) * 120 + 10],
                               -1).astype(np.float32)
    scores = rng.rand(b, k, c).astype(np.float32)
    valid = np.arange(k)[None, :] < np.asarray(n_valid)[:, None]
    return dict(boxes=boxes, scores=scores, valid=valid)


def paired_sets(rng, b, k3, k2, n3, n2, noise=4.0):
    """A 3D set and a 2D set whose first min(n3, n2) valid boxes are the
    3D ones' projections (plus pixel noise) with similar scores, so most
    pairs pass the production cost threshold; the 2D slots are shuffled."""
    s3 = random_set(rng, b, k3, 7, n3)
    s2 = random_set(rng, b, k2, 4, n2)
    for i in range(b):
        proj, _ = jgeom.boxes_3d_to_2d(s3["boxes"][i], L2I)
        m = min(n3[i], n2[i])
        s2["boxes"][i, :m] = proj[:m] + rng.randn(m, 4) * noise
        s2["scores"][i, :m] = np.clip(
            s3["scores"][i, :m] + rng.randn(m, 3) * 0.05, 0.01, 0.99)
        perm = np.concatenate([rng.permutation(n2[i]),
                               np.arange(n2[i], k2)])
        for key in ("boxes", "scores"):
            s2[key][i] = s2[key][i][perm]
    return s3, s2


def aug3d(rng, b, identity=False):
    if identity:
        return dict(flip_x=np.zeros(b, np.float32),
                    rot=np.zeros(b, np.float32),
                    scale=np.ones(b, np.float32),
                    trans=np.zeros((b, 3), np.float32))
    return dict(flip_x=(np.arange(b) % 2).astype(np.float32),
                rot=(rng.rand(b) - 0.5).astype(np.float32),
                scale=(0.95 + 0.1 * rng.rand(b)).astype(np.float32),
                trans=(rng.randn(b, 3) * 0.2).astype(np.float32))


def aug2d(rng, b, img_w):
    s = (0.1 + 0.1 * rng.rand(b, 2)).astype(np.float32)
    return dict(scale=np.concatenate([s, s], 1),
                flip=((np.arange(b) + 1) % 2).astype(np.float32),
                img_w=np.full(b, img_w, np.float32))


def _to_port_aug(a, cls):
    return cls(**{k: _t(v) for k, v in a.items()})


# ----------------------------------------------------- boxset & friends --

def test_boxset_ops():
    rng = np.random.RandomState(0)
    s = random_set(rng, 3, 40, 4, [40, 17, 0])
    s["scores"][1, 5] = s["scores"][1, 3]  # a tie for topk
    ours = {k: _t(v) for k, v in s.items()}
    ref = _j(s)
    assert_boxset(boxset.max_score_filter(ours, 0.6),
                  jboxset.max_score_filter(ref, 0.6), "max_score_filter")
    idx = rng.randint(0, 40, (3, 25)).astype(np.int32)
    ok = rng.rand(3, 25) > 0.3
    assert_boxset(boxset.gather(ours, _t(idx), _t(ok)),
                  jboxset.gather(ref, jnp.asarray(idx), jnp.asarray(ok)),
                  "gather")
    other = random_set(rng, 3, 40, 4, [30, 40, 5])
    assert_boxset(boxset.average(ours, {k: _t(v) for k, v in other.items()}),
                  jboxset.average(ref, _j(other)), "average")
    assert float(boxset.num_valid(ours)) == float(jboxset.num_valid(ref))
    for k in (8, 25):
        assert_boxset(boxset.topk(ours, k), jboxset.topk(ref, k), "topk")
    assert all(torch.equal(a, b) for a, b in zip(
        boxset.detach(ours).values(), ours.values()))


def test_transforms_round_trip_and_parity():
    rng = np.random.RandomState(1)
    b3 = boxes3d(rng, 3, 10)
    a3 = aug3d(rng, 3)
    ours, ref = _to_port_aug(a3, transforms.Aug3D), jtf.Aug3D(**_j(a3))
    for fn, jfn in ((transforms.apply_aug3d_boxes, jtf.apply_aug3d_boxes),
                    (transforms.reverse_aug3d_boxes,
                     jtf.reverse_aug3d_boxes)):
        want = jax.vmap(jfn)(jnp.asarray(b3), ref)
        assert_close(fn(_t(b3), ours), want, fn.__name__)
    back = transforms.reverse_aug3d_boxes(
        transforms.apply_aug3d_boxes(_t(b3), ours), ours)
    assert_close(back, b3, "3d round trip")
    b2 = random_set(rng, 3, 10, 4, [10] * 3)["boxes"]
    a2 = aug2d(rng, 3, 128.0)
    ours, ref = _to_port_aug(a2, transforms.Aug2D), jtf.Aug2D(**_j(a2))
    for fn, jfn in ((transforms.apply_aug2d_boxes, jtf.apply_aug2d_boxes),
                    (transforms.reverse_aug2d_boxes,
                     jtf.reverse_aug2d_boxes)):
        want = jax.vmap(jfn)(jnp.asarray(b2), ref)
        assert_close(fn(_t(b2), ours), want, fn.__name__)


def test_boxset_transforms_and_projection():
    rng = np.random.RandomState(2)
    s3 = random_set(rng, 2, 12, 7, [12, 5])
    s3["boxes"][0, 0, 0] = -3.0  # behind the camera
    s3["boxes"][1, 1, 1] = 60.0  # outside the image
    l2i = np.tile(L2I[None], (2, 1, 1))
    ori = np.tile(ORI[None], (2, 1))
    ours = {k: _t(v) for k, v in s3.items()}
    a3 = aug3d(rng, 2)
    assert_boxset(modules.transform_3d(ours, _to_port_aug(
        a3, transforms.Aug3D), True), jmodules.transform_3d(
        _j(s3), jtf.Aug3D(**_j(a3)), True), "transform_3d")
    for shape in (ori, None):
        got = modules.boxes_3d_to_2d(ours, _t(l2i),
                                     None if shape is None else _t(shape))
        want = jmodules.boxes_3d_to_2d(_j(s3), jnp.asarray(l2i),
                                       None if shape is None
                                       else jnp.asarray(shape))
        assert_boxset(got, want, f"boxes_3d_to_2d shape={shape is None}")
    got, ok = geometry.boxes_3d_to_2d(ours["boxes"][0], _t(L2I), _t(ORI))
    want, wok = jgeom.boxes_3d_to_2d(jnp.asarray(s3["boxes"][0]),
                                     jnp.asarray(L2I), jnp.asarray(ORI))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(wok))
    assert not ok[0] and ok[1:].any()
    assert_close(got, want, "geometry.boxes_3d_to_2d")


def test_match_costs():
    rng = np.random.RandomState(3)
    l1 = rng.randn(9, 3).astype(np.float32) * 2
    l2 = rng.randn(7, 3).astype(np.float32) * 2
    l2[2] = l2[2, [1, 1, 0]]  # a tied argmax
    lbl = rng.randint(0, 3, 7)
    assert_close(losses.focal_loss_cost(_t(l1), _t(lbl), weight=2.0),
                 jlosses.focal_loss_cost(jnp.asarray(l1), jnp.asarray(lbl),
                                         weight=2.0), "focal_loss_cost")
    assert_close(losses.double_sided_focal_cost(_t(l1), _t(l2), weight=2.0),
                 jlosses.double_sided_focal_cost(jnp.asarray(l1),
                                                 jnp.asarray(l2), weight=2.0),
                 "double_sided_focal_cost")
    b1 = random_set(rng, 1, 9, 4, [9])["boxes"][0] / 1000
    b2 = random_set(rng, 1, 7, 4, [7])["boxes"][0] / 1000
    assert_close(losses.bbox_l1_cost(_t(b1), _t(b2), weight=5.0),
                 jlosses.bbox_l1_cost(jnp.asarray(b1), jnp.asarray(b2),
                                      weight=5.0), "bbox_l1_cost")
    assert_close(losses.giou_cost(_t(b1), _t(b2), weight=2.0),
                 jlosses.giou_cost(jnp.asarray(b1), jnp.asarray(b2),
                                   weight=2.0), "giou_cost")


# ------------------------------------------------ fusion hungarian match --

def fusion_case(name):
    """(3D set, 2D set, cost_thr) of each case, made in numpy."""
    rng = np.random.RandomState(sorted(FUSION_CASES).index(name) + 10)
    if name == "orientations":  # nr < nc, nr > nc, equal
        s3, s2 = paired_sets(rng, 3, 20, 30, [10, 14, 9], [16, 6, 9])
        return s3, s2, -1.5
    if name == "empty_sets":  # no 3D box; no 2D box
        s3, s2 = paired_sets(rng, 2, 20, 30, [0, 12], [8, 0])
        return s3, s2, -1.5
    if name == "all_rejected":
        s3, s2 = paired_sets(rng, 2, 20, 30, [10, 7], [12, 9])
        return s3, s2, -100.0
    if name == "no_threshold":
        s3, s2 = paired_sets(rng, 2, 20, 30, [10, 7], [4, 9], noise=60.0)
        return s3, s2, None
    # more than 128 valid slots in both sets: both are compacted to their
    # top 128 before the 128 x 128 assignment
    s3, s2 = paired_sets(rng, 2, 200, 160, [150, 131], [140, 160])
    return s3, s2, -1.5


FUSION_CASES = ("orientations", "empty_sets", "all_rejected",
                "no_threshold", "over_128")


@functools.lru_cache()
def _jax_fusion(cost_thr):
    return jax.jit(functools.partial(jmodules.fusion_hungarian_matching,
                                     cost_thr=cost_thr))


@pytest.mark.parametrize("name", FUSION_CASES)
def test_fusion_hungarian_matching(name):
    s3, s2, thr = fusion_case(name)
    b = s3["valid"].shape[0]
    l2i = np.tile(L2I[None], (b, 1, 1))
    ori = np.tile(ORI[None], (b, 1))
    w3, w2, wcost = _jax_fusion(thr)(_j(s3), _j(s2), jnp.asarray(l2i),
                                     jnp.asarray(ori))
    o3, o2, ocost = modules.fusion_hungarian_matching(
        {k: _t(v) for k, v in s3.items()}, {k: _t(v) for k, v in s2.items()},
        _t(l2i), _t(ori), cost_thr=thr)
    assert_boxset(o3, w3, "matched 3D")
    assert_boxset(o2, w2, "matched 2D")
    assert_close(ocost, wcost, "match cost")
    n = o3["valid"].sum(1).tolist()
    if name in ("all_rejected",):
        assert n == [0] * b
    elif name == "empty_sets":
        assert n == [0, 0]
    else:
        assert min(n) > 0, n


# ------------------------------------------------------- teacher phase --

def _fan_in_random(shapes, rng):
    def make(path, s):
        k = path[-1].key
        if k == "var":
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        if k == "mean":
            return (0.2 * rng.randn(*s.shape)).astype(np.float32)
        if k == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if len(s.shape) == 1:
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(make, shapes)


def _views(seed):
    rng = np.random.RandomState(seed)
    batch = dict(unlab=dict(stu=tiny.tiny_view(rng, b=B),
                            tea=tiny.tiny_view(rng, b=B)))
    # the teacher image is a resize of the 375 x 1242 original, so its
    # boxes de-augment into the frame the 3D boxes project to
    sx, sy = 128.0 / 1242.0, 64.0 / 375.0
    batch["unlab"]["tea"]["aug2d"] = dict(
        scale=np.tile(np.array([[sx, sy, sx, sy]], np.float32), (B, 1)),
        flip=np.array([0.0, 1.0], np.float32),
        img_w=np.full(B, 128.0, np.float32))
    batch["unlab"]["tea"]["aug3d"] = aug3d(rng, B)
    batch["unlab"]["tea"]["aug3d"]["scale"][:] = 1.0
    batch["unlab"]["stu"]["aug3d"] = aug3d(rng, B)
    batch["unlab"]["stu"]["aug2d"] = dict(
        scale=np.tile(np.array([[sx, sy, sx, sy]], np.float32), (B, 1)),
        flip=np.array([1.0, 0.0], np.float32),
        img_w=np.full(B, 128.0, np.float32))
    return batch


def _jax_views(batch):
    def view(v):
        out = {k: jnp.asarray(a) for k, a in v.items()
               if k not in ("aug3d", "aug2d")}
        out["aug3d"] = jtf.Aug3D(**_j(v["aug3d"]))
        out["aug2d"] = jtf.Aug2D(**_j(v["aug2d"]))
        return out
    return {s: {k: view(v) for k, v in d.items()} for s, d in batch.items()}


@pytest.fixture(scope="module")
def phase():
    """Weights, the voxelized views of both packages, the JAX 3D teacher
    stage and the port's SSL detector."""
    batch = _views(0)
    jb = j_voxelize_views(_jax_views(batch), jtiny.TINY_SPEC)
    tea = jb["unlab"]["tea"]
    pv = JPVRCNN(**jtiny.TINY_PV_CFG)
    fr = JFasterRCNN(**jtiny.TINY_FR_CFG)
    keys3 = ("points", "points_valid", "voxel_features", "voxel_keys")
    s3 = jax.eval_shape(lambda bt: pv.init(
        {"params": jax.random.PRNGKey(0)}, bt, train=False),
        {k: tea[k] for k in keys3})
    s2 = jax.eval_shape(lambda i, s: fr.init(jax.random.PRNGKey(1), i, s),
                        tea["img"], tea["img_shape"])
    rng = np.random.RandomState(1)
    v3 = _fan_in_random(s3, rng)
    v2 = _fan_in_random(s2, rng)
    # spread the class logits away from their rare-class priors
    v3["params"]["dense_head"]["conv_cls"]["bias"] = (
        0.5 * rng.randn(18)).astype(np.float32)
    v3["params"]["dense_head"]["conv_box"]["kernel"] *= 0.1
    v2["params"]["bbox_head"]["fc_cls"]["bias"] = (
        0.5 * rng.randn(4)).astype(np.float32)
    state = dict(det3d=v3, det2d=v2)
    jssl = JSSLDetector(pv, fr, JSSLConfig())
    j3d = _np(jax.jit(jssl._det3d_teacher_boxes)(_j(v3), tea))
    cfg = dict(model=dict(detector_3d=tiny.TINY_PV_CFG,
                          detector_2d=tiny.TINY_FR_CFG))
    model = build_ssl(cfg, device="cpu")
    model.load_state_dict(from_jax_ssl(dict(student=state, teacher=state),
                                       tiny.TINY_PV_CFG, tiny.TINY_FR_CFG))
    pb = voxelize_views(to_device_views(batch, "cpu"),
                        VoxelizerSpec(**tiny.TINY_SPEC))
    return dict(jb=jb, j3d=j3d, pv=pv, fr=fr, model=model, pb=pb)


def test_views_and_voxels_match_jax(phase):
    for name in ("tea", "stu"):
        ours, ref = phase["pb"]["unlab"][name], phase["jb"]["unlab"][name]
        np.testing.assert_array_equal(ours["img"].permute(0, 2, 3, 1).numpy(),
                                      np.asarray(ref["img"]))
        np.testing.assert_array_equal(ours["voxel_keys"].numpy(),
                                      np.asarray(ref["voxel_keys"]))
        np.testing.assert_array_equal(ours["voxel_dropped"].numpy(),
                                      np.asarray(ref["voxel_dropped"]))
        assert_close(ours["voxel_features"], ref["voxel_features"],
                     "voxel_features")


def test_teacher_3d_stage(phase):
    with torch.inference_mode():
        ours = phase["model"]._det3d_teacher_boxes(phase["pb"]["unlab"]["tea"])
    assert_boxset(ours, phase["j3d"], "3D teacher boxes")
    assert (ours["valid"] & (ours["scores"].amax(-1) > 0.1)).any()


def _port_2d_stage(phase):
    with torch.inference_mode():
        return phase["model"]._det2d_teacher_boxes(
            phase["pb"]["unlab"]["tea"], SSLConfig().nms_2d_cfg)


def test_teacher_2d_stage(phase):
    """SimpleTest_2D + NMS + background strip equals JAX's multiclass NMS
    on the port's own pre-NMS boxes and scores."""
    tea = phase["pb"]["unlab"]["tea"]
    ours = _port_2d_stage(phase)
    with torch.inference_mode():
        pre = phase["model"].teacher["det2d"].simple_test(
            tea["img"], tea["img_shape"], with_nms=False)
    score_thr, iou_thr, max_num = SSLConfig().nms_2d_cfg
    for b in range(B):
        want = _np(jroi.multiclass_nms_2d(
            jnp.asarray(pre["boxes"][b].numpy()),
            jnp.asarray(pre["scores"][b].numpy()), score_thr, iou_thr,
            max_num))
        np.testing.assert_array_equal(ours["valid"][b].numpy(),
                                      want["valid"])
        np.testing.assert_array_equal(ours["boxes"][b].numpy(),
                                      want["boxes"])
        np.testing.assert_array_equal(ours["scores"][b].numpy(),
                                      want["scores_full"][:, :-1])
    assert ours["valid"].sum() > 0


SWITCHES = {
    "detmatch": dict(),
    "detmatch_loose_threshold": dict(cost_thr=50.0),
    "confthr_no_fusion": dict(fusion=False),
    "confthr_3d_only": dict(fusion=False, enable_2d=False),
    "confthr_2d_only": dict(fusion=False, enable_3d=False),
}


@pytest.mark.parametrize("name", sorted(SWITCHES))
def test_teacher_pseudo_labels(phase, name):
    """The whole phase through the port's entry point, against JAX's with
    its 3D stage computed by JAX and its 2D stage handed the port's."""
    sw = SWITCHES[name]
    model = phase["model"]
    model.cfg = SSLConfig(**sw)
    with torch.inference_mode():
        ours = model.teacher_pseudo_labels(phase["pb"])
    p2d = {k: jnp.asarray(v.numpy()) for k, v in
           _port_2d_stage(phase).items()}
    jssl = JSSLDetector(phase["pv"], phase["fr"], JSSLConfig(**sw))
    j3d = _j(phase["j3d"])
    jssl._det3d_teacher_boxes = lambda variables, view: j3d
    jssl._det2d_teacher_boxes = lambda variables, view, cfg: p2d
    want = _np(jax.jit(jssl.teacher_pseudo_labels)(
        dict(det3d={}, det2d={}), phase["jb"]))
    keys = [k for k in ("m3d_stu", "m2d_stu", "m2d_clean") if k in want]
    assert sorted(k for k in ours if k != "logs") == sorted(keys)
    for k in keys:
        assert_boxset(ours[k], want[k], k)
    if sw.get("fusion", True):
        np.testing.assert_allclose(
            float(ours["logs"]["metrics.num_tea_hung"]),
            float(want["logs"]["metrics.num_tea_hung"]))
    n = sum(int(ours[k]["valid"].sum()) for k in keys)
    if name == "detmatch":
        print(f"matched at cost_thr -1.5: {n // 3}")
    else:
        assert n > 0, name


def test_build_ssl_defaults_to_the_card():
    """No ``device`` means the card for both detectors of student and
    teacher; here, without one, that raises instead of falling back to
    the CPU. The teacher is a copy, not an alias, and takes no
    gradients."""
    assert inspect.signature(build_ssl).parameters["device"].default == \
        "cuda"
    cfg = dict(model=dict(detector_3d=tiny.TINY_PV_CFG,
                          detector_2d=tiny.TINY_FR_CFG))
    if torch.cuda.is_available():
        model = build_ssl(cfg)
        assert all(p.is_cuda for p in model.parameters())
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build_ssl(cfg)
    model = build_ssl(cfg, device="cpu")
    assert not model.training
    s_w = model.student["det2d"].backbone.conv1.weight
    t_w = model.teacher["det2d"].backbone.conv1.weight
    assert torch.equal(s_w, t_w) and s_w.data_ptr() != t_w.data_ptr()
    assert not any(p.requires_grad for p in model.teacher.parameters())
