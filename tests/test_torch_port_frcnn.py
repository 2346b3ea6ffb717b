"""CPU parity of the port's Faster R-CNN (``detmatch_tpu_torch/models/
frcnn``) and its 2D ops against the JAX package.

The model is ``TINY_FR_CFG`` (64 x 128 canvas, ``stage_blocks=(1, 1, 1,
1)``) at B=2, with JAX ``init`` weights, randomized FrozenBN statistics
and a randomized classifier (so that boxes pass the score threshold),
brought over by ``from_jax_frcnn``. Each stage is fed the JAX model's own
inputs to it. Continuous outputs agree within RTOL of their largest
magnitude; discrete ones exactly. The NMS'd output is held to JAX's NMS
on the port's own pre-NMS boxes: random weights give near-equal scores
to overlapping proposals, and 1e-6 noise would reorder those ties.
"""
import functools
import importlib.util
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.core import coders as jcoders  # noqa: E402
from detmatch_tpu.core import iou as jiou  # noqa: E402
from detmatch_tpu.core import nms as jnms  # noqa: E402
from detmatch_tpu.models.frcnn import roi_head2d as jroi  # noqa: E402
from detmatch_tpu.models.frcnn.faster_rcnn import (  # noqa: E402
    FasterRCNN as JFasterRCNN)
from detmatch_tpu.ops import roialign as jroialign  # noqa: E402
from detmatch_tpu.utils import tiny as jtiny  # noqa: E402
from detmatch_tpu_torch.apis.build import build_detector  # noqa: E402
from detmatch_tpu_torch.convert import from_jax_frcnn  # noqa: E402
from detmatch_tpu_torch.core import coders, iou, nms  # noqa: E402
from detmatch_tpu_torch.models.frcnn.faster_rcnn import (  # noqa: E402
    FasterRCNN)
from detmatch_tpu_torch.models.frcnn.roi_head2d import (  # noqa: E402
    decode_rcnn)
from detmatch_tpu_torch.ops import roialign  # noqa: E402
from detmatch_tpu_torch.utils import tiny  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

RTOL = 1e-4
CFG = tiny.TINY_FR_CFG
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def nchw(a):
    return _t(np.asarray(a).transpose(0, 3, 1, 2))


def assert_close(out, ref, name):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(out - ref).max()) / scale
    assert err <= RTOL, f"{name}: relative error {err:.3e}"


def randomize(variables, seed=1):
    """FrozenBN statistics and affines away from the identity; the RoI
    classifier from its -4.6 prior bias to spread logits."""
    rng = np.random.RandomState(seed)

    def stat(path, x):
        k = path[-1].key
        if k == "var":
            return (0.5 + rng.rand(*x.shape)).astype(np.float32)
        if k == "scale":
            return (1.0 + 0.1 * rng.randn(*x.shape)).astype(np.float32)
        return (0.1 * rng.randn(*x.shape)).astype(np.float32)

    frozen = jax.tree_util.tree_map_with_path(stat, _np(variables["frozen"]))
    params = _np(variables["params"])
    cls = params["bbox_head"]["fc_cls"]
    cls["bias"] = (0.5 * rng.randn(*cls["bias"].shape)).astype(np.float32)
    cls["kernel"] = (0.05 * rng.randn(*cls["kernel"].shape)
                     ).astype(np.float32)
    return params, frozen


@functools.lru_cache()
def converter():
    spec = importlib.util.spec_from_file_location(
        "import_torch_ckpt", os.path.join(
            ROOT, "tools", "model_converters", "import_torch_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    rng = np.random.RandomState(0)
    img = rng.randn(2, *tiny.TINY_CANVAS, 3).astype(np.float32)
    shapes = np.array([[64.0, 128.0], [60.0, 110.0]], np.float32)
    model = JFasterRCNN(**jtiny.TINY_FR_CFG)
    var = jax.jit(lambda i, s: model.init(jax.random.PRNGKey(0), i, s))(
        jnp.asarray(img), jnp.asarray(shapes))
    params, frozen = randomize(var)
    v = {"params": params, "frozen": frozen}
    fwd, inter = jax.jit(lambda v, i, s: model.apply(
        v, i, s, capture_intermediates=True, mutable=["intermediates"]))(
        v, jnp.asarray(img), jnp.asarray(shapes))
    cls, reg = jax.jit(lambda v, f, r: model.apply(
        v, f, r, method=JFasterRCNN.roi_forward))(v, fwd["feats"],
                                                   fwd["proposals"])
    no_nms = jax.jit(lambda v, i, s: model.apply(
        v, i, s, 0.05, 0.5, 100, False, method=JFasterRCNN.simple_test))(
        v, jnp.asarray(img), jnp.asarray(shapes))
    return dict(img=img, shapes=shapes, params=params, frozen=frozen,
                fwd=_np(fwd), cls=np.asarray(cls), reg=np.asarray(reg),
                no_nms=_np(no_nms),
                backbone=_np(inter["intermediates"]["backbone"]
                             ["__call__"][0]))


@pytest.fixture(scope="module")
def port(ref):
    model = build_detector(dict(model=dict(detector_2d=CFG)), device="cpu",
                           key="detector_2d")
    model.load_state_dict(from_jax_frcnn(ref["params"], ref["frozen"], CFG))
    return model


@pytest.fixture(scope="module")
def port_fwd(ref, port):
    with torch.no_grad():
        return port(nchw(ref["img"]), _t(ref["shapes"]))


def test_backbone_stages(ref, port):
    with torch.no_grad():
        outs = port.backbone(nchw(ref["img"]))
    assert len(outs) == 4
    for i, (o, r) in enumerate(zip(outs, ref["backbone"])):
        assert_close(o.permute(0, 2, 3, 1), r, f"C{i + 2}")


def test_fpn_levels(ref, port):
    with torch.no_grad():
        outs = port.neck([nchw(c) for c in ref["backbone"]])
    for i, (o, r) in enumerate(zip(outs, ref["fwd"]["feats"])):
        assert_close(o.permute(0, 2, 3, 1), r, f"P{i + 2}")


def test_rpn_and_proposals(ref, port_fwd):
    for lvl, ((c, r), (jc, jr)) in enumerate(zip(port_fwd["rpn_outs"],
                                                 ref["fwd"]["rpn_outs"])):
        assert_close(c, jc, f"rpn_cls{lvl}")
        assert_close(r, jr, f"rpn_reg{lvl}")
    assert_close(port_fwd["proposals"], ref["fwd"]["proposals"], "proposals")
    np.testing.assert_array_equal(
        port_fwd["proposal_scores"].numpy() > -1e9,
        ref["fwd"]["proposal_scores"] > -1e9)
    assert_close(port_fwd["proposal_scores"], ref["fwd"]["proposal_scores"],
                 "proposal_scores")


def test_roi_logits(ref, port):
    feats = tuple(nchw(f) for f in ref["fwd"]["feats"])
    with torch.no_grad():
        cls, reg = port.roi_forward(feats, _t(ref["fwd"]["proposals"]))
    assert_close(cls, ref["cls"], "rcnn_cls")
    assert_close(reg, ref["reg"], "rcnn_reg")


def test_simple_test_without_nms(ref, port):
    with torch.no_grad():
        out = port.simple_test(nchw(ref["img"]), _t(ref["shapes"]), 0.05,
                               0.5, 100, with_nms=False)
    np.testing.assert_array_equal(out["valid"].numpy(),
                                  ref["no_nms"]["valid"])
    assert_close(out["boxes"], ref["no_nms"]["boxes"], "boxes")
    assert_close(out["scores"], ref["no_nms"]["scores"], "scores")


def test_simple_test_with_nms(ref, port, port_fwd):
    """The NMS'd result equals JAX's multiclass NMS on the port's own
    decoded boxes and scores, exactly, and keeps some boxes."""
    with torch.no_grad():
        out = port.simple_test(nchw(ref["img"]), _t(ref["shapes"]), 0.05,
                               0.5, 100, with_nms=True)
        cls, reg = port.roi_forward(port_fwd["feats"],
                                    port_fwd["proposals"])
    for b in range(2):
        boxes, scores = decode_rcnn(port_fwd["proposals"][b], cls[b],
                                    reg[b], 3, _t(ref["shapes"][b]))
        want = _np(jroi.multiclass_nms_2d(jnp.asarray(boxes.numpy()),
                                          jnp.asarray(scores.numpy()),
                                          0.05, 0.5, 100))
        for k in want:
            np.testing.assert_array_equal(out[k][b].numpy(), want[k],
                                          err_msg=k)
    assert out["valid"].sum() > 0


def test_fpn_upsampling_at_a_ratio_other_than_two():
    """A 60 x 120 canvas gives C3 8 x 15 under C2 15 x 30 and C4 4 x 8:
    the top-down nearest upsampling is JAX's half-pixel rule there too."""
    rng = np.random.RandomState(3)
    img = rng.randn(1, 60, 120, 3).astype(np.float32)
    cfg = dict(CFG, canvas=(60, 120))
    jm = JFasterRCNN(**dict(jtiny.TINY_FR_CFG, canvas=(60, 120)))
    shp = jnp.asarray([[60.0, 120.0]])
    var = jax.jit(lambda i: jm.init(jax.random.PRNGKey(2), i, shp))(
        jnp.asarray(img))
    params, frozen = randomize(var, seed=4)
    feats = jax.jit(lambda v, i: jm.apply(
        v, i, method=JFasterRCNN.extract_feat))(
        {"params": params, "frozen": frozen}, jnp.asarray(img))
    pm = FasterRCNN(**cfg).eval()
    pm.load_state_dict(from_jax_frcnn(params, frozen, cfg))
    with torch.no_grad():
        ours = pm.extract_feat(nchw(img))
    assert [tuple(o.shape[-2:]) for o in ours] == [
        (15, 30), (8, 15), (4, 8), (2, 4), (1, 2)]
    for i, (o, r) in enumerate(zip(ours, feats)):
        assert_close(o.permute(0, 2, 3, 1), r, f"P{i + 2}")


def test_converter_round_trip_at_full_depth():
    """convert_frcnn(from_jax_frcnn(v)) == v, array for array, for the
    production ResNet-50 (random arrays of the JAX model's shapes): the
    first shared FC's row permutation included."""
    jm = JFasterRCNN(num_classes=3, canvas=(64, 128))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 3)),
        jnp.asarray([[64.0, 128.0]])))
    rng = np.random.RandomState(5)
    tree = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32),
                        shapes)
    sd = from_jax_frcnn(tree["params"], tree["frozen"], {})
    model = FasterRCNN(num_classes=3, canvas=(64, 128))
    model.load_state_dict(sd)  # every key and shape of the port's model
    params, frozen = converter().convert_frcnn(
        {k: v.numpy() for k, v in sd.items()})
    for ours, back in ((tree["params"], params), (tree["frozen"], frozen)):
        leaves = jax.tree_util.tree_leaves_with_path(ours)
        assert len(leaves) == len(jax.tree_util.tree_leaves(back))
        for path, leaf in leaves:
            node = back
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node, leaf, err_msg=str(path))


# ---- the 2D ops the detector is built on ----

def _boxes(rng, n, scale=100.0):
    xy = rng.rand(n, 2) * scale
    wh = rng.rand(n, 2) * scale / 2 + 1
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_roi_align_single_and_multilevel():
    rng = np.random.RandomState(6)
    feats = [rng.randn(16 // 2 ** i, 32 // 2 ** i, 8).astype(np.float32)
             for i in range(4)]
    rois = _boxes(rng, 30, 120.0) - 5.0  # some past the borders
    want = jroialign.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                          jnp.asarray(rois), (4, 8, 16, 32))
    got = roialign.multilevel_roi_align(
        [_t(f).permute(2, 0, 1) for f in feats], _t(rois), (4, 8, 16, 32))
    assert_close(got.permute(0, 2, 3, 1), want, "multilevel_roi_align")
    want = jroialign.roi_align(jnp.asarray(feats[0]), jnp.asarray(rois), 0.25)
    got = roialign.roi_align(_t(feats[0]).permute(2, 0, 1), _t(rois), 0.25)
    assert_close(got.permute(0, 2, 3, 1), want, "roi_align")


def test_delta_xywh_decode():
    rng = np.random.RandomState(7)
    props = _boxes(rng, 64)
    deltas = (rng.randn(64, 4) * 2).astype(np.float32)  # some clamped
    shape = np.array([80.0, 90.0], np.float32)
    for stds in ((1.0, 1.0, 1.0, 1.0), (0.1, 0.1, 0.2, 0.2)):
        jc = jcoders.DeltaXYWHCoder(target_stds=stds)
        pc = coders.DeltaXYWHCoder(target_stds=stds)
        for ms in (None, shape):
            want = jc.decode(jnp.asarray(props), jnp.asarray(deltas),
                             None if ms is None else jnp.asarray(ms))
            got = pc.decode(_t(props), _t(deltas),
                            None if ms is None else _t(ms))
            assert_close(got, want, f"decode stds={stds} clip={ms}")
    assert_close(coders.cxcywh_to_xyxy(coders.xyxy_to_cxcywh(_t(props))),
                 props, "cxcywh round trip")


@pytest.mark.parametrize("mode", ["iou", "iof", "giou"])
@pytest.mark.parametrize("aligned", [False, True])
def test_iou2d_modes(mode, aligned):
    rng = np.random.RandomState(8)
    a, b = _boxes(rng, 20), _boxes(rng, 20 if aligned else 15)
    a[3] = a[3, [2, 3, 0, 1]]  # a degenerate (inverted) box
    want = jiou.iou2d(jnp.asarray(a), jnp.asarray(b), mode=mode,
                      aligned=aligned)
    got = iou.iou2d(_t(a), _t(b), mode=mode, aligned=aligned)
    assert_close(got, want, f"iou2d {mode} aligned={aligned}")


def test_nms_2d_and_batched_keeps():
    """Same keeps and order as JAX on clustered boxes with NEG_INF
    padding (distinct scores, so the selection is well defined)."""
    rng = np.random.RandomState(9)
    centers = _boxes(rng, 12)
    boxes = np.concatenate([centers + rng.randn(12, 4).astype(np.float32) * 3
                            for _ in range(5)])
    scores = rng.permutation(60).astype(np.float32) / 60.0
    scores[::7] = jnms.NEG_INF
    labels = rng.randint(0, 3, 60).astype(np.int32)
    for max_out in (8, 40):
        want = jnms.nms_2d(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                           max_out)
        got = nms.nms_2d(_t(boxes), _t(scores), 0.5, max_out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        want = jnms.batched_nms_2d(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(labels), 0.5, max_out)
        got = nms.batched_nms_2d(_t(boxes), _t(scores), _t(labels), 0.5,
                                 max_out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
