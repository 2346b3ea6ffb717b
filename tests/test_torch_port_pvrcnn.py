"""CPU parity of the port's PV-RCNN (``detmatch_tpu_torch/models``) against
the JAX model, module by module and for the whole eval forward plus
post-processing.

The model is ``utils/tiny.py``'s ``TINY_PV_CFG`` with the production BEV
depth (``layer_nums=(5, 5)``), the depth ``convert_pvrcnn`` expects.
Weights come from JAX ``model.init`` (BN running statistics randomized,
so BN is not the identity) and reach the port through
``from_jax_pvrcnn``. Each module is fed the JAX model's own inputs to it,
so a fault shows in the module that has it. Continuous outputs agree
within RTOL of their largest magnitude; discrete ones exactly.
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

from detmatch_tpu.models.pvrcnn import anchor_head as janchor  # noqa: E402
from detmatch_tpu.models.pvrcnn.bev import (  # noqa: E402
    height_compression as j_height_compression)
from detmatch_tpu.models.pvrcnn.pvrcnn import PVRCNN as JPVRCNN  # noqa: E402
from detmatch_tpu.models.pvrcnn.pvrcnn import (  # noqa: E402
    post_processing as j_post_processing)
from detmatch_tpu.ops import voxelize as jvox  # noqa: E402
from detmatch_tpu.utils import tiny  # noqa: E402
from detmatch_tpu_torch.apis.build import build_detector  # noqa: E402
from detmatch_tpu_torch.apis.inference import detect  # noqa: E402
from detmatch_tpu_torch.convert import _hc_perm, from_jax_pvrcnn  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.backbone3d import (  # noqa: E402
    level_shapes)
from detmatch_tpu_torch.models.pvrcnn.bev import (  # noqa: E402
    height_compression)
from detmatch_tpu_torch.models.pvrcnn.pvrcnn import (  # noqa: E402
    PVRCNN, post_processing)
from detmatch_tpu_torch.models.pvrcnn.roi_head import (  # noqa: E402
    PVRCNNHead, proposal_layer)
from detmatch_tpu_torch.ops import voxelize  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

RTOL = 1e-4
CFG = dict(tiny.TINY_PV_CFG,
           bev_cfg=dict(tiny.TINY_PV_CFG["bev_cfg"], layer_nums=(5, 5)))
HC_Z = level_shapes((41, 32, 32))[-1][0]
HC_C = CFG["backbone3d_cfg"]["out_channels"]
LEVELS = ("x_conv1", "x_conv2", "x_conv3", "x_conv4", "out")
ROOT = os.path.join(os.path.dirname(__file__), "..")


@functools.lru_cache()
def converter():
    spec = importlib.util.spec_from_file_location(
        "import_torch_ckpt", os.path.join(
            ROOT, "tools", "model_converters", "import_torch_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_close(out, ref, name):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(out - ref).max()) / scale
    assert err <= RTOL, f"{name}: relative error {err:.3e}"


def bev_to_port(x):
    """JAX HeightCompression channels (Z-outer, NHWC) → pcdet's (C-outer,
    NCHW)."""
    x = np.asarray(x)
    b, h, w, _ = x.shape
    x = x.reshape(b, h, w, HC_Z, HC_C).transpose(0, 4, 3, 1, 2)
    return x.reshape(b, HC_C * HC_Z, h, w)


def before_fusion_to_port(x):
    x = np.asarray(x)
    n = HC_Z * HC_C
    bev = x[..., :n].reshape(x.shape[:-1] + (HC_Z, HC_C))
    bev = np.swapaxes(bev, -1, -2).reshape(x.shape[:-1] + (n,))
    return np.concatenate([bev, x[..., n:]], axis=-1)


@pytest.fixture(scope="module")
def ref():
    """JAX model, randomized variables, one B=2 batch with uneven valid
    counts, and the JAX eval outputs plus module intermediates."""
    rng = np.random.RandomState(0)
    view = tiny.tiny_view(rng, b=2, p=256)
    pts = np.asarray(view["points"])
    valid = np.asarray(view["points_valid"]).copy()
    valid[1, 180:] = False
    vox = jax.vmap(lambda p, v: jvox.voxelize_mean(p, v, tiny.TINY_SPEC))(
        jnp.asarray(pts), jnp.asarray(valid))
    batch = dict(points=jnp.asarray(pts), points_valid=jnp.asarray(valid),
                 voxel_features=vox["features"], voxel_keys=vox["keys"])
    model = JPVRCNN(**CFG)
    var = jax.jit(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b,
                                       train=False))(batch)
    params = _np(var["params"])
    srng = np.random.RandomState(1)

    def rand_stat(path, x):
        if path[-1].key == "var":
            return (0.5 + srng.rand(*x.shape)).astype(np.float32)
        return (0.2 * srng.randn(*x.shape)).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(rand_stat,
                                             _np(var["batch_stats"]))
    out, inter = jax.jit(lambda v, b: model.apply(
        v, b, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(
        {"params": params, "batch_stats": stats}, batch)
    inter = inter["intermediates"]
    return dict(batch=_np(batch), params=params, stats=stats, out=_np(out),
                ms=_np(inter["backbone3d"]["__call__"][0]),
                bev=np.asarray(inter["backbone2d"]["__call__"][0]),
                vsa=_np(inter["pfe"]["__call__"][0]))


@pytest.fixture(scope="module")
def port(ref):
    model = PVRCNN(**CFG).eval()
    model.load_state_dict(from_jax_pvrcnn(ref["params"], ref["stats"], CFG))
    return model


@pytest.fixture(scope="module")
def port_out(ref, port):
    with torch.no_grad():
        return port({k: _t(v) for k, v in ref["batch"].items()})


def _unpermute(rows, perm):
    out = np.empty_like(rows)
    out[perm] = rows
    return out


def _tree_get(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_convert_round_trip(ref):
    """convert_pvrcnn(from_jax_pvrcnn(v)) == v array for array — except
    the point head's first layer: pcdet feeds it the before-fusion
    features with C-outer BEV channels, so from_jax_pvrcnn permutes those
    rows, which convert_pvrcnn copies unpermuted."""
    sd = from_jax_pvrcnn(ref["params"], ref["stats"], CFG)
    params, stats = converter().convert_pvrcnn(
        {k: v.numpy() for k, v in sd.items()}, hc_z=HC_Z, hc_c=HC_C,
        grid_size=CFG["roi_head_cfg"]["grid_size"])
    n = HC_Z * HC_C
    k0 = ref["params"]["point_head"]["cls_mlp"]["dense0"]["kernel"]
    got = params["point_head"]["cls_mlp"]["dense0"]["kernel"]
    np.testing.assert_array_equal(got[:n],
                                  _unpermute(k0[:n], _hc_perm(HC_Z, HC_C)))
    np.testing.assert_array_equal(got[n:], k0[n:])
    params["point_head"]["cls_mlp"]["dense0"]["kernel"] = k0
    for tree, back in ((ref["params"], params), (ref["stats"], stats)):
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        assert len(leaves) == len(jax.tree_util.tree_leaves(back))
        for path, leaf in leaves:
            np.testing.assert_array_equal(_tree_get(back, path), leaf,
                                          err_msg=str(path))


def test_backbone3d_parity(ref, port):
    b = ref["batch"]
    with torch.no_grad():
        ms = port.backbone_3d(_t(b["voxel_features"]), _t(b["voxel_keys"]))
    for name in LEVELS:
        r = ref["ms"][name]
        np.testing.assert_array_equal(ms[name]["keys"].numpy(), r["keys"])
        np.testing.assert_array_equal(ms[name]["mask"].numpy(), r["mask"])
        assert_close(ms[name]["feats"], r["feats"], name)
        assert ms[name]["mask"].any()


def test_bev_parity(ref, port):
    """HeightCompression (pcdet channel order) and BaseBEVBackbone."""
    lv = {k: _t(v) for k, v in ref["ms"]["out"].items()
          if k in ("feats", "keys")}
    lv["shape"] = level_shapes((41, 32, 32))[-1]
    spatial = height_compression(lv)
    ref_spatial = j_height_compression(dict(
        feats=jnp.asarray(ref["ms"]["out"]["feats"]),
        keys=jnp.asarray(ref["ms"]["out"]["keys"]),
        mask=jnp.asarray(ref["ms"]["out"]["mask"]), shape=lv["shape"]))
    np.testing.assert_array_equal(spatial.numpy(), bev_to_port(ref_spatial))
    with torch.no_grad():
        bev = port.backbone_2d(spatial)
    assert_close(bev.permute(0, 2, 3, 1), ref["bev"], "bev")


def test_anchor_head_parity(ref, port):
    a = janchor.generate_anchors(CFG["point_cloud_range"], CFG["grid_size"],
                                 list(JPVRCNN.anchor_configs))
    np.testing.assert_array_equal(port.dense_head.anchors.numpy(),
                                  janchor.flatten_anchors(a))
    with torch.no_grad():
        preds = port.dense_head(_t(ref["bev"]).permute(0, 3, 1, 2))
        boxes, cls = port.dense_head.decode_boxes(preds)
    for k in ("cls_preds", "box_preds", "dir_preds"):
        assert_close(preds[k], ref["out"]["head_preds"][k], k)
    assert_close(boxes, ref["out"]["batch_box_preds"], "batch_box_preds")
    assert_close(cls, ref["out"]["batch_cls_preds"], "batch_cls_preds")


def test_vsa_parity(ref, port):
    b = ref["batch"]
    ms = {name: dict({k: _t(v) for k, v in ref["ms"][name].items()
                      if k in ("feats", "keys", "mask")},
                     shape=shape, stride=stride)
          for name, shape, stride in zip(
              LEVELS, level_shapes((41, 32, 32)), (1, 2, 4, 8, 8))}
    spatial = _t(bev_to_port(j_height_compression(dict(
        feats=jnp.asarray(ref["ms"]["out"]["feats"]),
        keys=jnp.asarray(ref["ms"]["out"]["keys"]),
        mask=jnp.asarray(ref["ms"]["out"]["mask"]),
        shape=ms["out"]["shape"]))))
    with torch.no_grad():
        out = port.pfe(_t(b["points"]), _t(b["points_valid"]), spatial, ms)
    r = ref["vsa"]
    np.testing.assert_array_equal(out["keypoints"].numpy(), r["keypoints"])
    np.testing.assert_array_equal(out["kp_valid"].numpy(), r["kp_valid"])
    assert_close(out["point_features_before_fusion"],
                 before_fusion_to_port(r["point_features_before_fusion"]),
                 "point_features_before_fusion")
    assert_close(out["point_features"], r["point_features"],
                 "point_features")


def test_point_head_parity(ref, port):
    feats = _t(before_fusion_to_port(
        ref["vsa"]["point_features_before_fusion"]))
    with torch.no_grad():
        logits = port.point_head(feats, _t(ref["vsa"]["kp_valid"]))
    assert_close(logits, ref["out"]["point_logits"], "point_logits")


def test_roi_head_parity(ref, port):
    """Proposal NMS (exact selection) and the RoI-grid head."""
    o = ref["out"]
    props = proposal_layer(_t(o["batch_box_preds"]), _t(o["batch_cls_preds"]),
                           **CFG["test_nms"])
    np.testing.assert_array_equal(props["roi_valid"].numpy(),
                                  o["proposals"]["roi_valid"])
    np.testing.assert_array_equal(props["roi_labels"].numpy(),
                                  o["roi_labels"])
    np.testing.assert_array_equal(props["rois"].numpy(), o["rois"])
    np.testing.assert_array_equal(props["roi_scores_full"].numpy(),
                                  o["roi_scores_full"])
    with torch.no_grad():
        rcnn_cls, rcnn_reg = port.roi_head(
            _t(o["rois"]), _t(ref["vsa"]["keypoints"]),
            _t(ref["vsa"]["kp_valid"]), _t(ref["vsa"]["point_features"]),
            _t(o["point_scores"]))
    assert_close(rcnn_cls, o["rcnn_cls"], "rcnn_cls")
    assert_close(rcnn_reg, o["rcnn_reg"], "rcnn_reg")
    assert_close(PVRCNNHead.decode_boxes(_t(o["rois"]), _t(o["rcnn_reg"])),
                 o["batch_box_preds_rcnn"], "batch_box_preds_rcnn")


POST_DISCRETE = ("labels", "valid")
POST_CONTINUOUS = ("boxes", "scores", "sem_scores_full")


def test_eval_forward_and_post_processing_parity(ref, port_out):
    o = ref["out"]
    for k in ("keypoints", "kp_valid", "roi_labels"):
        np.testing.assert_array_equal(port_out[k].numpy(), o[k], err_msg=k)
    for k in ("batch_box_preds", "batch_cls_preds", "point_logits",
              "point_scores", "rois", "roi_scores", "roi_scores_full",
              "rcnn_cls", "rcnn_reg", "batch_box_preds_rcnn"):
        assert_close(port_out[k], o[k], k)
    post = post_processing(port_out, score_thresh=0.0)
    jpost = _np(j_post_processing(jax.tree.map(jnp.asarray, o),
                                  score_thresh=0.0))
    for k in POST_DISCRETE:
        np.testing.assert_array_equal(post[k].numpy(), jpost[k], err_msg=k)
    for k in POST_CONTINUOUS:
        assert_close(post[k], jpost[k], k)
    assert post["valid"].sum() > 0


def test_detect_matches_jax_pipeline(ref, port):
    """The entry point: voxelize → forward → post-processing."""
    b = ref["batch"]
    spec = voxelize.VoxelizerSpec(*tiny.TINY_SPEC)
    det = detect(port, _t(b["points"]), _t(b["points_valid"]), spec,
                 score_thresh=0.0)
    jpost = _np(j_post_processing(jax.tree.map(jnp.asarray, ref["out"]),
                                  score_thresh=0.0))
    for k in POST_DISCRETE:
        np.testing.assert_array_equal(det[k].numpy(), jpost[k], err_msg=k)
    for k in ("boxes", "scores"):
        assert_close(det[k], jpost[k], k)


def test_build_detector_production_layout():
    """build_detector on the pretrain config gives the full-width model
    whose state dict has pcdet's names and the JAX model's shapes (through
    the converter), and 200 x 176 x 6 anchors."""
    from detmatch_tpu_torch.config import Config
    cfg = Config.fromfile(os.path.join(
        ROOT, "configs/detmatch/001/pretrain_pvrcnn/split_0.py"))
    model = build_detector(cfg, device="cpu")
    assert not model.training
    assert model.dense_head.anchors.shape == (200 * 176 * 6, 7)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = converter().convert_pvrcnn(sd)
    jm = JPVRCNN(**cfg["model"]["detector_3d"])
    spec = jvox.VoxelizerSpec(**cfg["voxelizer"])
    b, p, v = 1, 64, spec.max_voxels
    abstract = jax.eval_shape(
        lambda bt: jm.init({"params": jax.random.PRNGKey(0)}, bt,
                           train=False),
        dict(points=jax.ShapeDtypeStruct((b, p, 4), jnp.float32),
             points_valid=jax.ShapeDtypeStruct((b, p), bool),
             voxel_features=jax.ShapeDtypeStruct((b, v, 4), jnp.float32),
             voxel_keys=jax.ShapeDtypeStruct((b, v), jnp.int32)))
    for tree, ours in ((abstract["params"], params),
                       (abstract["batch_stats"], stats)):
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        assert len(leaves) == len(jax.tree_util.tree_leaves(
            {k: v for k, v in ours.items() if v}))
        for path, leaf in leaves:
            assert _tree_get(ours, path).shape == leaf.shape, path
