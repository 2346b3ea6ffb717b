"""CPU parity of the port's bfloat16 compute dtype (``compute_dtype=
"bfloat16"``: ``models/layers.py``, the BEV backbone, VSA, the RoI head,
PV-RCNN, ResNet / FPN / RPN / the 2D RoI head, Faster R-CNN) against the
JAX models built with ``compute_dtype=jnp.bfloat16``.

The models are ``utils/tiny.py``'s (the PV-RCNN with the production BEV
depth, ``layer_nums=(5, 5)``), JAX ``init`` weights with randomized
batch-norm statistics, brought over by ``convert.from_jax_*``. Each
module is fed the JAX model's own inputs to it and compared before any
discrete decision: the RoI heads on JAX's proposals.

Tolerances, in bfloat16 steps (``STEP`` = 2^-8, the spacing of bfloat16
relative to a value) of each tensor's largest magnitude. XLA on the CPU
and ATen round a bfloat16 product's float32 sum at different points, so
any layer may differ by about one step, and the layers after it carry
that difference on (batch norm rescales it). Measured on these inputs,
and the bounds held: the BEV output and the PV-RCNN's dense outputs 1.07
steps (``BEV_TOL`` 3), the VSA and the RoI head fed JAX's inputs 0
(``HEAD_TOL`` 2), the Faster R-CNN's FPN maps, RPN and RoI logits 2.71
(``FR_TOL`` 6).

Gradients of the train-mode VSA and RoI head (through the bfloat16
grouped gather, whose backward both packages accumulate in float32):
within ``GRAD_TOL`` (4 steps; measured 1.67) of each tensor's largest
magnitude, but for the xyz columns of each grouped MLP's first layer.
Those are the gradient of the point-table term less that of the center
term (``W [p_n - c_m | f_n] = W [p_n | f_n] - W [c_m | 0]``), two sums
about ten times the result, each rounded to bfloat16 where JAX rounds it,
so a last-bit difference upstream comes out about ten times larger:
measured up to 31 steps, where bfloat16 itself (JAX bfloat16 against JAX
float32 on the same weights) moves them by 36-177 steps. They are held
to ``XYZ_SHARE`` (0.5) of that move; the worst measured share is 0.23.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.models.frcnn.faster_rcnn import (  # noqa: E402
    FasterRCNN as JFasterRCNN)
from detmatch_tpu.models.pvrcnn.bev import (  # noqa: E402
    height_compression as j_height_compression)
from detmatch_tpu.models.pvrcnn.pvrcnn import PVRCNN as JPVRCNN  # noqa: E402
from detmatch_tpu.ops import voxelize as jvox  # noqa: E402
from detmatch_tpu.utils import tiny as jtiny  # noqa: E402
from detmatch_tpu_torch.apis.build import (build_detector,  # noqa: E402
                                           compute_dtype)
from detmatch_tpu_torch.convert import (from_jax_frcnn,  # noqa: E402
                                        from_jax_pvrcnn)
from detmatch_tpu_torch.models import layers  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.backbone3d import (  # noqa: E402
    level_shapes)
from detmatch_tpu_torch.models.pvrcnn.pvrcnn import PVRCNN  # noqa: E402
from detmatch_tpu_torch.ops import pointnet  # noqa: E402
from detmatch_tpu_torch.utils import tiny  # noqa: E402
from test_torch_port_pvrcnn import (before_fusion_to_port,  # noqa: E402
                                    bev_to_port)
from test_torch_port_frcnn import randomize as fr_randomize  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

STEP = 2.0 ** -8
BEV_TOL = 3 * STEP
HEAD_TOL = 2 * STEP
FR_TOL = 6 * STEP
GRAD_TOL = 4 * STEP
XYZ_SHARE = 0.5
LOSS_BF16_RTOL = 16 * STEP
BF16 = torch.bfloat16
CFG = dict(tiny.TINY_PV_CFG,
           bev_cfg=dict(tiny.TINY_PV_CFG["bev_cfg"], layer_nums=(5, 5)),
           roi_head_cfg=dict(tiny.TINY_PV_CFG["roi_head_cfg"], dp_ratio=0.0))
LEVELS = ("x_conv1", "x_conv2", "x_conv3", "x_conv4", "out")
SHAPES = level_shapes((41, 32, 32))
STRIDES = (1, 2, 4, 8, 8)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        if x.dtype == jnp.bfloat16 else np.asarray(x), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def rel(out, ref):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-12)


def port_ms(ms):
    return {name: dict({k: _t(v) for k, v in ms[name].items()
                        if k in ("feats", "keys", "mask")},
                       shape=shape, stride=stride)
            for name, shape, stride in zip(LEVELS, SHAPES, STRIDES)}


def spatial_of(ms):
    return _t(bev_to_port(j_height_compression(dict(
        feats=jnp.asarray(ms["out"]["feats"]),
        keys=jnp.asarray(ms["out"]["keys"]),
        mask=jnp.asarray(ms["out"]["mask"]), shape=SHAPES[-1]))))


@pytest.fixture(scope="module")
def ref():
    """The bfloat16 JAX PV-RCNN's eval forward and its intermediates, and
    the train-mode VSA and RoI head's outputs and gradients of a fixed
    random projection of them."""
    rng = np.random.RandomState(0)
    view = tiny.tiny_view(rng, b=2, p=256)
    pts, valid = np.asarray(view["points"]), view["points_valid"].copy()
    valid[1, 180:] = False
    spec = jvox.VoxelizerSpec(**tiny.TINY_SPEC)
    vox = jax.vmap(lambda p, v: jvox.voxelize_mean(p, v, spec))(
        jnp.asarray(pts), jnp.asarray(valid))
    batch = dict(points=jnp.asarray(pts), points_valid=jnp.asarray(valid),
                 voxel_features=vox["features"], voxel_keys=vox["keys"])
    model = JPVRCNN(**CFG, compute_dtype=jnp.bfloat16)
    var = jax.jit(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b,
                                       train=False))(batch)
    srng = np.random.RandomState(1)

    def rand_stat(path, x):
        if path[-1].key == "var":
            return (0.5 + srng.rand(*x.shape)).astype(np.float32)
        return (0.2 * srng.randn(*x.shape)).astype(np.float32)

    params = jax.tree.map(np.asarray, var["params"])
    stats = jax.tree_util.tree_map_with_path(
        rand_stat, jax.tree.map(np.asarray, var["batch_stats"]))
    v = {"params": params, "batch_stats": stats}
    out, inter = jax.jit(lambda v, b: model.apply(
        v, b, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(v, batch)
    inter = inter["intermediates"]
    ms = jax.tree.map(np.asarray, inter["backbone3d"]["__call__"][0])
    spatial = j_height_compression(dict(
        feats=jnp.asarray(ms["out"]["feats"]),
        keys=jnp.asarray(ms["out"]["keys"]),
        mask=jnp.asarray(ms["out"]["mask"]), shape=SHAPES[-1]))
    vsa = inter["pfe"]["__call__"][0]

    # the train pass's RoIs sit on keypoints, so that every pool group's
    # balls hold neighbours and its gather has a gradient
    rois = np.array(out["rois"])
    n = rois.shape[1]
    rois[..., :3] = np.asarray(vsa["keypoints"])[:, :n]
    w_pf = srng.randn(2, CFG["num_keypoints"], 128).astype(np.float32)
    w_cls = srng.randn(*out["rcnn_cls"].shape).astype(np.float32)
    w_reg = srng.randn(*out["rcnn_reg"].shape).astype(np.float32)

    def train_loss(p, stats, model=model):
        def fn(m):
            vo = m.vsa(batch["points"], batch["points_valid"], spatial, ms,
                       train=True)
            cls, reg = m.roi_head(
                rois, vo["keypoints"], vo["kp_valid"],
                vo["point_features"], out["point_scores"], train=True)
            return (jnp.sum(vo["point_features"] * w_pf)
                    + jnp.sum(cls * w_cls) + jnp.sum(reg * w_reg)), vo
        (loss, vo), new = model.apply(
            {"params": p, "batch_stats": stats}, method=fn,
            mutable=["batch_stats"])
        return loss, (vo, new["batch_stats"])

    (loss, (vo_train, new_stats)), grads = jax.jit(jax.value_and_grad(
        train_loss, has_aux=True))(params, stats)
    # the same in float32: how far bfloat16 itself moves each gradient
    f32 = JPVRCNN(**CFG)
    grads_f32 = jax.jit(jax.grad(
        lambda p, s: train_loss(p, s, f32)[0]))(params, stats)
    return dict(batch=_np(batch), params=params, stats=stats, out=_np(out),
                ms=ms, spatial=np.asarray(spatial),
                bev=_np(inter["backbone2d"]["__call__"][0]), vsa=_np(vsa),
                w=(w_pf, w_cls, w_reg), rois=rois, loss=float(loss),
                vo_train=_np(vo_train), new_stats=_np(new_stats),
                grads=_np(grads), grads_f32=_np(grads_f32))


@pytest.fixture(scope="module")
def port(ref):
    model = PVRCNN(**CFG, compute_dtype=BF16).eval()
    model.load_state_dict(from_jax_pvrcnn(ref["params"], ref["stats"], CFG))
    return model


def test_compute_dtype_strings():
    assert compute_dtype("bfloat16") is BF16
    assert compute_dtype(None) is None and compute_dtype("float32") is None
    with pytest.raises(ValueError):
        compute_dtype("float16")
    cfg = dict(model=dict(detector_3d=dict(tiny.TINY_PV_CFG,
                                           compute_dtype="bfloat16"),
                          detector_2d=dict(tiny.TINY_FR_CFG,
                                           compute_dtype="bfloat16")))
    pv = build_detector(cfg, device="cpu")
    fr = build_detector(cfg, device="cpu", key="detector_2d")
    assert pv.backbone_2d.dtype is BF16 and pv.pfe.SA_rawpoints.dtype is BF16
    assert pv.roi_head.dtype is BF16 and fr.backbone.dtype is BF16
    assert all(p.dtype == torch.float32 for p in pv.parameters())
    assert all(p.dtype == torch.float32 for p in fr.parameters())


def test_layers_follow_flax_cast_points():
    """linear / conv in bfloat16 with the bias added after the product;
    batch norm in float32 cast back; a layer without dtype promotes a
    bfloat16 input to float32; the float32 path is unchanged."""
    g = torch.Generator().manual_seed(0)
    lin = torch.nn.Linear(8, 4)
    x = torch.randn(5, 8, generator=g)
    want = (torch.nn.functional.linear(x.to(BF16), lin.weight.to(BF16))
            + lin.bias.to(BF16))
    assert torch.equal(layers.pointwise(lin, x, BF16), want)
    assert layers.pointwise(lin, x.to(BF16)).dtype == torch.float32
    assert torch.equal(layers.pointwise(lin, x), lin(x))
    bn = torch.nn.BatchNorm1d(4, momentum=0.01).train()
    y = layers.masked_bn(bn, want)
    assert y.dtype == BF16
    bn2 = torch.nn.BatchNorm1d(4, momentum=0.01).train()
    assert torch.equal(y, layers.masked_bn(bn2, want.float()).to(BF16))
    assert torch.equal(bn.running_var, bn2.running_var)


def test_bf16_gather_backward_accumulates_in_float32():
    """The grouped gather of a bfloat16 table sums each row's gradients in
    float32 and rounds once (JAX ``pointnet._fenced_take_bwd``)."""
    table = torch.zeros(2, 3, 4, dtype=BF16, requires_grad=True)
    idx = torch.zeros(2, 300, dtype=torch.int32)
    g = torch.full((2, 300, 4), 1.0 / 256, dtype=BF16)
    (pointnet.gather_rows(table, idx) * g).sum().backward()
    # 300 / 256 in float32, rounded once: a bfloat16 running sum stalls
    # at 1.0 (1 + 2^-8 rounds back to 1)
    assert table.grad.dtype == BF16
    assert float(table.grad[0, 0, 0]) == 300 / 256
    assert not table.grad[:, 1:].any()


def test_bev_backbone_bf16(ref, port):
    with torch.no_grad():
        bev = port.backbone_2d(_t(bev_to_port(ref["spatial"])))
    assert bev.dtype == BF16
    assert rel(bev.permute(0, 2, 3, 1), ref["bev"]) <= BEV_TOL


def test_anchor_head_promotes_bf16_bev(ref, port):
    bev = _t(ref["bev"]).permute(0, 3, 1, 2).to(BF16)
    with torch.no_grad():
        preds = port.dense_head(bev.float())
    for k in ("cls_preds", "box_preds", "dir_preds"):
        assert rel(preds[k], ref["out"]["head_preds"][k]) <= HEAD_TOL, k


def test_vsa_bf16(ref, port):
    b = ref["batch"]
    with torch.no_grad():
        out = port.pfe(_t(b["points"]), _t(b["points_valid"]),
                       spatial_of(ref["ms"]), port_ms(ref["ms"]))
    r = ref["vsa"]
    np.testing.assert_array_equal(out["keypoints"].numpy(), r["keypoints"])
    assert out["point_features"].dtype == torch.float32
    assert rel(out["point_features_before_fusion"],
               before_fusion_to_port(r["point_features_before_fusion"])
               ) <= HEAD_TOL
    assert rel(out["point_features"], r["point_features"]) <= HEAD_TOL


def test_roi_head_bf16_on_pinned_proposals(ref, port):
    o, r = ref["out"], ref["vsa"]
    with torch.no_grad():
        cls, reg = port.roi_head(
            _t(o["rois"]), _t(r["keypoints"]), _t(r["kp_valid"]),
            _t(r["point_features"]), _t(o["point_scores"]))
    assert cls.dtype == reg.dtype == torch.float32
    assert rel(cls, o["rcnn_cls"]) <= HEAD_TOL
    assert rel(reg, o["rcnn_reg"]) <= HEAD_TOL


def test_pvrcnn_bf16_dense_outputs(ref, port):
    """The whole eval forward up to its first discrete decision."""
    with torch.no_grad():
        out = port({k: _t(v) for k, v in ref["batch"].items()})
    o = ref["out"]
    assert rel(out["bev_features"].permute(0, 2, 3, 1), ref["bev"]) \
        <= BEV_TOL
    for k in ("batch_box_preds", "batch_cls_preds", "point_logits"):
        assert rel(out[k], o[k]) <= BEV_TOL, k


def test_vsa_and_roi_head_bf16_train_gradients(ref, port):
    """Train mode (batch statistics), float32 parameters: the loss, the
    VSA's output, every gradient of the VSA and the RoI head and the
    batch-norm buffers against JAX's."""
    model = PVRCNN(**CFG, compute_dtype=BF16)
    model.load_state_dict(from_jax_pvrcnn(ref["params"], ref["stats"], CFG))
    model.train()
    b, o = ref["batch"], ref["out"]
    w_pf, w_cls, w_reg = (_t(w) for w in ref["w"])
    vo = model.pfe(_t(b["points"]), _t(b["points_valid"]),
                   spatial_of(ref["ms"]), port_ms(ref["ms"]))
    cls, reg = model.roi_head(_t(ref["rois"]), vo["keypoints"], vo["kp_valid"],
                              vo["point_features"], _t(o["point_scores"]),
                              generator=torch.Generator())
    loss = ((vo["point_features"] * w_pf).sum() + (cls * w_cls).sum()
            + (reg * w_reg).sum())
    loss.backward()
    assert abs(float(loss.detach()) - ref["loss"]) <= HEAD_TOL * abs(
        ref["loss"])
    assert rel(vo["point_features"], ref["vo_train"]["point_features"]) \
        <= HEAD_TOL
    want = from_jax_pvrcnn(ref["grads"], ref["new_stats"], CFG)
    want32 = from_jax_pvrcnn(ref["grads_f32"], ref["new_stats"], CFG)
    sd = model.state_dict()
    n = 0
    for name, p in model.named_parameters():
        if not name.startswith(("pfe.", "roi_head.")):
            continue
        assert p.grad is not None and p.grad.abs().max() > 0, name
        g, w = p.grad, want[name]
        if ".mlps." in name and name.endswith(".0.weight"):
            # a grouped MLP's first layer: its xyz columns are the table
            # term less the center term (module docstring)
            assert rel(g[:, 3:], w[:, 3:]) <= GRAD_TOL, name
            assert rel(g[:, :3], w[:, :3]) <= XYZ_SHARE * rel(
                w[:, :3], want32[name][:, :3]), name
        else:
            assert rel(g, w) <= GRAD_TOL, name
        n += 1
    assert n > 20
    for k, v in want.items():
        if k.startswith(("pfe.", "roi_head.")) and k.endswith(
                ("running_mean", "running_var")):
            assert rel(sd[k], v) <= HEAD_TOL, k


@pytest.fixture(scope="module")
def fr_ref():
    rng = np.random.RandomState(0)
    img = rng.randn(2, *tiny.TINY_CANVAS, 3).astype(np.float32)
    shapes = np.array([[64.0, 128.0], [60.0, 110.0]], np.float32)
    model = JFasterRCNN(**jtiny.TINY_FR_CFG, compute_dtype=jnp.bfloat16)
    var = jax.jit(lambda i, s: model.init(jax.random.PRNGKey(0), i, s))(
        jnp.asarray(img), jnp.asarray(shapes))
    params, frozen = fr_randomize(var)
    v = {"params": params, "frozen": frozen}
    fwd = jax.jit(lambda v, i, s: model.apply(v, i, s))(
        v, jnp.asarray(img), jnp.asarray(shapes))
    cls, reg = jax.jit(lambda v, f, r: model.apply(
        v, f, r, method=JFasterRCNN.roi_forward))(v, fwd["feats"],
                                                   fwd["proposals"])
    return dict(img=img, shapes=shapes, params=params, frozen=frozen,
                fwd=_np(fwd), cls=np.asarray(cls), reg=np.asarray(reg))


def test_faster_rcnn_bf16(fr_ref):
    """FPN maps and RPN logits of the eval forward, and the RoI head's
    logits on JAX's proposals."""
    cfg = dict(tiny.TINY_FR_CFG, compute_dtype="bfloat16")
    model = build_detector(dict(model=dict(detector_2d=cfg)), device="cpu",
                           key="detector_2d")
    model.load_state_dict(from_jax_frcnn(fr_ref["params"], fr_ref["frozen"],
                                         tiny.TINY_FR_CFG))
    with torch.no_grad():
        fwd = model(_t(fr_ref["img"]).permute(0, 3, 1, 2),
                    _t(fr_ref["shapes"]))
        feats_j = [_t(np.asarray(f, np.float32)).permute(0, 3, 1, 2).to(BF16)
                   for f in fr_ref["fwd"]["feats"]]
        cls, reg = model.roi_forward(feats_j, _t(fr_ref["fwd"]["proposals"]))
    for f, fj in zip(fwd["feats"], fr_ref["fwd"]["feats"]):
        assert f.dtype == BF16
        assert rel(f.permute(0, 2, 3, 1), fj) <= FR_TOL
    for (c, r), (cj, rj) in zip(fwd["rpn_outs"], fr_ref["fwd"]["rpn_outs"]):
        assert c.dtype == torch.float32
        assert rel(c, cj) <= FR_TOL and rel(r, rj) <= FR_TOL
    assert cls.dtype == torch.float32
    assert rel(cls, fr_ref["cls"]) <= FR_TOL
    assert rel(reg, fr_ref["reg"]) <= FR_TOL


def test_bf16_train_losses_near_fp32():
    """The tiny PV-RCNN's training loss terms in bfloat16 against float32
    on the same weights, batch, generator and pinned proposals: every
    term within ``LOSS_BF16_RTOL`` (16 steps; measured 2.26) of the
    float32 term (floor 1e-3). ``chip_smoke.py``'s bfloat16 phase holds
    the SSL step's 3D terms at full width to the same bound."""
    from detmatch_tpu_torch.apis.train_pretrain import to_device_batch
    from detmatch_tpu_torch.models.pvrcnn import pvrcnn as pvrcnn_mod
    from detmatch_tpu_torch.ops.voxelize import VoxelizerSpec

    rng = np.random.RandomState(3)
    view = tiny.tiny_view(rng, b=2, p=256, with_gt=True)
    batch = to_device_batch(view, VoxelizerSpec(**tiny.TINY_SPEC), "cpu")
    torch.manual_seed(0)
    f32 = PVRCNN(**CFG).train()
    bf16 = PVRCNN(**CFG, compute_dtype=BF16).train()
    bf16.load_state_dict(f32.state_dict())
    own = pvrcnn_mod.proposal_layer
    pinned = {}

    def spy(*a, **k):
        pinned.update(own(*a, **k))
        return pinned

    losses = []
    try:
        for model in (f32, bf16):
            pvrcnn_mod.proposal_layer = spy if not pinned else (
                lambda *a, **k: pinned)
            out = model(batch, generator=torch.Generator().manual_seed(1))
            losses.append({k: float(v) for k, v in
                           model.loss(out, batch).items()})
    finally:
        pvrcnn_mod.proposal_layer = own
    want, got = losses
    worst = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-3)
                for k in want)
    assert worst <= LOSS_BF16_RTOL, (worst, got, want)
    assert all(np.isfinite(v) for v in got.values())
