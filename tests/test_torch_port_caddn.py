"""CPU parity of the port's CaDDN (``detmatch_tpu_torch/models/pvrcnn/
caddn.py``) against JAX's (``detmatch_tpu/models/pvrcnn/caddn.py``).

Pieces, op by op in JAX: ``bin_depths`` (UD and LID, with and without
the clamp, non-finite depths), ``trilinear_sample`` at its trouble spots
(integer points, the edges and d = -0.5, voxels behind the camera whose
u, v land far out of range, non-finite indices), the DDN's bilinear
upsample at sizes that are not multiples of 32 (KITTI's 12 x 39 -> 94 x
311), ``ddn_loss`` (value, gradient, the fg mask recovered from JAX's own
gradient) and the stride-2 anchors.

The whole model at ``tests/test_caddn.py``'s CFG with 64 x 64 images and
at 72 x 100 (not a multiple of 32; C5 3 x 4 -> C2 18 x 25; its camera
sits 4 m into the grid, so voxels lie behind it and at d = -0.5): the
weights drawn with numpy in JAX's shapes and brought over by
``convert.from_jax_caddn``; one jitted JAX program a size computes the
eval forward with the gradients of its loss (batch norms at their
running statistics, as the zoo's tests hold gradients: with batch
statistics over a 2 x 2 C5 the float32 gradient is ill-conditioned), its
post-processing and a train-mode pass (loss terms, outputs, new
batch-norm statistics), with the anchor targets of an op-by-op run
(JAX's jitted assignment can break an IoU tie otherwise, ROADMAP "not
faults"). Tolerances: dense outputs and depth logits 1e-4 of the
tensor's largest magnitude, loss terms 1e-4 relative (1e-3 for the
train-mode pass, ``TRAIN_RTOL``), gradients 1e-3 of
each tensor's largest magnitude or twice the port's own float32 spread
where wider (:func:`test_gradients`), batch-norm statistics 1e-4;
depth-bin targets, fg masks, anchor targets and NMS keeps exactly.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from detmatch_tpu.models.pvrcnn import caddn as jc  # noqa: E402
from detmatch_tpu.models.pvrcnn.anchor_head import (  # noqa: E402
    AnchorHeadSingle as JAnchorHead, generate_anchors as j_anchors,
    flatten_anchors)
from detmatch_tpu.models.pvrcnn.second import (  # noqa: E402
    second_post_processing as j_post)
from detmatch_tpu_torch.apis import train_pretrain  # noqa: E402
from detmatch_tpu_torch.apis.build import build_detector  # noqa: E402
from detmatch_tpu_torch.convert import FROM_JAX  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn import caddn as pc  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.second import (  # noqa: E402
    second_post_processing as p_post)
import torch_port_zoo_fixture as zf  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

CFG = dict(num_classes=3, point_cloud_range=(2.0, -8.0, -3.0, 18.0, 8.0, 1.0),
           voxel_size=(0.5, 0.5, 0.5), grid_size=(32, 32, 8), depth_bins=16,
           depth_range=(2.0, 18.0), downsample=4)
B = 2
POST = dict(nms_pre=256, nms_post=64)
SIZES = {"64x64": (64, 64, 32.0, 0.0), "72x100": (72, 100, 40.0, -4.0)}

OUT_TOL = 1e-4
LOSS_RTOL = 1e-4
# the train-mode pass: batch statistics over a 2 x 2 (3 x 4) C5 leave it
# ill-conditioned in float32: at 72 x 100 the port with and without
# oneDNN's convs differs by 1.4e-4 on rpn_loss_dir, and from JAX by 3.1e-4
TRAIN_RTOL = 1e-3
GRAD_TOL = 1e-3
STAT_RTOL = 1e-4


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-12)


def batch(size, seed=0):
    """Images (B, H, W, 3), the camera (focal ``f``, principal point at
    the image centre, ``tz`` m along the lidar's x), 2D gt boxes with
    edges on feature pixels, a degenerate and padding rows, depth maps
    with values out of range and non-finite, two 3D gt boxes."""
    h, w, f, tz = SIZES[size]
    rng = np.random.RandomState(seed)
    l2c = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, tz],
                    [0, 0, 0, 1]], np.float32)
    c2i = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0]],
                   np.float32)
    hf, wf = -(-h // 4), -(-w // 4)
    depth = rng.rand(B, hf, wf).astype(np.float32) * 20 + 1
    depth[:, 0, :4] = [np.nan, np.inf, -3.0, 18.0]
    g2 = np.zeros((B, 4, 4), np.float32)
    g2[:, 0] = [8, 8, 40, 40]
    g2[:, 1] = [20, 4, 20, 4]  # a point: not a valid box
    g2[1, 2] = [44.0, 40.0, 70.0, 50.0]
    gt = np.zeros((B, 4, 8), np.float32)
    gt[:, :2, 0] = [6.0, 10.0]
    gt[:, :2, 2] = -1.0
    gt[:, :2, 3:6] = [3.9, 1.6, 1.56]
    gt[:, :2, 7] = [3, 1]
    return dict(images=(rng.rand(B, h, w, 3) * 255).astype(np.float32),
                lidar2cam=np.tile(l2c, (B, 1, 1)),
                cam2img=np.tile(c2i, (B, 1, 1)), gt_boxes=gt,
                depth_maps=depth, gt_boxes2d=g2)


def run_jax(size):
    """Variables and one jitted program: the eval forward with its loss
    terms and gradients (batch norms at their running statistics), its
    post-processing, and a train-mode pass (batch statistics: loss
    terms, outputs, new statistics)."""
    jm = jc.CaDDN(**CFG)
    b = {k: jnp.asarray(v) for k, v in batch(size).items()}
    v = zf.random_variables(jm, b, 0, (("dense_head", "conv_cls"),))
    targets = jm.apply(v, b["gt_boxes"],
                       method=lambda m, g: m.anchor_head.targets(g))

    def program(v, b):
        def loss(p, train):
            out, new = jm.apply(dict(v, params=p), b, train=train,
                                mutable=["batch_stats"])
            terms = jm.apply(dict(v, params=p), out, b, method=jc.CaDDN.loss)
            return terms["loss"], (terms, new, out)

        (_, (eval_terms, _, ev)), grads = jax.value_and_grad(
            loss, has_aux=True)(v["params"], False)
        _, (terms, new, out) = loss(v["params"], True)
        return (ev, j_post(ev, **POST), eval_terms, grads, terms,
                new["batch_stats"], out)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JAnchorHead, "targets", lambda self, g: targets)
        res = jax.tree.map(np.asarray, jax.jit(program)(v, b))
    ev, post, eval_terms, grads, terms, stats, out = res
    return dict(variables=v, eval=ev, post=post, grads=grads,
                eval_losses=_floats(eval_terms), losses=_floats(terms),
                stats=stats, train_out=out, batch=batch(size),
                targets=jax.tree.map(np.asarray, targets))


def _floats(terms):
    return {k: float(x) for k, x in terms.items()}


def port_model(ref):
    v = ref["variables"]
    model = build_detector({"model": {"detector_mono": dict(CFG)}},
                           device="cpu", key="detector_mono")
    model.load_state_dict(FROM_JAX["CaDDN"](v["params"], v["batch_stats"],
                                            v["frozen"], CFG))
    return model


def tensors(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def eval_grads(model, b):
    """The eval-mode forward, its loss terms and every gradient."""
    model.zero_grad()
    ev = model(b)
    losses = model.loss(ev, b)
    losses["loss"].backward()
    return ev, _floats(losses), {n: p.grad.clone() for n, p in
                                 model.named_parameters()
                                 if p.grad is not None}


@pytest.fixture(scope="module", params=sorted(SIZES))
def case(request):
    """JAX's reference and the port's runs on the same weights: the eval
    forward with its gradients, the same without oneDNN's convs (another
    float32 order of sums, for the gradients' spread) and a train-mode
    pass."""
    ref = run_jax(request.param)
    model = port_model(ref)
    b = tensors(ref["batch"])
    ev, eval_losses, grads = eval_grads(model, b)
    with torch.backends.mkldnn.flags(enabled=False):
        _, _, grads_alt = eval_grads(model, b)
    model.train()
    with torch.no_grad():
        out = model(b)
        losses = model.loss(out, b)
    return dict(ref=ref, model=model, eval=ev, eval_losses=eval_losses,
                grads=grads, grads_alt=grads_alt, train_out=out,
                losses=_floats(losses))


# ---- pieces ----

DEPTHS = np.array([2.0, 2.1, 5.0, 17.9, 18.0, 18.1, 1.9, 1.99, 0.0, -4.0,
                   1e6, np.inf, -np.inf, np.nan], np.float32)


@pytest.mark.parametrize("clamp", (False, True))
@pytest.mark.parametrize("mode", ("UD", "LID"))
def test_bin_depths(mode, clamp):
    d = np.concatenate([DEPTHS, np.random.RandomState(1).rand(200).astype(
        np.float32) * 24 - 2])
    want = np.asarray(jc.bin_depths(jnp.asarray(d), mode, 2.0, 18.0, 16,
                                    clamp=clamp))
    got = pc.bin_depths(torch.from_numpy(d), mode, 2.0, 18.0, 16,
                        clamp=clamp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    if clamp:  # the targets: the int cast of JAX's ddn_loss, exactly
        np.testing.assert_array_equal(got.astype(np.int32),
                                      want.astype(np.int32))
        assert (want == 16).sum() >= 7
    elif mode == "LID":
        assert want[8] == -0.5  # every depth below d_min - bin/8


def test_trilinear_sample_trouble_spots():
    rng = np.random.RandomState(0)
    vol = rng.randn(4, 5, 6, 3).astype(np.float32)
    pts = [(1, 3, 2), (2, 0, 5), (0, 0, 0), (3, 4, 5),    # integer points
           (-0.5, 2, 2), (-0.5, 4, 5), (3.5, 2, 2),      # half outside
           (-1.0, 2, 2), (4.0, 2, 2), (1, -0.25, 5.75),  # edges
           (2.5, 1e6, 3), (-0.5, -7e6, 2e5), (1, 2, -3e6),  # behind
           (np.nan, 1, 1), (1, np.inf, 1), (1, 1, -np.inf)]
    pts = np.concatenate([np.array(pts, np.float32), rng.rand(64, 3).astype(
        np.float32) * [5, 6, 7] - 1])
    want = np.asarray(jc.trilinear_sample(jnp.asarray(vol),
                                          *map(jnp.asarray, pts.T)))
    got = pc.trilinear_sample(torch.from_numpy(vol),
                              *map(torch.from_numpy, pts.T.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    np.testing.assert_array_equal(got[:4], vol[[1, 2, 0, 3], [3, 0, 0, 4],
                                               [2, 5, 0, 5]])
    np.testing.assert_allclose(got[4], 0.5 * vol[0, 2, 2], rtol=1e-6)
    assert np.isnan(got[13:16]).all() and np.isfinite(got[:13]).all()
    assert (got[10:13] == 0).all()


@pytest.mark.parametrize("src,dst", (((12, 39), (94, 311)), ((2, 2), (16, 16)),
                                     ((3, 4), (18, 25))))
def test_ddn_resize(src, dst):
    """The DDN's upsample: ``F.interpolate(bilinear, align_corners=False)``
    against ``jax.image.resize(method="bilinear")`` (antialiasing only
    acts when shrinking)."""
    x = np.random.RandomState(0).randn(2, *src, 17).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 17),
                                       method="bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=dst,
                        mode="bilinear", align_corners=False)
    assert rel(got.permute(0, 2, 3, 1), want) <= 1e-6


def test_ddn_loss_and_fg_mask():
    """The loss and its gradient; the fg mask exactly JAX's, read from
    JAX's own gradient (with equal logits and one target everywhere, a
    pixel's gradient is its weight: 13 fg, 1 bg)."""
    b = batch("72x100")
    jm, pm = jc.CaDDN(**CFG), pc.CaDDN(**CFG)
    hf, wf = b["depth_maps"].shape[1:]
    logits = np.random.RandomState(2).randn(B, hf, wf, 17).astype(np.float32)

    def jloss(lg, dm):
        return jm.apply({}, lg, jnp.asarray(dm), jnp.asarray(b["gt_boxes2d"]),
                        method=jc.CaDDN.ddn_loss)

    want, want_g = jax.jit(jax.value_and_grad(jloss))(
        jnp.asarray(logits), b["depth_maps"])
    lg = torch.from_numpy(logits).requires_grad_()
    got = pm.ddn_loss(lg, torch.from_numpy(b["depth_maps"]),
                      torch.from_numpy(b["gt_boxes2d"]))
    got.backward()
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    assert rel(lg.grad, want_g) <= 1e-5
    g = np.asarray(jax.jit(jax.grad(jloss))(
        jnp.zeros_like(logits), np.full_like(b["depth_maps"], 5.0)))
    mag = np.abs(g[..., 0])
    fg_jax = mag > 5 * mag.min()
    fg = pm.foreground(torch.from_numpy(b["gt_boxes2d"]), hf, wf).numpy()
    np.testing.assert_array_equal(fg, fg_jax)
    assert fg[0, 2:11, 2:11].all() and fg[0].sum() == 81
    assert fg[1, 10:13, 11:18].all() and fg[1].sum() == 81 + 21


def test_anchors_at_stride_2():
    """Full width: 140 x 188 BEV cells x 3 classes x 2 rotations."""
    grid = (280, 376, 25)
    pcr = (2.0, -30.08, -3.0, 46.8, 30.08, 1.0)
    want = np.asarray(flatten_anchors(j_anchors(
        pcr, grid, jc.CADDN_ANCHOR_CONFIGS)))
    got = pc.AnchorHeadSingle(384, anchor_configs=pc.CADDN_ANCHOR_CONFIGS,
                              point_cloud_range=pcr,
                              grid_size=grid).anchors.numpy()
    assert got.shape == (140 * 188 * 6, 7)
    np.testing.assert_array_equal(got, want)


def test_convert_covers_every_leaf():
    """``from_jax_caddn`` fills every tensor of the full-width model (a
    strict load) and reads every JAX leaf into as many elements (JAX's
    shapes from ``jax.eval_shape``)."""
    jm = jc.CaDDN()
    b = dict(images=jnp.zeros((1, 384, 1280, 3)),
             lidar2cam=jnp.eye(4)[None], cam2img=jnp.eye(4)[None, :3])
    shapes = jax.eval_shape(
        lambda b: jm.init({"params": jax.random.PRNGKey(0)}, b), b)
    v = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = FROM_JAX["CaDDN"](v["params"], v["batch_stats"], v["frozen"], {})
    model = pc.CaDDN()
    model.load_state_dict(sd)  # strict
    n_jax = sum(x.size for x in jax.tree.leaves(v))
    n_port = sum(t.numel() for k, t in sd.items()
                 if not k.endswith("num_batches_tracked"))
    assert n_jax == n_port == sum(
        t.numel() for k, t in model.state_dict().items()
        if not k.endswith("num_batches_tracked"))


def test_several_processes_refused(monkeypatch):
    """``ddn_loss``'s normaliser counts one process's pixels: the loss and
    the trainers' check refuse CaDDN under several processes, naming it."""
    model = pc.CaDDN(**CFG)
    monkeypatch.setattr(pc, "process_count", lambda: 2)
    monkeypatch.setattr(train_pretrain, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="CaDDN.*ddn_loss"):
        model.loss({}, {})
    with pytest.raises(NotImplementedError, match="CaDDN.*ddn_loss"):
        train_pretrain.check_data_parallel(model)


# ---- the whole model ----

def test_eval_forward(case):
    ref, ev = case["ref"]["eval"], case["eval"]
    assert rel(ev["depth_logits"], ref["depth_logits"]) <= OUT_TOL
    for k in ("cls_preds", "box_preds", "dir_preds"):
        assert rel(ev["head_preds"][k], ref["head_preds"][k]) <= OUT_TOL, k
    for k in ("batch_box_preds", "batch_cls_preds"):
        assert rel(ev[k], ref[k]) <= OUT_TOL, k


def test_post_processing_keeps(case):
    """``second_post_processing`` on JAX's eval outputs keeps exactly
    JAX's detections; on the port's own, the same set (its scores
    within 1e-4)."""
    ref = case["ref"]
    for ev in ({k: torch.from_numpy(ref["eval"][k].copy())
                for k in ("batch_box_preds", "batch_cls_preds")},
               case["eval"]):
        with torch.no_grad():
            post = p_post(ev, **POST)
        np.testing.assert_array_equal(post["valid"].numpy(),
                                      ref["post"]["valid"])
        np.testing.assert_array_equal(post["labels"].numpy(),
                                      ref["post"]["labels"])
        for k in ("boxes", "scores", "sem_scores_full"):
            assert rel(post[k], ref["post"][k]) <= OUT_TOL, k
    assert ref["post"]["valid"].sum() >= 4


def test_train_targets(case):
    """Anchor targets, depth-bin targets and the fg mask exactly."""
    ref, model = case["ref"], case["model"]
    b = ref["batch"]
    labels, reg, _ = model.dense_head.targets(torch.from_numpy(b["gt_boxes"]))
    np.testing.assert_array_equal(labels.numpy(), ref["targets"][0])
    np.testing.assert_allclose(reg.numpy(), ref["targets"][1], atol=1e-6)
    assert (labels > 0).any()
    want = np.asarray(jc.bin_depths(
        jnp.asarray(b["depth_maps"]), "LID", 2.0, 18.0, 16)).astype(np.int32)
    np.testing.assert_array_equal(
        model.depth_targets(torch.from_numpy(b["depth_maps"])).numpy(), want)
    assert (want == 16).any() and (want < 16).any()


def _check_terms(got, want, tol=LOSS_RTOL):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= tol * abs(w), (k, got[k], w)


def test_train_losses_and_stats(case):
    """The train-mode pass (batch statistics): loss terms (TRAIN_RTOL),
    depth logits and the batch norms' running statistics."""
    ref = case["ref"]
    _check_terms(case["losses"], ref["losses"], TRAIN_RTOL)
    assert rel(case["train_out"]["depth_logits"],
               ref["train_out"]["depth_logits"]) <= OUT_TOL
    want = FROM_JAX["CaDDN"](ref["grads"], ref["stats"],
                             ref["variables"]["frozen"], CFG)
    n = 0
    for name, buf in case["model"].named_buffers():
        if name.endswith(("running_mean", "running_var")) and \
                "trunk" not in name:
            assert rel(buf, want[name]) <= STAT_RTOL, name
            n += 1
    assert n == 2 * (3 + 1 + 1 + 1 + 3 * 11 + 3)


def test_gradients(case):
    """Every gradient of the eval-mode loss (batch norms at their running
    statistics; the trunk's stem and layer1 frozen) against JAX's, within
    GRAD_TOL of its largest magnitude, or twice the port's own float32
    spread where that is wider: with these random weights the depth
    logits reach magnitudes where float32's order of sums in the convs
    moves the softmax by ~1e-4 and flips ReLUs in the BEV (at 72 x 100
    the port with and without oneDNN's convs differs by up to 2.8e-2 of
    a BEV weight's gradient, and by as much from JAX)."""
    ref = case["ref"]
    _check_terms(case["eval_losses"], ref["eval_losses"])
    want = FROM_JAX["CaDDN"](ref["grads"], ref["variables"]["batch_stats"],
                             ref["variables"]["frozen"], CFG)
    grads, alt = case["grads"], case["grads_alt"]
    frozen = {n for n, _ in case["model"].named_parameters()
              if n.startswith(("ddn.trunk.conv1", "ddn.trunk.layer1."))}
    assert set(grads) == {n for n, _ in case["model"].named_parameters()
                          } - frozen
    for name, g in grads.items():
        tol = max(GRAD_TOL, 2 * rel(alt[name], g.numpy()))
        assert rel(g, want[name]) <= tol, (name, rel(g, want[name]), tol)

