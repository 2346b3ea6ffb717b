"""CPU parity of the port's PV-RCNN training step against the JAX model:
targets, RoI sampling, loss terms, and one whole ``value_and_grad`` step
(losses, every gradient, every BN running statistic).

The model is ``utils/tiny.py``'s ``TINY_PV_CFG`` with the production BEV
depth (``layer_nums=(5, 5)``) and no dropout (``dp_ratio=0``). Weights
come from JAX ``model.init`` (BN running statistics randomized) and reach
the port through ``from_jax_pvrcnn``; the same function maps the JAX
gradients onto the port's parameters (its layout bridges are linear).
The JAX step is jitted once, in a module-scoped fixture, and every test
reads it.

RoI sampling draws random numbers, which ``jax.random`` and torch's
generators cannot share. The JAX step's sampling key is captured, and the
port's ``roi_head._pick`` is replaced by the JAX package's own ``_pick``
on the keys ``sample_rois_single`` splits from it, applied to the
candidate masks the port computes: the picks agree exactly if and only if
the port's masks do.
"""
import copy
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.models.pvrcnn import roi_head as jroi  # noqa: E402
from detmatch_tpu.models.pvrcnn.pvrcnn import PVRCNN as JPVRCNN  # noqa: E402
from detmatch_tpu.ops import voxelize as jvox  # noqa: E402
from detmatch_tpu.utils import tiny  # noqa: E402
from detmatch_tpu_torch.convert import from_jax_pvrcnn  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.backbone3d import (  # noqa: E402
    level_shapes)
from detmatch_tpu_torch.models.pvrcnn.bev import (  # noqa: E402
    height_compression)
from detmatch_tpu_torch.models.pvrcnn import roi_head as proi  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.pvrcnn import PVRCNN  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

CFG = dict(tiny.TINY_PV_CFG,
           bev_cfg=dict(tiny.TINY_PV_CFG["bev_cfg"], layer_nums=(5, 5)),
           roi_head_cfg=dict(tiny.TINY_PV_CFG["roi_head_cfg"], dp_ratio=0.0))
B = 2
LOSS_RTOL = 1e-4
TERM_RTOL = 1e-5
GRAD_TOL = 1e-3   # of each tensor's largest magnitude: ~200 ops sum in
STAT_RTOL = 1e-4  # another order in the two frameworks
# JAX submodules whose train-mode outputs the module tests read
MODULES = ("backbone3d", "backbone2d", "pfe")
LEVELS = ("x_conv1", "x_conv2", "x_conv3", "x_conv4", "out")
HC_Z = level_shapes((41, 32, 32))[-1][0]
HC_C = CFG["backbone3d_cfg"]["out_channels"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tt(tree):
    if isinstance(tree, dict):
        return {k: _tt(v) for k, v in tree.items()}
    return _t(tree)


def rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-8)


def before_fusion_to_port(x):
    n = HC_Z * HC_C
    bev = x[..., :n].reshape(x.shape[:-1] + (HC_Z, HC_C))
    bev = np.swapaxes(bev, -1, -2).reshape(x.shape[:-1] + (n,))
    return np.concatenate([bev, x[..., n:]], axis=-1)


def _batch():
    rng = np.random.RandomState(0)
    view = tiny.tiny_view(rng, b=B, p=256, with_gt=True)
    pts = np.asarray(view["points"])
    valid = np.asarray(view["points_valid"]).copy()
    valid[1, 180:] = False
    gt = np.asarray(view["gt_boxes"]).copy()
    vox = jax.vmap(lambda p, v: jvox.voxelize_mean(p, v, tiny.TINY_SPEC))(
        jnp.asarray(pts), jnp.asarray(valid))
    return dict(points=pts, points_valid=valid, gt_boxes=gt,
                voxel_features=np.asarray(vox["features"]),
                voxel_keys=np.asarray(vox["keys"]))


def gt_near(out, gt):
    """gt with its first three rows per sample replaced by the three
    best proposals, shifted, grown and turned a little, with the
    proposals' classes, and its fourth by a car around the first
    keypoint (point-head foreground)."""
    props = out["proposals"]
    gt = gt.copy()
    gt[:, 3, :3] = out["keypoints"][:, 0]
    gt[:, 3, 3:] = [3.9, 1.6, 1.56, 0.3, 3]
    box = props["rois"][:, :3].copy()
    box[..., 0] += 0.15
    box[..., 3:6] *= 1.05
    box[..., 6] += 0.05
    gt[:, :3, :7] = box
    gt[:, :3, 7] = props["roi_labels"][:, :3]
    assert props["roi_valid"][:, :3].all()
    return gt


@pytest.fixture(scope="module")
def jref():
    """The JAX train step on one B=2 batch: losses, gradients, updated
    batch statistics, the train outputs and the RoI-sampling key."""
    batch = _batch()
    jb = jax.tree.map(jnp.asarray, batch)
    model = JPVRCNN(**CFG)
    var = jax.jit(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b,
                                       train=False))(jb)
    params = _np(var["params"])
    srng = np.random.RandomState(1)

    def rand_stat(path, x):
        if path[-1].key == "var":
            return (0.5 + srng.rand(*x.shape)).astype(np.float32)
        return (0.2 * srng.randn(*x.shape)).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(rand_stat,
                                             _np(var["batch_stats"]))
    captured = {}
    assign = jroi.assign_roi_targets

    def spy(rng_key, proposals, gt_boxes, cfg=None):
        captured["key"] = rng_key
        return assign(rng_key, proposals, gt_boxes, cfg)

    def loss_fn(p, s, b, rng):
        v = {"params": p, "batch_stats": s}
        out, mut = model.apply(
            v, b, train=True, rngs={"sampling": rng, "dropout": rng},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, name: (
                name == "__call__" and mdl.name in MODULES))
        losses = model.apply(v, out, b, method=JPVRCNN.loss)
        return losses["loss"], (losses, mut["batch_stats"], out,
                                captured["key"], mut["intermediates"])

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jroi, "assign_roi_targets", spy)
        # the proposals do not depend on the gts: a first step finds them,
        # and gts placed near the best three give RoI foreground
        first = _np(step(params, stats, jb, jax.random.PRNGKey(7))[0][1][2])
        batch["gt_boxes"] = gt_near(first, batch["gt_boxes"])
        jb = jax.tree.map(jnp.asarray, batch)
        (_, (losses, new_stats, out, key, inter)), grads = step(
            params, stats, jb, jax.random.PRNGKey(7))
    return dict(batch=batch, params=params, stats=stats, losses=_np(losses),
                new_stats=_np(new_stats), out=_np(out), key=key,
                grads=_np(grads),
                inter={k: _np(v["__call__"][0]) for k, v in inter.items()})


def jax_picks(key, b):
    """A stand-in for the port's ``_pick`` that returns the JAX package's
    picks: per sample, the keys ``sample_rois_single`` splits, in the
    order the port draws (fg, fg with replacement, hard bg, easy bg)."""
    seq = []
    for k in jax.random.split(key, b):
        k_fg, k_hard, k_easy, k_fg2 = jax.random.split(k, 4)
        seq += [k_fg, k_fg2, k_hard, k_easy]
    keys = iter(seq)

    def pick(generator, cand_mask, n_slots, with_replacement):
        idx, avail = jroi._pick(next(keys), jnp.asarray(cand_mask.numpy()),
                                n_slots, with_replacement)
        return _t(idx).long(), torch.tensor(int(avail))

    return pick


@pytest.fixture(scope="module")
def port(jref):
    model = PVRCNN(**CFG).train()
    model.load_state_dict(from_jax_pvrcnn(jref["params"], jref["stats"],
                                          CFG))
    return model


@pytest.fixture(scope="module")
def port_step(jref, port):
    """One port training step from the same weights, with the JAX picks."""
    model = copy.deepcopy(port)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(proi, "_pick", jax_picks(jref["key"], B))
        batch = _tt(jref["batch"])
        out = model(batch, train=True, generator=torch.Generator())
        losses = model.loss(out, batch)
    losses["loss"].backward()
    return model, out, losses


def test_train_step_runs_every_branch(jref):
    """The batch gives anchor, point and RoI foreground, so every loss
    term and gradient of the comparison below is exercised."""
    t = jref["out"]["roi_targets"]
    assert t["reg_valid_mask"].sum() > 0
    assert (t["rcnn_cls_labels"] > 0).sum() > 0
    for k, v in jref["losses"].items():
        assert np.isfinite(v) and v > 0, k


def _jax_levels(jref):
    return {name: dict({k: _t(v) for k, v in
                        jref["inter"]["backbone3d"][name].items()
                        if k in ("feats", "keys", "mask")},
                       shape=shape, stride=stride)
            for name, shape, stride in zip(
                LEVELS, level_shapes((41, 32, 32)), (1, 2, 4, 8, 8))}


@pytest.mark.parametrize("module", ["backbone_3d", "backbone_2d", "pfe"])
def test_train_mode_module_matches_jax(jref, port, module):
    """Each train-mode module fed the JAX model's own inputs to it: the
    outputs, and the module's BN running statistics after the update."""
    model = copy.deepcopy(port)
    b, inter = _tt(jref["batch"]), jref["inter"]
    ms = _jax_levels(jref)
    spatial = height_compression(ms["out"])
    if module == "backbone_3d":
        got = model.backbone_3d(b["voxel_features"], b["voxel_keys"])
        for name in LEVELS:
            r = inter["backbone3d"][name]
            np.testing.assert_array_equal(got[name]["keys"].numpy(),
                                          r["keys"])
            assert rel(got[name]["feats"], r["feats"]) <= LOSS_RTOL, name
    elif module == "backbone_2d":
        got = model.backbone_2d(spatial)
        assert rel(got.permute(0, 2, 3, 1), inter["backbone2d"]) <= LOSS_RTOL
    else:
        got = model.pfe(b["points"], b["points_valid"], spatial, ms)
        r = inter["pfe"]
        np.testing.assert_array_equal(got["keypoints"].numpy(),
                                      r["keypoints"])
        assert rel(got["point_features_before_fusion"], before_fusion_to_port(
            r["point_features_before_fusion"])) <= LOSS_RTOL
        assert rel(got["point_features"], r["point_features"]) <= LOSS_RTOL
    ref = from_jax_pvrcnn(jref["params"], jref["new_stats"], CFG)
    sd = model.state_dict()
    keys = [k for k in ref if k.startswith(module + ".")
            and k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        assert rel(sd[k], ref[k].numpy()) <= STAT_RTOL, k


def test_anchor_targets_match_jax(jref, port):
    gt = jref["batch"]["gt_boxes"]
    model = JPVRCNN(**CFG)
    labels, reg, fg = _np(jax.jit(lambda p, g: model.apply(
        {"params": p}, g,
        method=lambda m, g_: m.anchor_head.targets(g_)))(
        jref["params"], jnp.asarray(gt)))
    p_labels, p_reg, p_fg = port.dense_head.targets(_t(gt))
    np.testing.assert_array_equal(p_labels.numpy(), labels)
    np.testing.assert_array_equal(p_fg.numpy(), fg)
    assert (labels > 0).sum() > 0
    assert rel(p_reg, reg) <= TERM_RTOL


def test_point_targets_match_jax(jref, port):
    o, gt = jref["out"], jref["batch"]["gt_boxes"]
    model = JPVRCNN(**CFG)
    ref = np.asarray(jax.jit(lambda p, kp, kv, g: model.apply(
        {"params": p}, kp, kv, g,
        method=lambda m, *a: m.point_head.targets(*a)))(
        jref["params"], o["keypoints"], o["kp_valid"], gt))
    got = port.point_head.targets(_t(o["keypoints"]), _t(o["kp_valid"]),
                                  _t(gt))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref > 0).sum() > 0 and (ref < 0).sum() > 0


def test_roi_sampling_matches_jax(jref, monkeypatch):
    """RoI sampling + targets on the JAX proposals, given the JAX picks:
    the sampled rois, labels, assigned gts, masks and label classes
    (-1 / 0 / soft / 1) agree exactly. The soft labels and IoUs are
    linear in the 3D IoU, whose convex-clipping area the two packages
    round differently in float32 (~1e-5): they agree within 1e-4, and the
    canonical-frame gts (a rotation) within 1e-5."""
    props = jref["out"]["proposals"]
    gt = jref["batch"]["gt_boxes"]
    cfg = CFG["roi_head_cfg"]["target_cfg"]
    ref = _np(jax.jit(lambda k, p, g: jroi.assign_roi_targets(k, p, g, cfg))(
        jref["key"], props, gt))
    monkeypatch.setattr(proi, "_pick", jax_picks(jref["key"], B))
    got = proi.assign_roi_targets(torch.Generator(), _tt(props), _t(gt), cfg)
    for k in ("rois", "roi_labels", "gt_of_rois", "gt_of_rois_src",
              "reg_valid_mask"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    assert rel(got["gt_of_rois_ct"], ref["gt_of_rois_ct"]) <= TERM_RTOL
    lab, rlab = got["rcnn_cls_labels"].numpy(), ref["rcnn_cls_labels"]
    for v in (-1.0, 0.0, 1.0):
        np.testing.assert_array_equal(lab == v, rlab == v)
    assert ((rlab > 0) & (rlab < 1)).any()
    for k in ("rcnn_cls_labels", "roi_ious"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0,
                                   atol=1e-4, err_msg=k)


def test_loss_terms_match_jax(jref, port):
    """Every term of ``PVRCNN.loss`` on the JAX model's own train outputs
    and batch."""
    o = jref["out"]
    out = {k: _tt(o[k]) for k in ("head_preds", "keypoints", "kp_valid",
                                  "point_logits", "rcnn_cls", "rcnn_reg",
                                  "roi_targets")}
    got = port.loss(out, _tt(jref["batch"]))
    assert set(got) == set(jref["losses"])
    for k, v in jref["losses"].items():
        assert rel(got[k], v) <= TERM_RTOL, (k, float(got[k]), float(v))


def test_train_step_losses_match_jax(jref, port_step):
    _, out, losses = port_step
    o = jref["out"]
    np.testing.assert_array_equal(out["roi_labels"].numpy(), o["roi_labels"])
    assert rel(out["rois"], o["rois"]) <= LOSS_RTOL
    for k, v in jref["losses"].items():
        assert rel(losses[k], v) <= LOSS_RTOL, (k, float(losses[k]),
                                                float(v))


def test_train_step_gradients_match_jax(jref, port_step):
    model = port_step[0]
    zero = jax.tree.map(np.zeros_like, jref["stats"])
    ref = from_jax_pvrcnn(jref["grads"], zero, CFG)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len([k for k in ref if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))])
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert rel(g, ref[name].numpy()) <= GRAD_TOL, name
    bb = model.backbone_3d
    for conv in (bb.conv_input[0], bb.conv1[0][0], bb.conv_out[0]):
        assert conv.weight.grad.abs().max() > 0


def test_train_step_running_stats_match_jax(jref, port_step):
    model = port_step[0]
    ref = from_jax_pvrcnn(jref["params"], jref["new_stats"], CFG)
    sd = model.state_dict()
    n = 0
    for k, v in ref.items():
        if k.endswith(("running_mean", "running_var")):
            assert rel(sd[k], v.numpy()) <= STAT_RTOL, k
            n += 1
    assert n > 0


def test_adamw_clip_step_matches_optax(jref):
    """One clip + AdamW step from identical parameters and identical
    gradients (the JAX step's, converted) against optax's
    ``chain(clip_by_global_norm(10), adamw(cyclic_lr))``: parameters
    within 1e-6 and updates within 1e-3 of their largest magnitude (an
    update of ~1e-3 read off parameters near 1 carries their float32 ulp,
    ~1.2e-4 of it)."""
    import optax

    from detmatch_tpu.train import optim as joptim
    from detmatch_tpu_torch.train import optim as poptim
    total = 100
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     joptim.adamw(joptim.cyclic_lr(0.001, total)))
    def step(grads, params):  # jitted: one program, not one per leaf
        upd, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, upd)

    ref = from_jax_pvrcnn(_np(jax.jit(step)(
        jax.tree.map(jnp.asarray, jref["grads"]),
        jax.tree.map(jnp.asarray, jref["params"]))), jref["stats"], CFG)

    model = PVRCNN(**CFG)
    model.load_state_dict(from_jax_pvrcnn(jref["params"], jref["stats"],
                                          CFG))
    zero = jax.tree.map(np.zeros_like, jref["stats"])
    grads = from_jax_pvrcnn(jref["grads"], zero, CFG)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    opt, sched = poptim.make_optimizer(list(model.parameters()), 0.001,
                                       total)
    norm = poptim.clip_grad_norm_(list(model.parameters()))
    opt.step()
    sched.step()
    assert float(norm) > 0
    for n, p in model.named_parameters():
        assert rel(p, ref[n].numpy()) <= 1e-6, n
        assert rel(p.detach() - before[n],
                   ref[n].numpy() - before[n].numpy()) <= 1e-3, n
