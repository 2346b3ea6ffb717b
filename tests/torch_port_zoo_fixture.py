"""Shared set-up of the LiDAR zoo's CPU parity tests
(``test_torch_port_zoo_*.py``): tiny scenes from a numpy seed, one JAX run
per model (eval forward + post-processing, and one jitted train step:
losses, gradients, batch-norm statistics) and the port's run on the same
weights, brought over by ``convert.FROM_JAX``.

Sizes are those of JAX's own zoo tests: PCR (0, -8, -3, 16, 8, 1), a
32 × 32 × 40 grid, caps (512, 512, 384, 384), B = 2 frames of 512
points. ``voxel_size`` is passed to both packages explicitly.

Weights: numpy draws in the shapes of the JAX model's variables
(``random_variables``), the anchor head's class biases spread around
zero, so that scores vary and proposals pass the 0.1 score filter. Random draws: the RoI
picks and dropout masks of JAX's train step are handed to the port
(``torch_port_ssl_fixture.roi_picks`` / ``DropoutMasks``), and the JAX
step takes its anchor targets from an op-by-op run (see ``run_jax``).

Train mode runs twice in one JAX program. Gradients come from a pass
with the batch norms frozen at their running statistics (RoI sampling,
dropout and losses as in training): with batch statistics over these
tiny maps (a 4 x 4 BEV, 8 positions a channel in its second block) the
float32 gradient is ill-conditioned, and the port against itself at one
and at eight CPU threads differs by up to 10% on PointPillars' BEV
weights. The loss terms, outputs and batch-norm statistics of a second
pass with batch statistics are held too.
"""
import contextlib
import os
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.models.layers import (  # noqa: E402
    MaskedBatchNorm as JMaskedBN)
from detmatch_tpu.models.pvrcnn import roi_head as jroi  # noqa: E402
from detmatch_tpu.models.pvrcnn.anchor_head import (  # noqa: E402
    AnchorHeadSingle as JAnchorHead)
from detmatch_tpu.ops import voxelize as jvox  # noqa: E402
from detmatch_tpu_torch.apis.build import build_detector  # noqa: E402
from detmatch_tpu_torch.convert import FROM_JAX  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn import roi_head as proi  # noqa: E402
from detmatch_tpu_torch.ops import voxelize as pvox  # noqa: E402
import torch_port_ssl_fixture as fx  # noqa: E402

PCR = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
VS = (0.5, 0.5, 0.1)
B, P = 2, 512
CFG = dict(num_classes=3, point_cloud_range=PCR, voxel_size=VS,
           grid_size=(32, 32, 40), backbone_caps=(512, 512, 384, 384))
NMS = dict(train_nms=dict(nms_pre=256, nms_post=64, nms_thresh=0.8),
           test_nms=dict(nms_pre=256, nms_post=16, nms_thresh=0.7))
VOX = (PCR, VS, 512, 5)

LOSS_RTOL = 1e-4   # each loss term, relative
OUT_TOL = 1e-4     # dense outputs, of the tensor's largest magnitude
GRAD_TOL = 1e-3    # each gradient, of its largest magnitude
STAT_RTOL = 1e-4   # batch-norm running statistics after the train step


def scene(seed=0, b=B, p=P):
    """Points (B, P, 4) in the tiny range and two gt boxes a frame."""
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.rand(b, p) * 15 + 0.5, rng.rand(b, p) * 15 - 7.5,
                    rng.rand(b, p) * 3.5 - 2.8, rng.rand(b, p)],
                   -1).astype(np.float32)
    gt = np.zeros((b, 8, 8), np.float32)
    gt[:, :2, 0] = [5.0, 10.0]
    gt[:, :2, 1] = [0.0, -3.0]
    gt[:, :2, 2] = -1.0
    gt[:, :2, 3:6] = [3.9, 1.6, 1.56]
    gt[:, :2, 6] = [0.3, -1.2]
    gt[:, :2, 7] = [3, 1]
    return pts, np.ones((b, p), bool), gt


def jax_voxelize(pts, valid, spec_args):
    spec = jvox.VoxelizerSpec(*spec_args)
    return jax.vmap(lambda x, v: jvox.voxelize_mean(x, v, spec))(
        jnp.asarray(pts), jnp.asarray(valid))


def port_voxelize(pts, valid, spec_args):
    return pvox.voxelize_mean(torch.from_numpy(pts), torch.from_numpy(valid),
                              pvox.VoxelizerSpec(*spec_args))


def voxel_batches(pts, valid, gt, spec_args=VOX):
    """The voxel models' batch in both packages (each voxelized by its
    own package)."""
    jv = jax_voxelize(pts, valid, spec_args)
    pv = port_voxelize(pts, valid, spec_args)
    jb = dict(voxel_features=jv["features"], voxel_keys=jv["keys"],
              points=jnp.asarray(pts), points_valid=jnp.asarray(valid),
              gt_boxes=jnp.asarray(gt))
    tb = dict(voxel_features=pv["features"], voxel_keys=pv["keys"],
              points=torch.from_numpy(pts), points_valid=torch.from_numpy(
                  valid), gt_boxes=torch.from_numpy(gt))
    return jb, tb


def random_variables(jmodel, batch, seed, spread):
    """Variables of ``jmodel`` drawn with numpy from ``seed`` in the
    scales of its initialisers (the tree's shapes from
    ``jax.eval_shape``, so no init program is compiled): kernels
    LeCun-normal over their fan-in (He-normal for the sparse convs'
    ``_w``, N(0, 0.001) for the box regressors), batch-norm scales 1 and
    biases 0 but the ``spread`` biases, 0.5 N; running means 0.2 N and
    variances 0.5 + U(0, 1)."""
    key = jax.random.PRNGKey(seed)
    rngs = {"params": key, "sampling": key, "dropout": key}
    shapes = jax.eval_shape(lambda b: jmodel.init(rngs, b, train=True),
                            batch)
    rng = np.random.RandomState(seed + 1)

    def leaf(path, x):
        keys = tuple(p.key for p in path)
        name, parent = keys[-1], keys[1:-1]
        if name == "var":
            v = 0.5 + rng.rand(*x.shape)
        elif name == "mean":
            v = 0.2 * rng.randn(*x.shape)
        elif name == "scale":
            v = np.ones(x.shape)
        elif name == "bias":
            v = (0.5 * rng.randn(*x.shape) if parent in spread
                 else np.zeros(x.shape))
        else:
            fan_in = np.prod(x.shape[:-1])
            std = (0.001 if parent[-1] in ("reg_out", "conv_box")
                   else np.sqrt((2.0 if name.endswith("_w") else 1.0)
                                / fan_in))
            v = std * rng.randn(*x.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@contextlib.contextmanager
def frozen_bn_jax(flag):
    """While tracing inside, every JAX ``MaskedBatchNorm`` normalizes with
    its running statistics (``flag`` True) or as called (False)."""
    if not flag:
        yield
        return
    orig = JMaskedBN.__call__

    def call(self, x, mask=None, use_running_average=None):
        return orig(self, x, mask=mask, use_running_average=True)

    JMaskedBN.__call__ = call
    try:
        yield
    finally:
        JMaskedBN.__call__ = orig


def run_jax(jmodel, batch, post_fn, spread=(("dense_head", "conv_cls"),),
            seed=0, train=True):
    """One JAX model's reference run: variables, the eval forward and its
    post-processing and (``train``) one jitted program of two train-mode
    passes with the sampling keys and dropout masks they drew: the loss
    terms and ``value_and_grad`` with the batch norms frozen (running
    statistics), then the loss terms, outputs and new batch-norm
    statistics of a forward with batch statistics."""
    variables = random_variables(jmodel, batch, seed, spread)
    ev = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, batch)
    ref = dict(variables=variables, eval=jax.tree.map(np.asarray, ev),
               post=jax.tree.map(np.asarray, jax.jit(post_fn)(ev)))
    if not train:
        return ref
    masks, keys = fx.DropoutMasks(), []
    assign = jroi.assign_roi_targets
    modules = {sys.modules[c.__module__] for c in type(jmodel).__mro__}
    # the anchor targets op by op: JAX's jitted assignment can break an
    # IoU tie at the 2^-20 grid otherwise than its op-by-op run (2 of
    # 1,536 PointPillars anchors here); the port's equals the latter
    targets = (jmodel.apply(variables, batch["gt_boxes"],
                            method=lambda m, g: m.anchor_head.targets(g))
               if "dense_head" in variables["params"] else None)

    def spy(rng_key, proposals, gt_boxes, cfg=None):
        keys.append(rng_key)
        return assign(rng_key, proposals, gt_boxes, cfg)

    def step(v, b, rng):
        k_s, k_d = jax.random.split(rng)

        def loss(p, frozen):
            with frozen_bn_jax(frozen):
                out, new = jmodel.apply(
                    dict(v, params=p), b, train=True,
                    rngs={"sampling": k_s, "dropout": k_d},
                    mutable=["batch_stats"])
            terms = jmodel.apply(dict(v, params=p), out, b,
                                 method=type(jmodel).loss)
            return terms["loss"], (terms, new, out)

        (_, (frozen_terms, _, frozen_out)), grads = jax.value_and_grad(
            loss, has_aux=True)(v["params"], True)
        _, (terms, new, out) = loss(v["params"], False)
        return (frozen_terms, grads, frozen_out.get("proposals"), terms,
                new, out, list(keys), list(masks.traced))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jroi, "assign_roi_targets", spy)
        if targets is not None:
            mp.setattr(JAnchorHead, "targets", lambda self, g: targets)
        for module in modules:
            if hasattr(module, "assign_roi_targets"):
                mp.setattr(module, "assign_roi_targets", spy)
        rec = masks.recording()
        try:
            (frozen_terms, grads, frozen_props, terms, new, out, drawn_keys,
             drawn) = jax.jit(step)(variables, batch,
                                    jax.random.PRNGKey(seed + 7))
        finally:
            rec.undo()
    half = len(drawn) // 2
    frozen_masks, masks = fx.DropoutMasks(), fx.DropoutMasks()
    frozen_masks.masks = [np.asarray(m) for m in drawn[:half]]
    masks.masks = [np.asarray(m) for m in drawn[half:]]
    assert len(drawn_keys) == (0 if frozen_props is None else 2)
    ref.update(frozen=dict(losses=_floats(frozen_terms),
                           grads=jax.tree.map(np.asarray, grads),
                           keys=drawn_keys[:1], masks=frozen_masks,
                           proposals=_np(frozen_props)),
               losses=_floats(terms),
               new_stats=jax.tree.map(np.asarray, new["batch_stats"]),
               train_out=jax.tree.map(np.asarray, out),
               keys=drawn_keys[1:], masks=masks,
               anchor_targets=jax.tree.map(np.asarray, targets))
    return ref


def _np(tree):
    return None if tree is None else jax.tree.map(np.asarray, tree)


def _floats(terms):
    return {k: float(v) for k, v in terms.items()}


def port_model(kind, cfg, ref):
    """The port's ``kind`` model on the CPU with the reference weights."""
    model = build_detector({"model": {"detector_3d": dict(type=kind, **cfg)}},
                           device="cpu")
    v = ref["variables"]
    model.load_state_dict(FROM_JAX[kind](v["params"], v.get("batch_stats",
                                                            {}), cfg))
    return model


def _train_step(model, batch, ref, frozen):
    """The port's train forward and losses with the RoI picks, dropout
    masks and proposals of ``ref`` (one JAX pass: ``keys``, ``masks``,
    ``proposals``); ``frozen``: the batch norms in eval mode, and the
    backward → (outputs, loss terms, gradients or None)."""
    model.train()
    if frozen:
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.eval()
    props = ref["proposals"]
    with pytest.MonkeyPatch.context() as mp:
        if ref["keys"]:
            mp.setattr(proi, "_pick", fx.roi_picks(ref["keys"][0], B))
        if props is not None:
            # JAX's proposals: random weights give near-equal scores, and
            # a 1e-4 difference in train mode reorders them, and with
            # them the RoI picks (the eval forward compares the port's)
            pinned = {k: torch.from_numpy(np.array(v))
                      for k, v in props.items()}
            mp.setattr(sys.modules[type(model).__module__], "proposal_layer",
                       lambda *a, **k: pinned)
        ref["masks"].replay(mp)
        with torch.set_grad_enabled(frozen):
            out = model(batch, generator=torch.Generator())
            losses = model.loss(out, batch)
        if frozen:
            losses["loss"].backward()
    grads = ({n: p.grad.clone() for n, p in model.named_parameters()
              if p.grad is not None} if frozen else None)
    return out, {k: float(v.detach()) for k, v in losses.items()}, grads


def run_port(kind, cfg, ref, batch, post_fn, train=True):
    """The port's eval forward and post-processing and (``train``) the
    two train-mode passes of :func:`run_jax` with its RoI picks and
    dropout masks: frozen-BN loss terms and gradients, then the loss
    terms, outputs and the model (batch-norm statistics updated) of the
    forward with batch statistics."""
    model = port_model(kind, cfg, ref)
    with torch.no_grad():
        ev = model(batch)
        post = post_fn(ev)
    res = dict(model=model, eval=ev, post=post)
    if not train:
        return res
    with fx.port_threads():
        _, f_losses, grads = _train_step(port_model(kind, cfg, ref), batch,
                                         ref["frozen"], frozen=True)
        out, losses, _ = _train_step(model, batch, dict(
            ref, proposals=ref["train_out"].get("proposals")),
            frozen=False)
    res.update(frozen=dict(losses=f_losses, grads=grads), train_out=out,
               losses=losses)
    return res


def rel(out, ref):
    return fx.rel(out, ref)


def check_anchor_targets(port, ref, gt):
    """The port's anchor targets equal JAX's (op by op): labels exactly,
    regression targets within 1e-6."""
    got = port["model"].dense_head.targets(torch.from_numpy(gt))
    want = ref["anchor_targets"]
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=1e-6)
    assert (want[0] > 0).any()


def _check_terms(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= LOSS_RTOL * max(abs(w), 1e-6), (
            k, got[k], w)


def check_losses(port, ref):
    """Every loss term of both train passes (frozen batch norms and
    batch statistics)."""
    _check_terms(port["frozen"]["losses"], ref["frozen"]["losses"])
    _check_terms(port["losses"], ref["losses"])


def check_grads(kind, cfg, port, ref, tol=GRAD_TOL):
    """Every parameter's gradient of the frozen-BN pass against JAX's
    (mapped by the same converter), within ``tol`` of its largest
    magnitude, and the batch-norm running statistics after the pass with
    batch statistics."""
    grads = port["frozen"]["grads"]
    want = FROM_JAX[kind](ref["frozen"]["grads"], ref["new_stats"], cfg)
    model = port["model"]
    names = {n for n, p in model.named_parameters()}
    assert set(grads) == names, names - set(grads)
    for name, g in grads.items():
        assert rel(g, want[name]) <= tol, (name, rel(g, want[name]))
    n = 0
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert rel(buf, want[name]) <= STAT_RTOL, name
            n += 1
    assert n > 0


def check_sampled_rois(port, ref):
    """The train step's sampled RoIs: the same picks (labels and the
    regression mask exactly, boxes within OUT_TOL)."""
    pt, rt = port["train_out"], ref["train_out"]
    np.testing.assert_array_equal(pt["roi_labels"].numpy(),
                                  rt["roi_labels"])
    np.testing.assert_array_equal(
        pt["roi_targets"]["reg_valid_mask"].numpy(),
        rt["roi_targets"]["reg_valid_mask"])
    assert rel(pt["rois"], rt["rois"]) <= OUT_TOL


def check_dense(port_out, ref_out, keys=("cls_preds", "box_preds",
                                         "dir_preds")):
    for k in keys:
        assert rel(port_out["head_preds"][k], ref_out["head_preds"][k]) \
            <= OUT_TOL, k


def check_post(port_post, ref_post, tol=OUT_TOL):
    """Post-processed detections: the same kept set (exact), boxes,
    scores and class scores within ``tol``."""
    np.testing.assert_array_equal(port_post["valid"].numpy(),
                                  ref_post["valid"])
    np.testing.assert_array_equal(port_post["labels"].numpy(),
                                  ref_post["labels"])
    for k in ("boxes", "scores", "sem_scores_full"):
        assert rel(port_post[k], ref_post[k]) <= tol, k
    assert port_post["valid"].any()
