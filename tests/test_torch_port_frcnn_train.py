"""CPU parity of the port's Faster R-CNN training half (``detmatch_tpu_torch/
models/frcnn``: ``DeltaXYWHCoder.encode``, ``max_iou_assign``,
``random_sample``, ``rpn_loss``, ``sample_rcnn_targets``, ``rcnn_loss``,
the train forward and ``FasterRCNN.loss``) against the JAX package.

The samplers draw their uniforms through ``rpn.sample_uniforms``; the
tests replace it to hand over the uniforms JAX draws from its keys, so
that the picks agree exactly if and only if the port's assignment and
ranking do. The model is ``TINY_FR_CFG`` at B=2 with JAX ``init``
weights (the box classifier's biases spread, as in
``test_torch_port_frcnn.py``), brought over by ``from_jax_frcnn``.

Tolerances: the assignment and the picks exactly; the coder within
1e-6; losses within 1e-4 of their value; gradients within 1e-3 of each
tensor's largest magnitude.
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

from detmatch_tpu.core import coders as jcoders  # noqa: E402
from detmatch_tpu.models.frcnn import roi_head2d as jroi  # noqa: E402
from detmatch_tpu.models.frcnn import rpn as jrpn  # noqa: E402
from detmatch_tpu.models.frcnn.faster_rcnn import (  # noqa: E402
    FasterRCNN as JFasterRCNN)
from detmatch_tpu_torch.convert import from_jax_frcnn  # noqa: E402
from detmatch_tpu_torch.core import coders  # noqa: E402
from detmatch_tpu_torch.models.frcnn import roi_head2d as proi  # noqa: E402
from detmatch_tpu_torch.models.frcnn import rpn as prpn  # noqa: E402
from detmatch_tpu_torch.models.frcnn.faster_rcnn import (  # noqa: E402
    FasterRCNN)
from detmatch_tpu_torch.utils import tiny  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
CFG = tiny.TINY_FR_CFG
B = 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = ref.detach().numpy() if isinstance(ref, torch.Tensor) else ref
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-12)


def boxes(rng, n, scale=120.0):
    xy = rng.rand(n, 2) * scale
    return np.concatenate([xy, xy + rng.rand(n, 2) * 40 + 2],
                          -1).astype(np.float32)


def uniforms_of(keys):
    """``rpn.sample_uniforms`` returning JAX's uniforms of ``keys`` in
    order (one key per ``random_sample`` call)."""
    it = iter(keys)

    def draw(generator, n, device):
        k1, k2 = jax.random.split(next(it))
        return (_t(jax.random.uniform(k1, (n,))),
                _t(jax.random.uniform(k2, (n,))))

    return draw


def frcnn_loss_keys(key, b):
    """The keys of the ``random_sample`` calls of JAX's
    ``FasterRCNN.loss(key)``, in the port's order (RPN images, then RoI
    images)."""
    k_rpn, k_rcnn = jax.random.split(key)
    return list(jax.random.split(k_rpn, b)) + list(jax.random.split(k_rcnn,
                                                                    b))


@pytest.mark.parametrize("stds", [(1.0, 1.0, 1.0, 1.0), proi.BBOX_STDS])
def test_delta_coder_encode_matches_jax(stds):
    """Within 1e-6 of the largest delta: XLA's and PyTorch's float32 log
    differ in the last bit for some arguments."""
    rng = np.random.RandomState(0)
    p, g = boxes(rng, 200), boxes(rng, 200)
    p[3, 2] = p[3, 0]  # a zero-width proposal (clamped at 1e-6)
    ours = coders.DeltaXYWHCoder(target_stds=stds).encode(_t(p), _t(g))
    want = jcoders.DeltaXYWHCoder(target_stds=stds).encode(jnp.asarray(p),
                                                           jnp.asarray(g))
    assert rel(ours, want) <= 1e-6


@pytest.mark.parametrize("thr", [(0.7, 0.3, 0.3, True),
                                 (0.5, 0.5, 0.5, False)])
def test_max_iou_assign_matches_jax(thr):
    """RPN and RoI thresholds: a gt box repeated (argmax and force-match
    ties), an invalid gt, invalid candidates; exactly equal."""
    rng = np.random.RandomState(1)
    gt = boxes(rng, 8)
    gt[5] = gt[2]
    gv = np.ones(8, bool)
    gv[7] = False
    cand = np.concatenate([gt, boxes(rng, 300)])
    cand[40:60] = gt[rng.randint(0, 8, 20)] + rng.randn(20, 4).astype(
        np.float32)
    valid = rng.rand(308) > 0.1
    ours = prpn.max_iou_assign(_t(cand), _t(valid), _t(gt), _t(gv), *thr)
    want = jrpn.max_iou_assign(jnp.asarray(cand), jnp.asarray(valid),
                               jnp.asarray(gt), jnp.asarray(gv), *thr)
    for o, w, name in zip(ours, want, ("assigned", "max_iou", "argmax")):
        np.testing.assert_array_equal(o.numpy(), np.asarray(w), err_msg=name)
    assert (ours[0] > 0).sum() > 0 and (ours[0] == 0).sum() > 0


@pytest.mark.parametrize("n_pos,n_neg", [(300, 2000), (20, 2000),
                                         (50, 0), (0, 0)])
def test_random_sample_matches_jax(monkeypatch, n_pos, n_neg):
    """The positive cap, too few positives, no negatives, nothing at all,
    with JAX's uniforms handed over: the picks exactly."""
    rng = np.random.RandomState(2)
    n = 2500
    assigned = np.full(n, -1, np.int32)
    perm = rng.permutation(n)
    assigned[perm[:n_pos]] = rng.randint(1, 5, n_pos)
    assigned[perm[n_pos:n_pos + n_neg]] = 0
    key = jax.random.PRNGKey(4)
    monkeypatch.setattr(prpn, "sample_uniforms", uniforms_of([key]))
    ours = prpn.random_sample(None, _t(assigned).long(), 256, 0.5)
    want = jrpn.random_sample(key, jnp.asarray(assigned), 256, 0.5)
    for o, w in zip(ours, want):
        np.testing.assert_array_equal(o.numpy(), np.asarray(w))


def _rpn_case(rng):
    model = FasterRCNN(**CFG)
    anchors = [a.numpy() for a in model.anchors]
    outs = []
    for a in anchors:
        h = int(np.sqrt(a.shape[0] / 3 / 2))  # 1:2 canvas levels
        w = a.shape[0] // 3 // h
        outs.append(((rng.randn(B, h, w, 3) * 2).astype(np.float32),
                     (rng.randn(B, h, w, 12) * 0.3).astype(np.float32)))
    gt = np.stack([boxes(rng, 6, 100) for _ in range(B)])
    gv = np.zeros((B, 6), bool)
    gv[0, :4] = True
    gv[1, :2] = True
    return anchors, outs, gt, gv


def test_rpn_loss_matches_jax(monkeypatch):
    """Both RPN terms and their gradients w.r.t. the head outputs."""
    rng = np.random.RandomState(3)
    anchors, outs, gt, gv = _rpn_case(rng)
    key = jax.random.PRNGKey(5)

    def jloss(o):
        r = jrpn.rpn_loss(key, o, [jnp.asarray(a) for a in anchors],
                          jnp.asarray(gt), jnp.asarray(gv))
        return r["loss_rpn_cls"] + r["loss_rpn_bbox"], r

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(
        [tuple(jnp.asarray(x) for x in o) for o in outs])
    monkeypatch.setattr(prpn, "sample_uniforms",
                        uniforms_of(list(jax.random.split(key, B))))
    t_outs = [tuple(_t(x).requires_grad_() for x in o) for o in outs]
    ours = prpn.rpn_loss(None, t_outs, [_t(a) for a in anchors], _t(gt),
                         _t(gv))
    for k, v in want.items():
        assert rel(ours[k], v) <= LOSS_RTOL, k
    (ours["loss_rpn_cls"] + ours["loss_rpn_bbox"]).backward()
    for (c, r), (jc, jr) in zip(t_outs, jg):
        assert rel(c.grad, jc) <= GRAD_TOL
        assert rel(r.grad, jr) <= GRAD_TOL
    assert float(want["loss_rpn_bbox"]) > 0


def test_rcnn_targets_and_loss_match_jax(monkeypatch):
    """RoI sampling with the gt appended (exactly, given JAX's uniforms),
    then the focal + class-specific L1 loss and its gradients."""
    rng = np.random.RandomState(4)
    gt = np.stack([boxes(rng, 6, 100) for _ in range(B)])
    gl = rng.randint(0, 3, (B, 6)).astype(np.int32)
    gv = np.ones((B, 6), bool)
    gv[1, 3:] = False
    props = np.stack([np.concatenate([gt[b] + rng.randn(6, 4).astype(
        np.float32) * 3, boxes(rng, 42, 100)]) for b in range(B)])
    pv = rng.rand(B, 48) > 0.2
    keys = list(jax.random.split(jax.random.PRNGKey(6), B))
    want_t = [jroi.sample_rcnn_targets(k, jnp.asarray(props[b]),
                                       jnp.asarray(pv[b]),
                                       jnp.asarray(gt[b]),
                                       jnp.asarray(gl[b]),
                                       jnp.asarray(gv[b]), num=24)
              for b, k in enumerate(keys)]
    monkeypatch.setattr(prpn, "sample_uniforms", uniforms_of(keys))
    ours_t = [proi.sample_rcnn_targets(None, _t(props[b]), _t(pv[b]),
                                       _t(gt[b]), _t(gl[b]), _t(gv[b]),
                                       num=24) for b in range(B)]
    for o, w in zip(ours_t, want_t):
        for k in ("rois", "labels", "is_pos", "slot_valid"):
            np.testing.assert_array_equal(o[k].numpy(), np.asarray(w[k]),
                                          err_msg=k)
        assert rel(o["reg_targets"], w["reg_targets"]) <= 1e-6
    assert sum(int(o["is_pos"].sum()) for o in ours_t) > 0
    targets = {k: torch.stack([o[k] for o in ours_t]) for k in ours_t[0]}
    jt = jax.tree.map(lambda *x: jnp.stack(x), *want_t)
    cls = (rng.randn(B, 24, 4) * 2).astype(np.float32)
    reg = rng.randn(B, 24, 12).astype(np.float32)

    def jloss(c, r):
        out = jroi.rcnn_loss(c, r, jt)
        return out["loss_cls"] + out["loss_bbox"], out

    (_, want), (jgc, jgr) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jnp.asarray(cls), jnp.asarray(reg))
    tc, tr = _t(cls).requires_grad_(), _t(reg).requires_grad_()
    ours = proi.rcnn_loss(tc, tr, targets)
    for k, v in want.items():
        assert rel(ours[k], v) <= LOSS_RTOL, k
    (ours["loss_cls"] + ours["loss_bbox"]).backward()
    assert rel(tc.grad, jgc) <= GRAD_TOL
    assert rel(tr.grad, jgr) <= GRAD_TOL


@pytest.fixture(scope="module")
def train_ref():
    """JAX train forward + loss + gradients of the tiny Faster R-CNN on a
    B=2 batch with real gts."""
    rng = np.random.RandomState(0)
    img = rng.randn(B, *tiny.TINY_CANVAS, 3).astype(np.float32)
    shapes = np.array([[64.0, 128.0], [60.0, 110.0]], np.float32)
    gt = np.stack([boxes(rng, 6, 50) for _ in range(B)])
    gl = rng.randint(0, 3, (B, 6)).astype(np.int32)
    gv = np.ones((B, 6), bool)
    gv[1, 4:] = False
    model = JFasterRCNN(**CFG)
    var = jax.jit(lambda i, s: model.init(jax.random.PRNGKey(0), i, s,
                                          train=True))(
        jnp.asarray(img), jnp.asarray(shapes))
    params = _np(var["params"])
    cls = params["bbox_head"]["fc_cls"]
    cls["bias"] = (0.5 * rng.randn(*cls["bias"].shape)).astype(np.float32)
    frozen = _np(var["frozen"])
    key = jax.random.PRNGKey(9)

    def loss_fn(p):
        v = {"params": p, "frozen": frozen}
        fwd = model.apply(v, jnp.asarray(img), jnp.asarray(shapes),
                          train=True)
        losses = model.apply(v, key, fwd, jnp.asarray(gt), jnp.asarray(gl),
                             jnp.asarray(gv), method=JFasterRCNN.loss)
        return sum(losses.values()), (losses, fwd["proposals"],
                                      fwd["proposal_scores"])

    (_, (losses, props, pscores)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return dict(img=img, shapes=shapes, gt=gt, gl=gl, gv=gv, params=params,
                frozen=frozen, key=key, losses=_np(losses),
                props=np.asarray(props), pscores=np.asarray(pscores),
                grads=_np(grads))


@pytest.fixture(scope="module")
def train_port(train_ref):
    r = train_ref
    model = FasterRCNN(**CFG)
    model.load_state_dict(from_jax_frcnn(r["params"], r["frozen"], CFG))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prpn, "sample_uniforms",
                   uniforms_of(frcnn_loss_keys(r["key"], B)))
        fwd = model(_t(r["img"]).permute(0, 3, 1, 2).contiguous(),
                    _t(r["shapes"]), train=True)
        losses = model.loss(None, fwd, _t(r["gt"]), _t(r["gl"]), _t(r["gv"]))
    sum(losses.values()).backward()
    return model, fwd, losses


def test_train_forward_uses_train_sizes_and_detaches(train_ref, train_port):
    """2,000 / 1,000 of the production recipe, 96 / 48 here: the train
    proposals equal JAX's, carry no gradient, and RoIAlign sends none to
    the rois."""
    _, fwd, _ = train_port
    assert fwd["proposals"].shape == (B, CFG["train_rpn_max"], 4)
    assert not fwd["proposals"].requires_grad
    np.testing.assert_array_equal(fwd["proposal_scores"].numpy() > -1e9,
                                  train_ref["pscores"] > -1e9)
    assert rel(fwd["proposals"], train_ref["props"]) <= LOSS_RTOL
    model = copy.deepcopy(train_port[0])
    rois = fwd["proposals"][:, :5].clone().requires_grad_()
    feats = [f.detach().requires_grad_() for f in fwd["feats"]]
    cls, _ = model.roi_forward(feats, rois)
    cls.sum().backward()
    assert rois.grad is None and feats[0].grad.any()


def test_train_losses_match_jax(train_ref, train_port):
    losses = train_port[2]
    assert set(losses) == set(train_ref["losses"])
    for k, v in train_ref["losses"].items():
        assert rel(losses[k], v) <= LOSS_RTOL, (k, float(losses[k]), v)
        assert float(v) > 0, k


def test_train_gradients_match_jax(train_ref, train_port):
    """Every parameter's gradient within 1e-3 of its tensor's largest
    magnitude; the frozen stem and first stage get none, as in JAX."""
    model = train_port[0]
    zero = jax.tree.map(np.zeros_like, train_ref["frozen"])
    want = from_jax_frcnn(train_ref["grads"], zero, CFG)
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert rel(g, want[name]) <= GRAD_TOL, name
    assert model.backbone.conv1.weight.grad is None
    assert model.backbone.layer2[0].conv1.weight.grad.any()
