"""CPU parity of the port's DetMatch student-half building blocks against
the JAX package: ``nms_2d_boxset``, ``pseudo_gt_from_boxset``,
``hungarian_consistency_loss`` (value and gradient on pinned, matching
pairs), ``PVRCNN.loss_grouped``, the EMA and both ramps, the two branch
optimizers against optax, and the labeled synthetic views.

Tolerances: discrete outputs and pure copies exactly; the consistency
loss within 1e-5 of its value and its gradient within 1e-4 of the
largest magnitude; the grouped losses within 1e-5; the EMA, the ramps
and an optimizer step within 1e-6 of each tensor's largest magnitude.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu import benchmarks as jbench  # noqa: E402
from detmatch_tpu.models.pvrcnn.pvrcnn import PVRCNN as JPVRCNN  # noqa: E402
from detmatch_tpu.ops import voxelize as jvox  # noqa: E402
from detmatch_tpu.ssl import detector as jdet  # noqa: E402
from detmatch_tpu.ssl import modules as jmodules  # noqa: E402
from detmatch_tpu.train import optim as joptim  # noqa: E402
from detmatch_tpu.utils import tiny as jtiny  # noqa: E402
from detmatch_tpu_torch.convert import from_jax_ssl  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.pvrcnn import PVRCNN  # noqa: E402
from detmatch_tpu_torch.ssl import detector, modules  # noqa: E402
from detmatch_tpu_torch.ssl.detector import (SSLConfig,  # noqa: E402
                                             SSLDetector)
from detmatch_tpu_torch.models.frcnn.faster_rcnn import (  # noqa: E402
    FasterRCNN)
from detmatch_tpu_torch.train import optim as poptim  # noqa: E402
from detmatch_tpu_torch.utils import synth_kitti, tiny  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = ref.detach().numpy() if isinstance(ref, torch.Tensor) else ref
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-12)


def boxset_2d(rng, b, k, n_valid, c=3):
    """Boxes in clusters of near-duplicates (so that the NMS suppresses)
    with distinct scores."""
    centers = rng.rand(b, k // 4, 2) * np.array([1000.0, 300.0])
    xy = (np.repeat(centers, 4, 1)[:, :k] + rng.randn(b, k, 2) * 6)
    wh = rng.rand(b, k, 2) * 60 + 30
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.rand(b, k, c).astype(np.float32)
    valid = np.arange(k)[None, :] < np.asarray(n_valid)[:, None]
    return dict(boxes=boxes, scores=scores, valid=valid)


def test_nms_2d_boxset_matches_jax():
    """Class-aware NMS over a projected BoxSet: the kept slots, their order
    and their full score rows exactly, an empty frame included."""
    rng = np.random.RandomState(0)
    bs = boxset_2d(rng, 3, 40, [40, 23, 0])
    cfg = SSLConfig().proj_nms_2d_cfg
    ours = modules.nms_2d_boxset({k: _t(v) for k, v in bs.items()}, *cfg)
    want = _np(jmodules.nms_2d_boxset(jax.tree.map(jnp.asarray, bs), *cfg))
    for k in ("valid", "boxes", "scores"):
        np.testing.assert_array_equal(ours[k].numpy(), want[k], err_msg=k)
    n = ours["valid"].sum(1).tolist()
    assert n[2] == 0 and 0 < n[0] < 40 * 3


def test_pseudo_gt_from_boxset_matches_jax():
    rng = np.random.RandomState(1)
    bs = dict(boxes=rng.randn(3, 30, 7).astype(np.float32),
              scores=rng.rand(3, 30, 3).astype(np.float32),
              valid=rng.rand(3, 30) > 0.3)
    bs["scores"][0, 4] = [0.5, 0.5, 0.05]  # a tied top class
    bs["valid"][2] = False
    for max_gt in (16, 64):
        ours = detector.pseudo_gt_from_boxset(
            {k: _t(v) for k, v in bs.items()}, 0.6, max_gt)
        want = jdet.pseudo_gt_from_boxset(jax.tree.map(jnp.asarray, bs), 0.6,
                                          max_gt)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
    assert (ours[..., 7] > 0).sum() > 0 and not ours[2].any()


def consistency_pairs(rng):
    """Slot-aligned student / teacher pairs: the teacher boxes are the
    student's plus a few pixels, the student scores are near the
    teacher's; some slots unmatched, one image without any pair."""
    b, k = 3, 12
    s = boxset_2d(rng, b, k, [9, 5, 0])
    t = dict(boxes=s["boxes"] + rng.randn(b, k, 4).astype(np.float32) * 4,
             scores=np.clip(s["scores"] + rng.randn(b, k, 3).astype(
                 np.float32) * 0.1, 0.02, 0.98), valid=s["valid"].copy())
    t["valid"][0, 7] = False
    return s, t


def test_hungarian_consistency_loss_matches_jax():
    rng = np.random.RandomState(2)
    s, t = consistency_pairs(rng)
    shape = np.array([[64.0, 128.0], [60.0, 110.0], [64.0, 128.0]],
                     np.float32)
    w = SSLConfig().consistency_weights

    def jloss(boxes, scores):
        out = jmodules.hungarian_consistency_loss(
            dict(s, boxes=boxes, scores=scores),
            jax.tree.map(jnp.asarray, t), jnp.asarray(shape), *w)
        return sum(out.values()), out

    (_, want), (jgb, jgs) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jnp.asarray(s["boxes"]), jnp.asarray(s["scores"]))
    boxes = _t(s["boxes"]).requires_grad_()
    scores = _t(s["scores"]).requires_grad_()
    ours = modules.hungarian_consistency_loss(
        dict(boxes=boxes, scores=scores, valid=_t(s["valid"])),
        {k: _t(v) for k, v in t.items()}, _t(shape), *w)
    for k, v in want.items():
        assert float(v) > 0, k
        assert rel(ours[k], v) <= 1e-5, k
    sum(ours.values()).backward()
    assert rel(boxes.grad, jgb) <= 1e-4
    assert rel(scores.grad, jgs) <= 1e-4
    assert not boxes.grad[2].any()  # the image without a pair


@pytest.fixture(scope="module")
def grouped_case():
    """A train forward of the tiny port PV-RCNN on B=3 frames with gts
    (its outputs are the inputs of both packages' ``loss_grouped``)."""
    torch.manual_seed(0)
    model = PVRCNN(**tiny.TINY_PV_CFG).train()
    rng = np.random.RandomState(3)
    view = tiny.tiny_view(rng, b=3, with_gt=True)
    vox = jax.vmap(lambda p, v: jvox.voxelize_mean(p, v, jtiny.TINY_SPEC))(
        jnp.asarray(view["points"]), jnp.asarray(view["points_valid"]))
    batch = dict(points=view["points"], points_valid=view["points_valid"],
                 gt_boxes=view["gt_boxes"],
                 voxel_features=np.asarray(vox["features"]),
                 voxel_keys=np.asarray(vox["keys"]))
    tb = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        out = model(tb, train=True, generator=torch.Generator())
    return model, out, batch, tb


def test_loss_grouped_matches_jax(grouped_case):
    """Two groups (samples 0 and 2 at weight 1, sample 1 at 0.7): every
    term and the weighted total; a group of all samples equals
    ``PVRCNN.loss``."""
    model, out, batch, tb = grouped_case
    mask = np.array([True, False, True])
    keys = ("head_preds", "keypoints", "kp_valid", "point_logits",
            "rcnn_cls", "rcnn_reg", "roi_targets")
    jout = jax.tree.map(lambda x: jnp.asarray(x.numpy()),
                        {k: out[k] for k in keys})
    jmodel = JPVRCNN(**jtiny.TINY_PV_CFG)
    want = _np(jax.jit(lambda o, b, m: jmodel.apply(
        {}, o, b, {"a": (m, 1.0), "b": (~m, 0.7)},
        method=JPVRCNN.loss_grouped))(
        jout, jax.tree.map(jnp.asarray, batch), jnp.asarray(mask)))
    ours = model.loss_grouped(out, tb, {"a": (_t(mask), 1.0),
                                        "b": (_t(~mask), 0.7)})
    assert set(ours) == set(want)
    for k, v in want.items():
        assert rel(ours[k], v) <= 1e-5, k
    whole = model.loss_grouped(out, tb, {"all": (torch.ones(3, dtype=bool),
                                                 1.0)})
    plain = model.loss(out, tb)
    for k, v in plain.items():
        key = "loss" if k == "loss" else f"all.{k}"
        assert rel(whole[key], v) <= 1e-6, k


@pytest.mark.parametrize("cfg", [
    dict(), dict(true_avg_rampup=False),
    dict(rampup_start_decay=0.9, ema_decay=0.99),
    dict(ssl_weight=2.0, ssl_weight_rampup_start_iter=10,
         ssl_weight_rampup_num_iter=100)])
def test_ramps_match_jax(cfg):
    ours_cfg, jcfg = SSLConfig(**cfg), jdet.SSLConfig(**cfg)
    for it in (0, 1, 5, 9, 10, 11, 60, 98, 99, 100, 110, 111, 5000):
        for ours, want in ((detector.ema_decay_at(it, ours_cfg),
                            jdet.ema_decay_at(jnp.int32(it), jcfg)),
                           (detector.ssl_weight_at(it, ours_cfg),
                            jdet.ssl_weight_at(jnp.int32(it), jcfg))):
            assert ours.dtype == torch.float32
            assert abs(float(ours) - float(want)) <= 1e-6 * max(
                abs(float(want)), 1e-6), (it, float(ours), float(want))


@pytest.fixture(scope="module")
def ssl_states():
    """Teacher and student variable trees of the tiny JAX models (random
    values of the shapes their ``init`` makes, the student a perturbed
    teacher) and the port's detector holding them."""
    rng = np.random.RandomState(4)
    view = jax.tree.map(jnp.asarray, tiny.tiny_view(rng, b=1))
    vox = jax.vmap(lambda p, v: jvox.voxelize_mean(p, v, jtiny.TINY_SPEC))(
        view["points"], view["points_valid"])
    batch = dict(points=view["points"], points_valid=view["points_valid"],
                 voxel_features=vox["features"], voxel_keys=vox["keys"])
    jssl, _ = jtiny.tiny_ssl()
    shapes = dict(
        det3d=jax.eval_shape(lambda b: jssl.pvrcnn.init(
            jax.random.PRNGKey(0), b, train=False), batch),
        det2d=jax.eval_shape(lambda i, s: jssl.frcnn.init(
            jax.random.PRNGKey(1), i, s), view["img"], view["img_shape"]))

    def make(path, x):
        if path[-1].key == "var":
            return (0.5 + rng.rand(*x.shape)).astype(np.float32)
        return (0.1 * rng.randn(*x.shape)).astype(np.float32)

    teacher = jax.tree_util.tree_map_with_path(make, shapes)
    student = jax.tree.map(
        lambda x: (x + rng.randn(*x.shape) * 0.1).astype(np.float32),
        teacher)
    state = dict(student=student, teacher=teacher)
    model = SSLDetector(PVRCNN(**jtiny.TINY_PV_CFG),
                        FasterRCNN(**jtiny.TINY_FR_CFG))
    model.load_state_dict(from_jax_ssl(state, jtiny.TINY_PV_CFG,
                                       jtiny.TINY_FR_CFG))
    return jssl, state, model


@pytest.mark.parametrize("use_student_bn", [False, True])
def test_ema_update_matches_jax(ssl_states, use_student_bn):
    """teacher * decay + student * (1 - decay) over parameters, BN
    statistics and frozen-BN constants (BN statistics copied from the
    student if asked); ``num_batches_tracked`` untouched."""
    _, state, model = ssl_states
    decay = jdet.ema_decay_at(jnp.int32(7), jdet.SSLConfig())
    # jitted: one program instead of one per leaf shape
    want = _np(jax.jit(jdet.ema_update, static_argnums=3)(
        jax.tree.map(jnp.asarray, state["teacher"]),
        jax.tree.map(jnp.asarray, state["student"]), decay, use_student_bn))
    want_sd = from_jax_ssl(dict(student=want, teacher=want),
                           jtiny.TINY_PV_CFG, jtiny.TINY_FR_CFG)
    teacher = SSLDetector(PVRCNN(**jtiny.TINY_PV_CFG),
                          FasterRCNN(**jtiny.TINY_FR_CFG)).teacher
    teacher.load_state_dict(model.teacher.state_dict())
    teacher["det3d"].backbone_3d.conv_input[1].num_batches_tracked.fill_(3)
    detector.ema_update(teacher, model.student,
                        detector.ema_decay_at(7, SSLConfig()),
                        use_student_bn)
    n = 0
    for k, v in teacher.state_dict().items():
        if v.is_floating_point():
            assert rel(v, want_sd["teacher." + k]) <= 1e-6, k
            n += 1
    assert n > 100
    assert int(teacher["det3d"].backbone_3d.conv_input[1]
               .num_batches_tracked) == 3


def _branch_case(seed):
    rng = np.random.RandomState(seed)
    params = {"a": rng.randn(30, 20).astype(np.float32),
              "b": rng.randn(20).astype(np.float32),
              "frozen": rng.randn(5, 5).astype(np.float32)}
    grads = []
    for scale in (3.0, 0.02, None, 1.0):  # clipped, not clipped, skipped
        g = {k: (rng.randn(*v.shape) * (scale or 1.0)).astype(np.float32)
             for k, v in params.items()}
        g["frozen"][:] = 0.0  # a parameter that gets no gradient
        if scale is None:
            g["a"][3, 4] = np.inf
        grads.append(g)
    return params, grads


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_branch_optimizer_matches_optax(kind):
    """Four steps of the port's branch optimizer against the JAX
    ``detmatch_branch_optimizers`` chain from the same parameters and
    gradients: clipped, unclipped, non-finite (skipped and counted: the
    parameters and the moments do not move), then one more; parameters
    within 1e-6 of each tensor's largest magnitude after every step."""
    params, grads = _branch_case(5)
    tx3d, tx2d = joptim.detmatch_branch_optimizers(0.3, 0.2, warmup_iters=3)
    tx = tx3d if kind == "adamw" else tx2d
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    lr = 0.3 if kind == "adamw" else 0.2
    opt = poptim.BranchOptimizer(tp.values(), kind,
                                 poptim.warmup_step_lr(lr, 3))
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = None if k == "frozen" else _t(g[k])
        opt.step()
        for k, p in tp.items():
            assert rel(p, jp[k]) <= 1e-6, k
    assert opt.skipped == int(state.skipped) == 1
    assert opt.count == 3
    assert not torch.equal(tp["frozen"].detach(), _t(params["frozen"]))


def test_views_with_gt_match_jax():
    """The labeled views array for array: ``ssl_view`` against the JAX
    benchmark's ``make_view`` and ``tiny_view`` / ``tiny_ssl_batch``
    against ``utils/tiny``."""
    canvas = (96, 320)
    ours = synth_kitti.ssl_view(np.random.RandomState(6), 2, 3000, canvas,
                                with_gt=True)
    want = jbench.make_view(np.random.RandomState(6), 2, 3000, canvas,
                            with_gt=True)
    ours_t = tiny.tiny_ssl_batch(np.random.RandomState(7), b=2)
    want_t = jtiny.tiny_ssl_batch(np.random.RandomState(7), b=2)
    pairs = [(ours, want)] + [(ours_t[s][v], want_t[s][v])
                              for s in ("lab", "unlab") for v in ("stu",
                                                                  "tea")]
    for o, w in pairs:
        assert set(o) == set(w)
        for k, v in o.items():
            if k in ("aug3d", "aug2d"):
                for f, a in v.items():
                    np.testing.assert_array_equal(
                        a, np.asarray(getattr(w[k], f)), err_msg=f)
            else:
                np.testing.assert_array_equal(v, np.asarray(w[k]),
                                              err_msg=k)
    assert ours["gt2d_valid"].sum() == 40 and "gt_boxes" in ours_t["lab"][
        "stu"]
