"""CPU parity of one whole DetMatch SSL iteration of the port
(``detmatch_tpu_torch/train/ssl_step.py``: teacher phase, student 3D
step, student 2D step, EMA) against the JAX package's, on
``configs/tests/ssl_tiny.py`` with a loose fusion cost threshold (50) so
that both fusion matchings (the teacher's and the consistency branch's,
kernel K4's second call) pair boxes and the consistency loss is nonzero.

The JAX reference is jitted once in a module-scoped fixture; its random
draws (RoI picks, dropout masks, the 2D samplers' uniforms) are handed
to the port (``torch_port_ssl_fixture``). The port's teacher phase gets
JAX's 2D teacher stage output (random weights give near-equal scores to
overlapping proposals, and 1e-6 noise between the packages reorders such
ties at the 2D NMS; the stage itself is held to JAX in
``test_torch_port_ssl_teacher.py``); its student steps get JAX's
pseudo-labels.

Tolerances: losses 1e-4 of their value; gradients 1e-3 of each tensor's
largest magnitude (sums of hundreds of products in another order), or
twice the spread JAX shows against itself for the few that float32
leaves ill-conditioned (``ILL_CONDITIONED``);
batch-norm statistics 1e-4; the teacher after the EMA 1e-6 plus what the
first optimizer step can separate (``_step_bounds``); discrete
outputs (pseudo-label validity, matched pairs, the pairs' count)
exactly.
"""
import numpy as np
import pytest

import torch_port_ssl_fixture as fx
from torch_port_ssl_fixture import jax, one_torch_thread, rel, torch  # noqa: F401,E501

from detmatch_tpu.train import optim as joptim
from detmatch_tpu.ssl.detector import ema_update as j_ema_update
from detmatch_tpu.ssl.detector import ema_decay_at as j_ema_decay_at
from detmatch_tpu_torch.convert import from_jax_frcnn, from_jax_pvrcnn
from detmatch_tpu_torch.ssl.detector import ema_decay_at
from detmatch_tpu_torch.train import optim as poptim
from detmatch_tpu_torch.train.ssl_step import (ema_step, student_2d_step,
                                               student_3d_step, teacher_step)

LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
# Gradients that float32 cannot pin down to 1e-3 on this step, by
# parameter-name prefix: JAX itself, run op by op instead of jitted on this
# same step, moves them by up to the spread given (measured once; every
# other gradient moves by less than 1e-4). They are held to twice it.
# 3D: the second RoI-grid-pool branch (radius 1.6, 16 samples over the
# config's 32 keypoints) and the VSA fusion layer, behind train-mode batch
# norms over few, repeated samples. 2D: sums of many terms of either sign
# that nearly cancel — the RPN conv's (over every anchor position) and,
# downstream of it, the ResNet's and the FPN's.
ILL_CONDITIONED = {
    "roi_head.roi_grid_pool_layer.mlps.1.": 5.4e-3,
    "pfe.vsa_point_feature_fusion.": 9.5e-4,
    "rpn_head.": 2.2e-2,
    "backbone.": 1.5e-3,
    "neck.": 1.0e-3,
}


def grad_tol(name):
    for prefix, spread in ILL_CONDITIONED.items():
        if name.startswith(prefix):
            return max(GRAD_TOL, 2 * spread)
    return GRAD_TOL
STAT_RTOL = 1e-4
EMA_RTOL = 1e-6
LR_3D, LR_2D, WARMUP = 0.01, 0.02, 5
IT = 0
R3, R2 = jax.random.PRNGKey(3), jax.random.PRNGKey(2)


@pytest.fixture(scope="module")
def ref():
    """The JAX iteration: teacher phase, the two branch steps (losses,
    gradients, updated variables, optimizer states) and the EMA."""
    cfg = fx.load_cfg(cost_thr=50.0)
    batch = fx.views(0)
    vb = jax_batch(cfg, batch)
    jssl = fx.jax_ssl(cfg)
    state = fx.make_state(jssl, vb)
    jst = fx._j(state)
    pseudo, j2d = jax.jit(teacher_phase(jssl))(jst["teacher"], vb)

    tx3d, tx2d = joptim.detmatch_branch_optimizers(LR_3D, LR_2D,
                                                   warmup_iters=WARMUP)
    masks = fx.DropoutMasks()
    captured = {}

    def step3d(v, opt, vbatch, pl, rng):
        def loss(p):
            total, aux = jssl.student_losses_3d_concat(
                dict(v, params=p), vbatch, pl, IT, rng)
            return total, (aux, captured["key"], list(masks.traced))
        (total, (aux, key, drawn)), grads = jax.value_and_grad(
            loss, has_aux=True)(v["params"])
        upd, new_opt = tx3d.update(grads, opt, v["params"])
        import optax
        return (total, aux, key, drawn, grads,
                optax.apply_updates(v["params"], upd), new_opt)

    def step2d(v, opt, vbatch, pl, rng):
        (total, aux), grads = jax.value_and_grad(
            lambda p: jssl.student_losses_2d(dict(v, params=p), vbatch, pl,
                                             IT, rng),
            has_aux=True)(v["params"])
        upd, new_opt = tx2d.update(grads, opt, v["params"])
        import optax
        return total, aux, grads, optax.apply_updates(v["params"], upd), \
            new_opt

    s3, s2 = jst["student"]["det3d"], jst["student"]["det2d"]
    with pytest.MonkeyPatch.context() as mp:
        fx.capture_sampling_key(mp, captured)
        rec = masks.recording()
        try:
            out3 = jax.jit(step3d)(s3, tx3d.init(s3["params"]), vb, pseudo,
                                   R3)
        finally:
            rec.undo()
    total3, aux3, key, drawn, g3, p3, _ = out3
    masks.masks = [np.asarray(m) for m in drawn]
    total2, aux2, g2, p2, _ = jax.jit(step2d)(
        s2, tx2d.init(s2["params"]), vb, pseudo, R2)
    new_student = dict(det3d=dict(s3, params=p3,
                                  batch_stats=aux3["batch_stats"]["det3d"]),
                       det2d=dict(s2, params=p2))
    # jitted: one program instead of one per leaf shape
    teacher = jax.jit(j_ema_update, static_argnums=3)(
        jst["teacher"], new_student, j_ema_decay_at(IT, jssl.cfg),
        jssl.cfg.use_student_bn_stats_for_teacher)
    return dict(cfg=cfg, batch=batch, state=state, j2d=fx._np(j2d),
                pseudo=pseudo, masks=masks, key=key,
                total3=float(total3), logs3=fx._np(aux3["logs"]),
                stats3=fx._np(aux3["batch_stats"]["det3d"]),
                g3=fx._np(g3), total2=float(total2),
                logs2=fx._np(aux2["logs"]), g2=fx._np(g2),
                g2_sd=from_jax_frcnn(fx._np(g2), jax.tree.map(
                    np.zeros_like, state["student"]["det2d"]["frozen"]),
                    cfg["model"]["detector_2d"]),
                teacher=fx._np(teacher))


def teacher_phase(jssl):
    """JAX's ``teacher_pseudo_labels`` that also returns the output of its
    2D teacher stage (``_det2d_teacher_boxes``), which the port is
    handed: one trace for both."""
    def run(variables, vbatch):
        stage = []
        own = jssl._det2d_teacher_boxes

        def spy(*args):
            stage.append(own(*args))
            return stage[-1]

        jssl._det2d_teacher_boxes = spy
        try:
            pseudo = jssl.teacher_pseudo_labels(variables, vbatch)
        finally:
            del jssl._det2d_teacher_boxes
        (boxes,) = stage
        return pseudo, boxes
    return run


def jax_batch(cfg, batch):
    return fx.j_voxelize_views(fx.jax_views(batch), fx.jax_spec(cfg))


@pytest.fixture(scope="module")
def port(ref):
    """The port's iteration through its four step functions, with JAX's
    random draws handed over."""
    cfg = ref["cfg"]
    model = fx.port_ssl(cfg, ref["state"])
    batch = fx.port_views(cfg, ref["batch"])
    j2d = fx.to_torch(ref["j2d"])
    model._det2d_teacher_boxes = lambda view, nms_cfg: j2d
    model.train()
    out = dict(model=model, pseudo=teacher_step(model, batch))
    del model._det2d_teacher_boxes
    pseudo = fx.pseudo_to_torch(ref["pseudo"])
    opt3d, opt2d = poptim.detmatch_branch_optimizers(model, LR_3D, LR_2D,
                                                     WARMUP)
    gen = torch.Generator()
    with pytest.MonkeyPatch.context() as mp, fx.port_threads():
        mp.setattr(fx.proi, "_pick", fx.roi_picks(ref["key"], 2 * fx.B))
        ref["masks"].replay(mp)
        out["logs3"] = student_3d_step(model, opt3d, batch, pseudo, IT, gen)
        out["g3"] = {n: p.grad.clone() if p.grad is not None
                     else torch.zeros_like(p)
                     for n, p in model.student["det3d"].named_parameters()}
        fx.hand_over_frcnn(mp, R2)
        out["logs2"] = student_2d_step(model, opt2d, batch, pseudo, IT, gen)
        out["g2"] = {n: p.grad.clone() if p.grad is not None
                     else torch.zeros_like(p)
                     for n, p in model.student["det2d"].named_parameters()}
    ema_step(model, IT)
    return out


def test_teacher_phase_matches_jax(ref, port):
    ours, want = port["pseudo"], fx._np(ref["pseudo"])
    for k in ("m3d_stu", "m2d_stu", "m2d_clean"):
        np.testing.assert_array_equal(ours[k]["valid"].numpy(),
                                      want[k]["valid"], err_msg=k)
        for f in ("boxes", "scores"):
            assert rel(ours[k][f], want[k][f]) <= LOSS_RTOL, (k, f)
    assert int(ours["m3d_stu"]["valid"].sum()) > 0


def _check_logs(ours, want, total_ours, total_want):
    keys = set(want) - {"loss"}
    assert keys <= set(ours), keys - set(ours)
    for k in keys:
        assert rel(ours[k], want[k]) <= LOSS_RTOL, (k, float(ours[k]),
                                                    float(want[k]))
    assert rel(total_ours, total_want) <= LOSS_RTOL


def test_student_3d_losses_match_jax(ref, port):
    """Every grouped loss term, the consistency terms (nonzero: the
    second matching pairs boxes) and the matched-pair count."""
    logs = port["logs3"]
    _check_logs(logs, ref["logs3"], logs["loss"], ref["total3"])
    n = float(logs["metrics.num_2D_to_3D_hung"])
    assert n == float(ref["logs3"]["metrics.num_2D_to_3D_hung"]) and n > 0
    for k in ("cls_loss", "l1_loss", "iou_loss"):
        assert float(logs[f"ssl.unlab.2D_to_3D_hung.{k}"]) > 0, k


def test_student_3d_gradients_match_jax(ref, port):
    zero = jax.tree.map(np.zeros_like, ref["state"]["student"]["det3d"][
        "batch_stats"])
    want = from_jax_pvrcnn(ref["g3"], zero, ref["cfg"]["model"]["detector_3d"])
    got = port["g3"]
    assert set(got) <= set(want)
    for name, g in got.items():
        assert rel(g, want[name]) <= grad_tol(name), name
    for name in ("backbone_3d.conv_input.0.weight",
                 "roi_head.reg_layers.7.weight"):
        assert got[name].any(), name


def test_student_3d_running_stats_match_jax(ref, port):
    cfg3 = ref["cfg"]["model"]["detector_3d"]
    want = from_jax_pvrcnn(ref["state"]["student"]["det3d"]["params"],
                           ref["stats3"], cfg3)
    sd = port["model"].student["det3d"].state_dict()
    n = 0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            assert rel(sd[k], v) <= STAT_RTOL, k
            n += 1
    assert n > 0


def test_student_2d_losses_match_jax(ref, port):
    logs = port["logs2"]
    _check_logs(logs, ref["logs2"], logs["loss"], ref["total2"])


def test_student_2d_gradients_match_jax(ref, port):
    """Every Faster R-CNN parameter's gradient; the frozen stem and first
    stage get none (zero), as in JAX."""
    cfg2 = ref["cfg"]["model"]["detector_2d"]
    frozen = jax.tree.map(np.zeros_like,
                          ref["state"]["student"]["det2d"]["frozen"])
    want = from_jax_frcnn(ref["g2"], frozen, cfg2)
    got = port["g2"]
    for name, g in got.items():
        assert rel(g, want[name]) <= grad_tol(name), name
    assert not got["backbone.layer1.0.conv1.weight"].any()
    assert got["backbone.layer2.0.conv1.weight"].any()


def _step_bounds(ref):
    """Per branch, the most one first optimizer step can move a parameter
    apart between the packages, given gradients that agree within the
    tolerances above: Adam's first update is lr * g / (|g| + eps), within
    lr of zero whatever g is, so a gradient near zero that the packages'
    rounding puts on opposite sides moves it by up to 2 lr; SGD's is
    lr * (g + wd * p), which moves by lr times the gradient difference."""
    lr3 = float(poptim.warmup_step_lr(LR_3D, WARMUP)(0))
    lr2 = float(poptim.warmup_step_lr(LR_2D, WARMUP)(0))
    return {"det3d": lambda name: 2 * lr3,
            "det2d": lambda name: lr2 * grad_tol(name) * float(
                np.abs(ref["g2_sd"][name]).max())}


def test_teacher_after_ema_matches_jax(ref, port):
    """The teacher after the EMA of the updated student: exactly the
    formula teacher * d + student * (1 - d) on the port's own tensors, and
    JAX's teacher within 1e-6 of each tensor's largest magnitude plus
    (1 - d) times what separates the students: the most the optimizer
    step can (``_step_bounds``), and for batch-norm statistics their own
    tolerance."""
    m = ref["cfg"]["model"]
    want = fx.from_jax_ssl(dict(student=ref["teacher"],
                                teacher=ref["teacher"]),
                           m["detector_3d"], m["detector_2d"])
    start = fx.from_jax_ssl(ref["state"], m["detector_3d"], m["detector_2d"])
    model = port["model"]
    d = float(ema_decay_at(IT, model.cfg))
    sd, s_sd = model.state_dict(), model.student.state_dict()
    bounds = _step_bounds(ref)
    n = 0
    for k, v in want.items():
        if not (k.startswith("teacher.") and v.is_floating_point()):
            continue
        key = k[len("teacher."):]
        formula = start[k] * torch.tensor(d) + s_sd[key] * (
            1.0 - torch.tensor(d))
        assert rel(sd[k], formula) <= 1e-7, k
        half, name = key.split(".", 1)
        slack = 0.0
        if name in dict(model.student[half].named_parameters()):
            slack = (1.0 - d) * bounds[half](name)
        elif name.endswith(("running_mean", "running_var")):
            slack = (1.0 - d) * STAT_RTOL * float(s_sd[key].abs().max())
        err = float((sd[k] - v).abs().max())
        assert err <= EMA_RTOL * float(v.abs().max()) + slack, (k, err,
                                                                slack)
        n += 1
    assert n > 100
