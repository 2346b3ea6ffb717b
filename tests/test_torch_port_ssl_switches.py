"""The port's SSL iteration under every ConfThr switch setting
(``enable_3d``, ``enable_2d``, ``fusion``, ``consistency``) against the
JAX package's branch losses (``train_ssl`` end to end on the CPU is
``test_torch_port_train_ssl.py``). Two of the four settings run here,
the other two in ``test_torch_port_ssl_switches_fusion.py``, which
imports this module's set-up: the files run on separate workers.

Each setting runs the port's step functions (``train/ssl_step.py``) on
``configs/tests/ssl_tiny.py``: the teacher phase, then the branches the
setting enables, then the EMA. Its pseudo-labels, and JAX's random draws
(``torch_port_ssl_fixture``), go into JAX's ``student_losses_3d_concat``
and ``student_losses_2d`` for the same branches; every logged loss term
agrees within 1e-4 of its value, and a disabled branch neither runs nor
moves its parameters. The PV-RCNN's RoI head is the narrower one of the
checkpoint, CLI and loop-switch tests (``MICRO_ROI``: the default one's
grid pooling costs ~30 s a student step on one CPU thread); the
gradients of the whole iteration, at the default RoI head, are held to
JAX in ``test_torch_port_ssl_step.py``.
"""
import numpy as np
import pytest

import torch_port_ssl_fixture as fx
from torch_port_ssl_fixture import jax, one_torch_thread, rel, torch  # noqa: F401,E501

from detmatch_tpu_torch.train import optim as poptim
from test_torch_port_checkpoints import MICRO_ROI
from detmatch_tpu_torch.train.ssl_step import (ema_step, student_2d_step,
                                               student_3d_step, teacher_step)

LOSS_RTOL = 1e-4
IT = 3
R3, R2 = jax.random.PRNGKey(13), jax.random.PRNGKey(12)
SWITCHES = {
    "no_consistency": dict(consistency=False),
    "confthr_no_fusion": dict(fusion=False),
    "confthr_3d_only": dict(fusion=False, enable_2d=False),
    "confthr_2d_only": dict(fusion=False, enable_3d=False),
}


def switch_cfg(**ssl_overrides):
    cfg = fx.load_cfg(**ssl_overrides)
    cfg["model"]["detector_3d"]["roi_head_cfg"] = MICRO_ROI
    return cfg


@pytest.fixture(scope="module")
def setup():
    """Weights and batch (shared by every setting), and the JAX branch
    losses jitted once per (consistency, pseudo-label shape)."""
    cfg = switch_cfg()
    batch = fx.views(1)
    vb = fx.j_voxelize_views(fx.jax_views(batch), fx.jax_spec(cfg))
    jssl = fx.jax_ssl(switch_cfg(consistency=False))
    state = fx.make_state(jssl, vb)
    masks = fx.DropoutMasks()
    captured = {}

    # each loss takes only the pseudo-labels it reads (without the
    # consistency branch: m3d_stu; the 2D branch: m2d_stu), so the
    # settings' other keys do not retrace it
    def loss3d(v, vbatch, m3d_stu):
        total, aux = jssl.student_losses_3d_concat(
            v, vbatch, dict(m3d_stu=m3d_stu), IT, R3)
        return total, aux["logs"], captured["key"], list(masks.traced)

    def loss2d(v, vbatch, m2d_stu):
        total, aux = jssl.student_losses_2d(v, vbatch,
                                            dict(m2d_stu=m2d_stu), IT, R2)
        return total, aux["logs"]

    return dict(cfg=cfg, batch=batch, vb=vb, state=state, masks=masks,
                captured=captured, loss3d=jax.jit(loss3d),
                loss2d=jax.jit(loss2d))


def jax_losses_3d(setup, pseudo):
    s = setup
    with pytest.MonkeyPatch.context() as mp:
        fx.capture_sampling_key(mp, s["captured"])
        s["masks"].traced.clear()
        rec = s["masks"].recording()
        try:
            total, logs, key, drawn = s["loss3d"](
                fx._j(s["state"]["student"]["det3d"]), s["vb"],
                pseudo["m3d_stu"])
        finally:
            rec.undo()
    s["masks"].masks = [np.asarray(m) for m in drawn]
    return float(total), fx._np(logs), key


@pytest.mark.parametrize("name", ["confthr_3d_only", "no_consistency"])
def test_iteration_under_switches(setup, name):
    run_switch(setup, name)


def run_switch(setup, name):
    """One iteration under the setting ``name`` against JAX's losses."""
    sw = SWITCHES[name]
    cfg = switch_cfg(**sw)
    model = fx.port_ssl(cfg, setup["state"])
    batch = fx.port_views(cfg, setup["batch"])
    model.train()
    pseudo = teacher_step(model, batch)
    on3d, on2d = cfg["ssl"].get("enable_3d", True), cfg["ssl"].get(
        "enable_2d", True)
    assert ("m3d_stu" in pseudo) == on3d and ("m2d_stu" in pseudo) == on2d
    jpseudo = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()),
                           {k: v for k, v in pseudo.items() if k != "logs"})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt3d, opt2d = poptim.detmatch_branch_optimizers(model, 0.01, 0.02, 5)
    gen = torch.Generator()
    with pytest.MonkeyPatch.context() as mp:
        if on3d:
            total, want, key = jax_losses_3d(setup, jpseudo)
            mp.setattr(fx.proi, "_pick", fx.roi_picks(key, 2 * fx.B))
            setup["masks"].replay(mp)
            logs = student_3d_step(model, opt3d, batch, pseudo, IT, gen)
            assert not any("2D_to_3D" in k for k in logs)
            for k, v in want.items():
                assert rel(logs[k], v) <= LOSS_RTOL, (k, float(logs[k]),
                                                      float(v))
            assert rel(logs["loss"], total) <= LOSS_RTOL
        if on2d:
            total, want = setup["loss2d"](
                fx._j(setup["state"]["student"]["det2d"]), setup["vb"],
                jpseudo["m2d_stu"])
            fx.hand_over_frcnn(mp, R2)
            logs = student_2d_step(model, opt2d, batch, pseudo, IT, gen)
            for k, v in fx._np(want).items():
                assert rel(logs[k], v) <= LOSS_RTOL, (k, float(logs[k]),
                                                      float(v))
            assert rel(logs["loss"], float(total)) <= LOSS_RTOL
    ema_step(model, IT)
    for half, on in (("det3d", on3d), ("det2d", on2d)):
        moved = any(not torch.equal(p, before[f"student.{half}.{n}"])
                    for n, p in model.student[half].named_parameters())
        assert moved == on, half
