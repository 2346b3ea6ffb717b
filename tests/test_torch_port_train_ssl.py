"""``train_ssl_batches`` (``train_ssl``'s loop on collated batches) end
to end on the CPU, on ``configs/tests/ssl_tiny.py`` with the narrower
RoI head of the checkpoint and CLI tests (``MICRO_ROI``: the default
one's grid pooling costs ~30 s an iteration on one CPU thread; it is
held to JAX in ``test_torch_port_ssl_step.py``) (the ConfThr switch
settings against JAX are ``test_torch_port_ssl_switches.py``; the two
files run on two workers).
"""
import json

import numpy as np
import pytest

import torch_port_ssl_fixture as fx
from torch_port_ssl_fixture import one_torch_thread, torch  # noqa: F401

from detmatch_tpu_torch.apis.build import build_ssl, build_voxelizer
from detmatch_tpu_torch.apis.train_ssl import train_ssl_batches
from test_torch_port_checkpoints import MICRO_ROI


def test_train_ssl_runs_on_cpu(tmp_path):
    """Two iterations of ``train_ssl_batches`` on the tiny config: the log has
    the JAX loop's keys, every value is finite, and the student and the
    teacher both move."""
    cfg = fx.load_cfg(cost_thr=50.0)
    cfg["model"]["detector_3d"]["roi_head_cfg"] = MICRO_ROI
    model = build_ssl(cfg, device="cpu")
    rng = np.random.RandomState(2)

    def batches():
        while True:
            yield fx.tiny.tiny_ssl_batch(rng, b=fx.B)

    before = {k: v.clone() for k, v in model.state_dict().items()}
    model, opts, hist = train_ssl_batches(
        model, build_voxelizer(cfg), batches(), str(tmp_path), 2,
        batch_size=fx.B, log_interval=1, warmup_iters=2)
    lines = [json.loads(x) for x in (tmp_path / "log.json").read_text()
             .splitlines()]
    assert len(lines) == len(hist) == 2
    keys = set(lines[-1])
    for k in ("sup.3d.rpn_loss_cls", "sup.3d.rcnn_loss_reg",
              "ssl.unlab.hard_pseudo_3d.point_loss_cls",
              "ssl.unlab.2D_to_3D_hung.l1_loss", "sup.2d.loss_cls",
              "ssl.unlab.hard_pseudo_2d.loss_rpn_cls",
              "metrics.num_2D_to_3D_hung", "metrics.num_tea_hung",
              "metrics.dropped_voxels", "ssl.weight", "ssl.ema_decay",
              "grad_skips", "loss", "iter", "mode", "time"):
        assert k in keys, k
    assert all(np.isfinite(v) for h in hist for v in h.values())
    assert lines[0]["ssl.ema_decay"] == pytest.approx(0.99)
    sd = model.state_dict()
    for half in ("student", "teacher"):
        assert any(not torch.equal(sd[k], before[k]) for k in sd
                   if k.startswith(half) and sd[k].is_floating_point()), half
    assert opts[0].count == 2 and opts[1].count == 2
    assert model.student.training and not model.teacher.training
