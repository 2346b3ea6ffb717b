"""The port's data-parallel noise study
(``detmatch_tpu_torch/tools/misc/dp_noise_study.py``, the counterpart of
``tools/misc/dp_noise_study.py``) on the CPU at its default setup: the
tiny PV-RCNN (``utils/tiny.TINY_PV_CFG``) on ``tiny_view(b=8, p=128,
with_gt=True)``, seed 0, its training loss and gradients in one process,
in two processes over gloo (``parallel``) and in one process in float64
on the plain paths.

What JAX's study states and its multi-device test holds
(``tests/test_multichip.py``), held here for two processes: every
integer and boolean output of the forward equal, every gradient leaf
within ``1e-3 + 1e-2 * max|leaf|``; and the ground truth computed in
float64 (every gradient leaf float64), within float32's own envelope of
g1 (1e-3 of each leaf's largest magnitude on this setup).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from detmatch_tpu_torch.models.pvrcnn import roi_head, vsa  # noqa: E402
from detmatch_tpu_torch.ops import pointnet  # noqa: E402
from detmatch_tpu_torch.ops.cuda import PLAIN  # noqa: E402
from detmatch_tpu_torch.tools.misc import dp_noise_study as dp  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

G64_TOL = 1e-3  # g1 against the float64 run, of each leaf's largest


@pytest.fixture(scope="module")
def study():
    return dp.study(None, frames=8, points=128, world=2, device="cpu",
                    log=lambda *a: None)


def test_discrete_outputs_equal_across_processes(study):
    eq = study["discrete_equal"]
    assert len(eq) >= 10 and all(eq.values()), eq
    for k in ("kp_valid", "roi_labels", "roi_targets.reg_valid_mask",
              "proposals.roi_valid"):
        assert k in eq


def test_gradients_within_jax_tolerance(study):
    assert study["gN_within_jax_tolerance"], study["gN_past_tolerance"]
    assert study["leaves"] > 100
    assert study["loss_gN"] == pytest.approx(study["loss_g1"], rel=1e-6)
    worst = study["worst_g1_gN"][0]
    assert worst["abs"] <= dp.ATOL + dp.RTOL * worst["mag"]


def test_ground_truth_in_float64(study):
    assert study["g64_float64"]
    assert np.isfinite(study["loss_g64"])
    assert study["loss_g64"] == pytest.approx(study["loss_g1"], rel=1e-5)
    assert all(study["discrete_equal_g64"].values())
    assert all(r["rel"] <= G64_TOL for r in study["worst_g1_g64"])


def test_float64_mode_is_undone():
    before = (torch.Tensor.float, pointnet.take_rows, vsa.pack_table,
              roi_head.pack_table)
    x = torch.zeros(2, dtype=torch.float64)
    with dp.float64_mode():
        assert x.float().dtype == torch.float64
        assert torch.zeros(2, dtype=torch.int32).float().dtype == \
            torch.float32
        assert vsa.pack_table(torch.zeros(1, 4, 3, dtype=torch.float64),
                              None, None) is None
    assert (torch.Tensor.float, pointnet.take_rows, vsa.pack_table,
            roi_head.pack_table) == before
    assert x.float().dtype == torch.float32


def test_float64_model_runs_the_plain_paths():
    det, spec, batch = dp.setup()
    model = dp.make_model(det, "cpu", torch.float64)
    assert model.ops == PLAIN
    assert all(p.dtype == torch.float64 for p in model.parameters())
    b = dp.device_batch(batch, spec, "cpu", torch.float64)
    assert b["voxel_features"].dtype == torch.float64
    assert not b["voxel_keys"].is_floating_point()


def test_main_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        dp.main([])
