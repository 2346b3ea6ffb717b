"""CPU parity of one whole DetMatch SSL iteration of the port against
JAX's where the teacher gives no pseudo-label: ``configs/tests/
ssl_tiny.py`` at its own fusion cost threshold (-1.5, the learning
study's and ``split_0.py``'s), under which the random-weight teacher's
boxes match nothing. That is the regime the learning study trains in
throughout (``tools/port_probes/finite_probe.py`` on the card: the
teacher's 3D class scores never reach the 0.1 filter): the unlabeled
half of the student's concatenated batch has no ground truth, so every
anchor, keypoint and RoI of it is background, and the consistency loss
pairs nothing.

The iteration and the hand-over of JAX's random draws are
``test_torch_port_ssl_step.py``'s (its fixtures ``ref`` and ``port``),
with its tolerances: every 3D and 2D loss term within 1e-4, every
student PV-RCNN gradient within 1e-3 of its tensor's largest magnitude
(twice JAX's own spread for the ill-conditioned ones), the batch-norm
statistics within 1e-4; the pseudo-labels and the consistency branch's
pairs empty in both packages.
"""
import numpy as np
import pytest

import torch_port_ssl_fixture as fx
from torch_port_ssl_fixture import one_torch_thread, rel  # noqa: F401
# the iteration's fixtures themselves, instantiated afresh for this module
from test_torch_port_ssl_step import (LOSS_RTOL, STAT_RTOL,  # noqa: F401
                                      _check_logs, grad_tol, jax, port, ref)

from detmatch_tpu_torch.convert import from_jax_pvrcnn  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def own_cost_threshold():
    """``ref`` asks ``fx.load_cfg`` for the loose threshold 50; here the
    config keeps its own (-1.5). Autouse, so it is in place before
    ``ref`` builds its config."""
    load_cfg = fx.load_cfg

    def own(**overrides):
        overrides.pop("cost_thr", None)
        return load_cfg(**overrides)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fx, "load_cfg", own)
        yield


def test_pseudo_labels_are_empty_in_both(ref, port):
    want = fx._np(ref["pseudo"])
    for k in ("m3d_stu", "m2d_stu", "m2d_clean"):
        np.testing.assert_array_equal(port["pseudo"][k]["valid"].numpy(),
                                      want[k]["valid"], err_msg=k)
    assert not port["pseudo"]["m3d_stu"]["valid"].any()
    for logs in (port["logs3"], fx._np(ref["logs3"])):
        assert float(logs["metrics.num_2D_to_3D_hung"]) == 0


@pytest.mark.parametrize("branch", ["3", "2"])
def test_losses_match_jax(ref, port, branch):
    """Every loss term; the unlabeled group's box terms are zero (no
    foreground) and its classification terms are not."""
    logs = port[f"logs{branch}"]
    _check_logs(logs, ref[f"logs{branch}"], logs["loss"],
                ref[f"total{branch}"])
    if branch == "3":
        pre = "ssl.unlab.hard_pseudo_3d."
        assert float(logs[pre + "rpn_loss_loc"]) == 0
        assert float(logs[pre + "rpn_loss_cls"]) > 0
        assert rel(logs[pre + "rpn_loss_cls"],
                   ref["logs3"][pre + "rpn_loss_cls"]) <= LOSS_RTOL


def test_student_3d_gradients_and_stats_match_jax(ref, port):
    cfg3 = ref["cfg"]["model"]["detector_3d"]
    zero = jax.tree.map(np.zeros_like, ref["state"]["student"]["det3d"][
        "batch_stats"])
    want = from_jax_pvrcnn(ref["g3"], zero, cfg3)
    got = port["g3"]
    assert set(got) <= set(want)
    for name, g in got.items():
        assert rel(g, want[name]) <= grad_tol(name), name
    assert got["backbone_3d.conv_input.0.weight"].any()
    stats = from_jax_pvrcnn(ref["state"]["student"]["det3d"]["params"],
                            ref["stats3"], cfg3)
    sd = port["model"].student["det3d"].state_dict()
    for k, v in stats.items():
        if k.endswith(("running_mean", "running_var")):
            assert rel(sd[k], v) <= STAT_RTOL, k
