"""Data-parallel training through the port's loops and CLI on the CPU.

* ``chip_smoke.dist_phases``'s comparison at a tiny size: two SSL
  iterations (teacher -> both students -> EMA) through
  ``train_ssl_batches``, 2 gloo processes x (1 + 1) frames against the
  port's one process at (2 + 2) on the same global batches (the
  one-process iteration is held to JAX by
  ``test_torch_port_ssl_step.py``). The teacher's pseudo-labels (its 2D
  boxes made to pair with its 3D ones, the clean 2D set from the
  student's own boxes) and the student's proposals are pinned to the
  one-process run's (float32 noise between batch sizes may reorder NMS
  ties), and process 1 starts from other weights, which
  ``broadcast_state`` replaces by process 0's. Both take every batch
  norm's statistics by the two-pass formula of a process group
  (``chip_smoke.several_process_bn``), and each iteration of the two
  processes starts from the one process's state (model and optimizers),
  so that float32 noise does not compound through AdamW's sign-like
  first steps. The gates are the card phase's
  (``chip_smoke.DIST_GATES``): every logged value within 1e-4
  (relative), every gradient and AdamW first moment within 3e-2 of its
  norm (L2); over each iteration, the move of the students' parameters
  and of the EMA teacher within 0.1 of the one process's move (L2, per
  tensor, past one float32 spacing an entry; the PV-RCNN's weights
  where the first moment's sign is settled, ``chip_smoke.adam_sure``),
  the running statistics' move within 1e-4, the counters exactly; both
  processes' states equal bit for bit, each process's own teacher phase
  equal to the pinned pseudo-labels of its rows, and ``log.json`` from
  process 0 alone. Here the gradients and moments also stay within 1e-3
  of each tensor's largest entry (``GRAD_TOL``);
  ``tools/port_probes/dist_faults.py`` shows the gates
  fail on planted faults, at this size and on the card at full width,
  where float32's order of sums takes them to 1.4e-2.
* ``python -m detmatch_tpu_torch.tools.dist_train --nproc 2 -- <tiny
  config> --device cpu``: trains, one ``log.json`` and process 0's
  checkpoints; a zoo detector is refused.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from detmatch_tpu_torch.config import Config  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn.roi_head import (  # noqa: E402
    default_target_cfg)
import chip_smoke  # noqa: E402
from kitti_fixture import make_kitti_random  # noqa: E402
from torch_port_dist_fixture import run_workers  # noqa: E402

TINY = os.path.join(ROOT, "configs", "tests", "ssl_tiny.py")
# the RoI head narrowed as test_torch_port_checkpoints.py narrows it;
# its dropout (0.3) stays on
MICRO_ROI = dict(grid_size=2, pool_nsamples=(4, 4),
                 pool_mlps=((8, 8), (8, 8)), shared_fc=(32, 32),
                 cls_fc=(32, 32), reg_fc=(32, 32),
                 target_cfg=dict(default_target_cfg(), roi_per_image=16))
B = 2            # global frames a split


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def micro_cfg():
    cfg = Config.fromfile(TINY)
    cfg["model"]["detector_3d"]["roi_head_cfg"] = MICRO_ROI
    cfg["model"]["detector_2d"]["backbone_cfg"] = dict(
        stage_blocks=(1, 1, 1, 1))
    return cfg


def use_cpu(mp):
    """``chip_smoke``'s data-parallel phase at this file's size: the CPU,
    B + B global frames."""
    mp.setattr(chip_smoke, "DEVICE", "cpu")
    mp.setattr(chip_smoke, "SSL_B", B)


DIST_WORKER = """
import chip_smoke
from pathlib import Path
import test_torch_port_distributed_train as T
mp = T.pytest.MonkeyPatch()
T.use_cpu(mp)
chip_smoke.dist_rank(T.micro_cfg(), Path(out))
save(None)
"""


@pytest.fixture(scope="module")
def dist(tmp_path_factory):
    """``chip_smoke.dist_phases``'s comparison: one process records the
    pins and its results, two processes replay them on their rows."""
    tmp = tmp_path_factory.mktemp("ssl_dp")
    cfg = micro_cfg()
    with pytest.MonkeyPatch.context() as mp:
        use_cpu(mp)
        ref, pins, _ = chip_smoke.dist_reference(cfg, tmp, "cpu")
    run_workers(tmp, DIST_WORKER, timeout=240)
    outs = [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(2)]
    return ref, pins, outs, tmp


def test_ssl_iterations_run_every_branch(dist):
    ref, pins, _, _ = dist
    assert len(ref["hist"]) == chip_smoke.DIST_ITERS == len(pins)
    for logs, pin in zip(ref["hist"], pins):
        assert int(pin["pseudo"]["m3d_stu"]["valid"].sum()) > 0
        assert logs["metrics.num_tea_hung"] > 0
        assert logs["metrics.num_2D_to_3D_hung"] > 0
        assert logs["ssl.unlab.hard_pseudo_2d.loss_cls"] > 0
    assert any(n.startswith("det3d.") for n in ref["grads"][-1])
    assert any(n.startswith("det2d.") for n in ref["grads"][-1])


@pytest.mark.parametrize("kind", ["logs", "grads", "moments",
                                  "running stats", "parameters",
                                  "EMA teacher", "counters"])
def test_ssl_iterations_match_one_process(dist, kind):
    """Each process's worst difference against one process, under the
    card phase's gates (``chip_smoke.DIST_GATES``)."""
    for out in dist[2]:
        err, gate, where, n, top, _, last = chip_smoke.dist_verdict(
            out["rows"])[kind]
        assert err <= gate and n == 0, (out["rank"], kind, top)
        if kind in ("grads", "moments"):
            # at this size float32's order of sums stays inside the
            # kernel comparisons' gate too: GRAD_TOL of each tensor's
            # largest entry
            assert last[0] <= chip_smoke.GRAD_TOL, (out["rank"], kind, last)


def test_ssl_processes_agree_bit_for_bit_and_log_once(dist):
    """The processes' states are equal bit for bit (process 1 began from
    other weights), each process's own teacher phase gives the pinned
    pseudo-labels of its rows, and process 0 alone writes log.json."""
    ref, _, outs, tmp = dist
    for out in outs:
        assert out["bit_equal"]
        assert out["own_share"] == 1.0 and out["own_total"] > 0
        assert out["reduce"]["det3d"]["bytes"] > 0
    lines = [json.loads(x) for x in open(tmp / "run" / "log.json")]
    assert [x["iter"] for x in lines] == [1, 2]
    assert lines[-1]["loss"] == pytest.approx(ref["hist"][-1]["loss"],
                                              rel=1e-4)


# ------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from detmatch_tpu_torch.data import kitti
    root = str(tmp_path_factory.mktemp("kitti_dp"))
    infos = kitti.create_infos(root, make_kitti_random(root, 4, seed=4))
    with open(os.path.join(root, "kitti_infos_train.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return root


def dist_train(tmp, args, nproc=2, timeout=240):
    cmd = [sys.executable, "-m", "detmatch_tpu_torch.tools.dist_train",
           "--nproc", str(nproc), "--coordinator",
           f"file://{tmp}/store", "--"] + args + ["--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=timeout)


def test_dist_train_cli_trains_with_two_processes(tree, tmp_path):
    info = os.path.join(tree, "kitti_infos_train.pkl")
    work = tmp_path / "work"
    opts = [f"data.train_{s}.dataset.{k}={v}" for s in ("lab", "unlab")
            for k, v in (("data_root", tree), ("ann_file", info))]
    opts += [f"data.val.data_root={tree}", f"data.val.ann_file={info}",
             f"model.detector_3d.roi_head_cfg={MICRO_ROI!r}",
             "model.detector_2d.backbone_cfg={'stage_blocks': (1, 1, 1, 1)}",
             "log_interval=1", "ckpt_interval=2", "evaluation=None"]
    res = dist_train(tmp_path, [TINY, "--work-dir", str(work),
                                "--max-iters", "2", "--cfg-options"] + opts)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [json.loads(x) for x in open(work / "log.json")]
    assert [x["iter"] for x in lines] == [1, 2]
    assert all(np.isfinite(x["loss"]) for x in lines)
    assert sorted(os.listdir(work / "ckpt")) == ["ckpt_2"]


def test_dist_train_refuses_a_zoo_detector(tree, tmp_path):
    info = os.path.join(tree, "kitti_infos_train.pkl")
    train = repr(dict(type="KittiDataset", data_root=tree, ann_file=info,
                      pipeline=[dict(type="LoadPoints", load_dim=4,
                                     use_dim=4)]))
    res = dist_train(tmp_path, [
        TINY, "--work-dir", str(tmp_path / "w"), "--cfg-options",
        "task=pretrain_3d", "model.detector_3d={'type': 'SECOND'}",
        f"data.train={train}"])
    assert res.returncode != 0
    # the first process to fail stops the other (the launcher's rule)
    assert "NotImplementedError: SECOND under 2 processes" in res.stderr, \
        res.stderr[-4000:]
    assert "queue 1" in res.stderr
    assert not os.path.exists(tmp_path / "w" / "log.json")
