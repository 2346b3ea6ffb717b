"""Checkpoints and the dataset-driven training loops of the port on the
CPU (``train/checkpoints.py``, ``apis/train_pretrain.py:train_pvrcnn`` /
``train_frcnn``, ``apis/train_ssl.py:train_ssl``), from a generated
mini-KITTI tree (``tests/kitti_fixture.py``).

The recipe of the README at a tiny size: 3D and 2D pretraining with a
checkpoint a step → SSL with ``load_from`` on both, a checkpoint an
iteration and an evaluation → resume. The model is
``configs/tests/ssl_tiny.py`` with a narrower RoI head (``MICRO_ROI``:
the tiny config's RoI-grid pooling costs ~20 s an iteration on one CPU
thread, this one about a second) and one block a ResNet stage, since
the loops, not the widths, are under test here.

A resumed run restarts both loaders from their seeds, as the JAX loop
does, and the pipelines share one ``RandomState`` across the loader's
threads, so no two runs see the same augmented batches. What resume must
give, and what is checked: the restored state equals the live state bit
for bit (both detectors, both optimizers' moments and counters, the
generator), and one iteration on a pinned batch from the restored state
equals the same iteration from the live state bit for bit.
"""
import copy
import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from detmatch_tpu.models.frcnn.faster_rcnn import (  # noqa: E402
    FasterRCNN as JFasterRCNN)
from detmatch_tpu.models.pvrcnn.pvrcnn import PVRCNN as JPVRCNN  # noqa: E402
from detmatch_tpu_torch.apis.build import (build_dataset,  # noqa: E402
                                           build_detector, build_ssl,
                                           build_voxelizer)
from detmatch_tpu_torch.apis.train_pretrain import (  # noqa: E402
    train_frcnn, train_pvrcnn)
from detmatch_tpu_torch.apis.train_ssl import (  # noqa: E402
    restore_ssl_checkpoint, ssl_iteration, ssl_optimizers, train_ssl)
from detmatch_tpu_torch.config import Config  # noqa: E402
from detmatch_tpu_torch.convert import (from_jax_frcnn,  # noqa: E402
                                        from_jax_pvrcnn)
from detmatch_tpu_torch.data import kitti  # noqa: E402
from detmatch_tpu_torch.data.collate import (collate_ts,  # noqa: E402
                                             collate_view)
from detmatch_tpu_torch.models.pvrcnn.roi_head import (  # noqa: E402
    default_target_cfg)
from detmatch_tpu_torch.train import checkpoints  # noqa: E402
from detmatch_tpu_torch.train.optim import BranchOptimizer  # noqa: E402
from detmatch_tpu_torch.train.optim import warmup_step_lr  # noqa: E402
from detmatch_tpu_torch.utils import tiny  # noqa: E402
from kitti_fixture import make_kitti_random  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = os.path.join(ROOT, "configs", "tests", "ssl_tiny.py")
MICRO_ROI = dict(grid_size=2, pool_nsamples=(4, 4),
                 pool_mlps=((8, 8), (8, 8)), shared_fc=(32, 32),
                 cls_fc=(32, 32), reg_fc=(32, 32),
                 target_cfg=dict(default_target_cfg(), roi_per_image=16))
PRETRAIN_PIPE = [dict(type="LoadImage"),
                 dict(type="LoadPoints", load_dim=4, use_dim=4),
                 dict(type="Normalize"),
                 dict(type="PadToCanvas", canvas=(64, 128))]


def micro_cfg(root=None):
    cfg = Config.fromfile(TINY)
    cfg["model"]["detector_3d"]["roi_head_cfg"] = MICRO_ROI
    cfg["model"]["detector_2d"]["backbone_cfg"] = dict(
        stage_blocks=(1, 1, 1, 1))
    if root is None:
        return cfg
    info = os.path.join(root, "kitti_infos_train.pkl")
    data = cfg["data"]
    for key in ("train_lab", "train_unlab"):
        data[key]["dataset"].update(data_root=root, ann_file=info)
    data["val"].update(data_root=root, ann_file=info)
    return cfg


def state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def opt_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k, v in sa.items():
        if isinstance(v, list):
            assert all(torch.equal(x, y) for x, y in zip(v, sb[k])), k
        else:
            assert v == sb[k], k


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The recipe, once: a 4-frame tree and its infos; train_pvrcnn and
    train_frcnn, 2 steps of B=1 each with a checkpoint a step (the 3D
    rate a tenth of the recipe's: two one-cycle steps at the recipe's
    peak of 1e-2 leave the tiny PV-RCNN with non-finite boxes); train_ssl
    for 2 iterations from both with a checkpoint an iteration and an
    evaluation at iteration 2."""
    root = str(tmp_path_factory.mktemp("kitti_tree"))
    work = tmp_path_factory.mktemp("work")
    split = make_kitti_random(root, 4, seed=2)
    with open(os.path.join(root, "kitti_infos_train.pkl"), "wb") as f:
        pickle.dump(kitti.create_infos(root, split), f)
    cfg = micro_cfg(root)
    spec = build_voxelizer(cfg)
    ck = cfg["data"]["collate"]
    train = build_dataset(dict(
        type="KittiDataset", data_root=root, pipeline=PRETRAIN_PIPE,
        ann_file=os.path.join(root, "kitti_infos_train.pkl")))
    torch.manual_seed(0)
    pv, pv_opt, pv_hist = train_pvrcnn(
        build_detector(cfg, device="cpu"), spec, train,
        lambda s: collate_view(s, **ck), str(work / "pre3d"), 2,
        base_lr=1e-4, batch_size=1, log_interval=1, ckpt_interval=1)
    fr, fr_opt, fr_hist = train_frcnn(
        build_detector(cfg, device="cpu", key="detector_2d"), train,
        lambda s: collate_view(s, **ck), str(work / "pre2d"), 2,
        batch_size=1, log_interval=1, ckpt_interval=1)
    load_from = dict(det3d=str(work / "pre3d" / "ckpt"),
                     det2d=str(work / "pre2d" / "ckpt"))
    data = cfg["data"]
    lab = build_dataset(data["train_lab"], rng=np.random.RandomState(0))
    unlab = build_dataset(data["train_unlab"], rng=np.random.RandomState(1))
    val = build_dataset(data["val"])
    kw = dict(batch_size=1, warmup_iters=2, log_interval=1, seed=0,
              val_collate_fn=lambda s: collate_view(s, **ck))
    ssl = build_ssl(cfg, device="cpu")
    ssl, opts, hist = train_ssl(
        ssl, spec, lab, unlab, lambda s: collate_ts(s, **ck),
        str(work / "ssl"), 2, ckpt_interval=1, load_from=load_from,
        val_dataset=val, eval_interval=2,
        ckpt_meta=dict(classes=kitti.CLASS_NAMES), **kw)
    return dict(cfg=cfg, spec=spec, work=work, pv=pv, fr=fr,
                pv_hist=pv_hist, fr_hist=fr_hist, fr_opt=fr_opt,
                load_from=load_from, lab=lab, unlab=unlab, val=val, kw=kw,
                ssl=ssl, opts=opts, hist=hist)


def test_pretraining_loops_write_checkpoints(run):
    """Both loops ran from the tree: finite losses, ``log.json`` a line a
    step, ``ckpt_1`` and ``ckpt_2`` holding ``dict(model=state_dict)``,
    the last equal to the trained model."""
    for name, model, hist in (("pre3d", run["pv"], run["pv_hist"]),
                              ("pre2d", run["fr"], run["fr_hist"])):
        d = run["work"] / name
        assert len(hist) == 2 and all(np.isfinite(v) for h in hist
                                      for v in h.values())
        assert len((d / "log.json").read_text().splitlines()) == 2
        assert checkpoints.latest_step(str(d / "ckpt")) == 2
        assert (d / "ckpt" / "ckpt_1").is_dir()
        payload = checkpoints.restore(str(d / "ckpt"), 2)
        assert set(payload) == {"model"}
        state_equal(payload["model"], model.state_dict())
    assert run["fr_opt"].count == 2 and run["fr_opt"].kind == "sgd"
    assert {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
            "loss"} == set(run["fr_hist"][0])


def test_load_from_puts_each_detector_in_both_branches(run):
    """``train_ssl`` with ``load_from`` and no iteration leaves the
    student and the teacher equal to the pretraining checkpoints bit for
    bit, the teacher in tensors of its own."""
    ssl = build_ssl(run["cfg"], device="cpu")
    ck = run["cfg"]["data"]["collate"]
    ssl, _, hist = train_ssl(
        ssl, run["spec"], run["lab"], run["unlab"],
        lambda s: collate_ts(s, **ck), str(run["work"] / "ssl_load"), 0,
        load_from=run["load_from"], **run["kw"])
    assert hist == []
    for key, path in run["load_from"].items():
        want = checkpoints.restore(path, 2)["model"]
        state_equal(ssl.student[key].state_dict(), want)
        state_equal(ssl.teacher[key].state_dict(), want)
        s, t = ssl.student[key].state_dict(), ssl.teacher[key].state_dict()
        assert all(s[k].data_ptr() != t[k].data_ptr() for k in s)


def test_train_ssl_checkpoints_and_evaluates(run):
    """Two iterations from the tree: a train line an iteration and a val
    line with the {tea, stu} × {3d, 2d} APs at iteration 2; ``ckpt_1`` and
    ``ckpt_2`` with ``meta.json``; ``ckpt_2`` equal to the live state bit
    for bit (the detector, both optimizers)."""
    assert len(run["hist"]) == 2
    assert all(np.isfinite(v) for h in run["hist"] for v in h.values())
    lines = [json.loads(x) for x in (run["work"] / "ssl" / "log.json")
             .read_text().splitlines()]
    assert [x["mode"] for x in lines] == ["train", "train", "val"]
    val = lines[-1]
    assert val["iter"] == 2
    for k in ("tea.3d.mAP_3d_moderate", "stu.2d.mAP_bbox_moderate",
              "tea.2d.num_dets", "stu.3d.mAP_aos_moderate"):
        assert np.isfinite(val[k]), k
    ckpt = str(run["work"] / "ssl" / "ckpt")
    assert checkpoints.latest_step(ckpt) == 2
    meta = json.loads(open(os.path.join(ckpt, "ckpt_2", "meta.json")).read())
    assert meta["iter"] == 2 and meta["torch"] == torch.__version__
    assert meta["CLASSES"] == list(kitti.CLASS_NAMES)
    payload = checkpoints.restore(ckpt, 2)
    state_equal(payload["state"], run["ssl"].state_dict())
    for opt, key in zip(run["opts"], ("det3d", "det2d")):
        live = opt.state_dict()
        assert payload["opt_state"][key]["count"] == live["count"] == 2
        assert payload["opt_state"][key]["skipped"] == live["skipped"]
    fresh = build_ssl(run["cfg"], device="cpu")
    opts = ssl_optimizers(fresh, 1, warmup_iters=2)
    restore_ssl_checkpoint(fresh, opts, torch.Generator(), payload)
    state_equal(fresh.state_dict(), run["ssl"].state_dict())
    for a, b in zip(opts, run["opts"]):
        opt_equal(a, b)


def test_iteration_from_restored_state_equals_live(run):
    """One iteration on a pinned batch from ``ckpt_2`` restored into a
    new detector equals the same iteration from the live state: every
    log value and every tensor of the detector and the optimizers, bit
    for bit."""
    payload = checkpoints.restore(str(run["work"] / "ssl" / "ckpt"), 2)
    restored = build_ssl(run["cfg"], device="cpu")
    r_opts = ssl_optimizers(restored, 1, warmup_iters=2)
    r_gen = torch.Generator()
    restore_ssl_checkpoint(restored, r_opts, r_gen, payload)
    live, l_opts = copy.deepcopy((run["ssl"], run["opts"]))
    l_gen = torch.Generator()
    l_gen.set_state(payload["rng"])
    batch = tiny.tiny_ssl_batch(np.random.RandomState(7))
    outs = []
    for m, opts, gen in ((restored, r_opts, r_gen), (live, l_opts, l_gen)):
        m.train()
        outs.append(ssl_iteration(m, opts, run["spec"], batch, 2, gen))
    assert outs[0] == outs[1]
    state_equal(restored.state_dict(), live.state_dict())
    for a, b in zip(r_opts, l_opts):
        opt_equal(a, b)
        assert a.count == 3


def test_resume_and_bootstrapped_resume(run, tmp_path):
    """``resume_from`` continues at the checkpoint's iteration (one more
    to 3); ``load_from_with_optimizer`` restores the same state but
    restarts the count at 0."""
    ck = run["cfg"]["data"]["collate"]
    coll = lambda s: collate_ts(s, **ck)  # noqa: E731
    ckpt = str(run["work"] / "ssl" / "ckpt")
    ssl, opts, hist = train_ssl(
        build_ssl(run["cfg"], device="cpu"), run["spec"], run["lab"],
        run["unlab"], coll, str(tmp_path / "resume"), 3, resume_from=ckpt,
        ckpt_interval=5, **run["kw"])
    assert len(hist) == 1 and opts[0].count == 3
    lines = (tmp_path / "resume" / "log.json").read_text().splitlines()
    assert json.loads(lines[0])["iter"] == 3
    assert checkpoints.latest_step(str(tmp_path / "resume" / "ckpt")) == 3
    ssl, opts, hist = train_ssl(
        build_ssl(run["cfg"], device="cpu"), run["spec"], run["lab"],
        run["unlab"], coll, str(tmp_path / "boot"), 1,
        load_from_with_optimizer=ckpt, **run["kw"])
    assert len(hist) == 1 and opts[0].count == 3 and opts[1].count == 3
    with pytest.raises(FileNotFoundError):
        train_ssl(build_ssl(run["cfg"], device="cpu"), run["spec"],
                  run["lab"], run["unlab"], coll, str(tmp_path / "none"), 1,
                  resume_from=str(tmp_path / "missing"), **run["kw"])


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_branch_optimizer_state_round_trip(kind, tmp_path):
    """``state_dict`` / ``load_state_dict`` of a branch optimizer carry
    its moments, ``count`` and ``skipped`` exactly: the restored
    optimizer's next step equals the original's."""
    g = torch.Generator().manual_seed(0)
    params = [torch.randn(5, 3, generator=g), torch.randn(7, generator=g)]
    twins = [[p.clone() for p in params] for _ in range(2)]
    opts = [BranchOptimizer(ps, kind, warmup_step_lr(0.1, 4))
            for ps in twins]
    for step in range(3):
        for p in twins[0]:
            p.grad = torch.randn(p.shape, generator=g)
        if step == 1:
            twins[0][1].grad[0] = float("nan")
        opts[0].step()
    checkpoints.save(str(tmp_path), dict(opt=opts[0].state_dict()), 1)
    opts[1].load_state_dict(checkpoints.restore(str(tmp_path), 1)["opt"])
    for a, b in zip(*twins):
        b.copy_(a)
    assert opts[1].count == 2 and opts[1].skipped == 1
    grads = [torch.randn(p.shape, generator=g) for p in params]
    for ps, opt in zip(twins, opts):
        for p, gr in zip(ps, grads):
            p.grad = gr.clone()
        opt.step()
    for a, b in zip(*twins):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        BranchOptimizer(params, "sgd" if kind == "adamw" else "adamw",
                        warmup_step_lr(0.1)).load_state_dict(
            opts[0].state_dict())


def _jax_variables(module, *args, seed=0, **kw):
    """Variables of the JAX module's structure (``jax.eval_shape`` of its
    init), filled with seeded random numbers."""
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(0),
         "dropout": jax.random.PRNGKey(0)}, *args, **kw))
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda s: (0.5 + rng.rand(*s.shape) if s.dtype == np.float32
                   else np.zeros(s.shape)).astype(s.dtype), shapes)


def test_jax_weights_through_save_and_load_from(tmp_path):
    """JAX variables → ``from_jax_*`` → ``checkpoints.save`` as a
    pretraining run writes them → ``train_ssl``'s ``load_from`` into an
    SSL detector (the micro config's, as the other tests'): student and
    teacher equal the converted weights bit for bit, and the teacher is a
    copy (a step on the student leaves it as it was)."""
    cfg = micro_cfg()
    m = cfg["model"]
    rng = np.random.RandomState(0)
    view = {k: np.asarray(v) for k, v in tiny.tiny_view(
        rng, b=1, p=256, with_gt=True).items() if not k.startswith("aug")}
    from detmatch_tpu.ops import voxelize as jvox
    from torch_port_ssl_fixture import jax_spec
    vox = jax.vmap(lambda p, v: jvox.voxelize_mean(p, v, jax_spec(cfg)))(
        view["points"], view["points_valid"])
    view.update(voxel_features=vox["features"], voxel_keys=vox["keys"])
    v3 = _jax_variables(JPVRCNN(**m["detector_3d"]), view, train=True)
    v2 = _jax_variables(JFasterRCNN(**m["detector_2d"]), view["img"],
                        view["img_shape"], train=True, seed=1)
    sds = dict(det3d=from_jax_pvrcnn(v3["params"], v3["batch_stats"],
                                     m["detector_3d"]),
               det2d=from_jax_frcnn(v2["params"], v2["frozen"],
                                    m["detector_2d"]))
    load_from = {}
    for key, sd in sds.items():
        load_from[key] = str(tmp_path / key / "ckpt")
        checkpoints.save(load_from[key], dict(model=sd), 7)
    ssl = build_ssl(cfg, device="cpu")
    for key, path in load_from.items():
        checkpoints.load_pretrained_into_ssl(
            ssl, checkpoints.restore(path, checkpoints.latest_step(path))
            ["model"], key)
    for key, sd in sds.items():
        for half in (ssl.student, ssl.teacher):
            got = half[key].state_dict()
            assert all(torch.equal(got[k], v) for k, v in sd.items()), key
            assert set(got) == set(sd)
    with torch.no_grad():
        for p in ssl.student.parameters():
            p.add_(1.0)
    for key, sd in sds.items():
        got = ssl.teacher[key].state_dict()
        assert all(torch.equal(got[k], v) for k, v in sd.items()), key
