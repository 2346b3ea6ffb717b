"""The port's command-line tools (``detmatch_tpu_torch/tools``) and the
config overrides they rest on, against the JAX package's
``tools/*.py`` and ``detmatch_tpu/config``, on the CPU.

* ``Config.fromfile`` + ``merge_from_options`` + ``dump`` equal JAX's on
  every config under ``configs/``;
* ``tools.train`` (each task) and ``tools.test`` (each task) hand the
  loops and the evaluations the same values as JAX's CLIs: both ``main``s
  run in process with the loop functions replaced by recorders, no model
  runs;
* ``tools.create_data`` and ``tools.create_ssl_splits`` write the same
  pickles, reduced clouds and gt database as JAX's tools on a
  ``tests/kitti_fixture.py`` tree;
* one real run: pretrain_3d, pretrain_2d and ssl on
  ``configs/tests/ssl_tiny.py`` (the pretraining tasks get their ``task``
  and ``data.train`` through ``--cfg-options``; the RoI head narrowed as
  ``test_torch_port_checkpoints.py`` narrows it), a resume, and
  ``tools.test`` on the SSL checkpoint, ``--device cpu``;
* the multi-process launch: ``--dist-num-processes 1`` runs in one
  process, the ``DETMATCH_*`` environment and the ``--dist-*`` arguments
  reach ``parallel.start_group``, and ``--autoscale-lr`` scales by the
  process count over 8.
"""
import filecmp
import glob
import importlib.util
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402

from detmatch_tpu.config import Config as JConfig  # noqa: E402
from detmatch_tpu_torch.config import Config  # noqa: E402
from detmatch_tpu_torch.tools import create_data as pcreate_data  # noqa: E402
from detmatch_tpu_torch.tools import (  # noqa: E402
    create_ssl_splits as pcreate_splits)
from detmatch_tpu_torch.tools import test as ptest  # noqa: E402
from detmatch_tpu_torch.tools import train as ptrain  # noqa: E402
from detmatch_tpu_torch.utils import visualize  # noqa: E402
from kitti_fixture import make_kitti_random  # noqa: E402
from test_torch_port_checkpoints import MICRO_ROI  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

CONFIGS = sorted(p for p in glob.glob(os.path.join(ROOT, "configs", "**",
                                                   "*.py"), recursive=True)
                 if "_base_" not in p)
TINY = os.path.join(ROOT, "configs", "tests", "ssl_tiny.py")
OPTIONS = {"data.val.data_root": "/elsewhere/", "ssl.ema_decay": 0.5,
           "new.nested.key": (1, 2), "max_iters": 9}


def jax_tool(name):
    """JAX's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    return mod.main()


@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_config_overrides_and_dump_match_jax(path):
    ours = Config.fromfile(path).merge_from_options(dict(OPTIONS))
    want = JConfig.fromfile(path)
    want.merge_from_options(dict(OPTIONS))
    assert dict(ours) == dict(want)
    assert ours.dump() == want.dump()
    assert ours["new"]["nested"]["key"] == (1, 2)


def test_parse_options_matches_jax():
    pairs = ["a=1", "b.c=[1, 2]", "d=some/path", "e={'x': (1, 2)}",
             "f=None", "g=1e-3"]
    assert ptrain.parse_options(pairs) == jax_tool("train").parse_options(
        pairs)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 6-frame tree with ``ImageSets`` split files."""
    root = str(tmp_path_factory.mktemp("kitti_cli"))
    split = make_kitti_random(root, 6, seed=4)
    os.makedirs(os.path.join(root, "ImageSets"))
    ids = open(split).read().split()
    for name, sel in (("train", ids[:4]), ("val", ids[4:])):
        with open(os.path.join(root, "ImageSets", f"{name}.txt"), "w") as f:
            f.write("\n".join(sel) + "\n")
    return root


def _same(a, b, where=""):
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_create_data_and_splits_match_jax(tree, tmp_path, monkeypatch):
    """Every file the two tools write, byte for byte or pickle for pickle
    (the reduced clouds, the gt database's point files, the infos, the
    split infos and the split gt databases)."""
    roots = {}
    for name in ("jax", "port"):
        roots[name] = str(tmp_path / name)
        shutil.copytree(tree, roots[name])
    jd, js = jax_tool("create_data"), jax_tool("create_ssl_splits")
    run_jax_main(jd, ["kitti", "--root", roots["jax"], "--export-2d"],
                 monkeypatch)
    run_jax_main(js, ["--root", roots["jax"], "--fracs", "0.5", "0.25",
                      "--num-splits", "2"], monkeypatch)
    pcreate_data.main(["kitti", "--root", roots["port"], "--export-2d"])
    pcreate_splits.main(["--root", roots["port"], "--fracs", "0.5", "0.25",
                         "--num-splits", "2"])
    files = sorted(os.path.relpath(p, roots["jax"]) for p in glob.glob(
        os.path.join(roots["jax"], "**", "*"), recursive=True)
        if os.path.isfile(p))
    ported = sorted(os.path.relpath(p, roots["port"]) for p in glob.glob(
        os.path.join(roots["port"], "**", "*"), recursive=True)
        if os.path.isfile(p))
    assert files == ported
    n = dict(pkl=0, bin=0)
    for rel in files:
        a, b = (os.path.join(roots[k], rel) for k in ("jax", "port"))
        if rel.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                _same(pickle.load(fa), pickle.load(fb), rel)
            n["pkl"] += 1
        else:
            assert filecmp.cmp(a, b, shallow=False), rel
            n["bin"] += rel.endswith(".bin")
    # infos x2, the global proj_3d infos, 2 fracs x 2 splits x 3 files,
    # the global gt database
    assert n["pkl"] == 2 + 1 + 12 + 1
    reduced = glob.glob(os.path.join(roots["port"], "training",
                                     "velodyne_reduced", "*.bin"))
    full = os.path.join(roots["port"], "training", "velodyne")
    assert any(os.path.getsize(p) < os.path.getsize(
        os.path.join(full, os.path.basename(p))) for p in reduced)


# ------------------------------------------------------- recorded CLI calls

class Recorder:
    def __init__(self, result=None):
        self.calls, self.result = [], result

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.result


def _value(x):
    """A comparable stand-in for a loop argument: datasets by their
    length, voxelizer specs by their fields, callables by being
    callable, everything else itself."""
    if callable(x) and not isinstance(x, type):
        return "callable"
    if hasattr(x, "point_cloud_range"):
        return (tuple(x.point_cloud_range), tuple(x.voxel_size),
                x.max_voxels, x.max_points)
    if hasattr(x, "__len__") and hasattr(x, "__getitem__") and not \
            isinstance(x, (str, dict, list, tuple)):
        return ("dataset", len(x))
    if isinstance(x, dict):
        return {k: _value(v) for k, v in x.items()}
    return x


def _cfg_options(tree, task):
    info = os.path.join(tree, "kitti_infos_train.pkl")
    opts = [f"data.train_lab.dataset.data_root={tree}",
            f"data.train_lab.dataset.ann_file={info}",
            f"data.train_unlab.dataset.data_root={tree}",
            f"data.train_unlab.dataset.ann_file={info}",
            f"data.val.data_root={tree}", f"data.val.ann_file={info}",
            f"model.detector_3d.roi_head_cfg={MICRO_ROI!r}",
            "model.detector_2d.backbone_cfg={'stage_blocks': (1, 1, 1, 1)}"]
    if task != "ssl":
        pipe = [dict(type="LoadImage"),
                dict(type="LoadPoints", load_dim=4, use_dim=4),
                dict(type="Normalize"),
                dict(type="PadToCanvas", canvas=(64, 128))]
        opts += [f"task={task}", "data.train=" + repr(dict(
            type="KittiDataset", data_root=tree, ann_file=info,
            pipeline=pipe))]
    return opts


@pytest.fixture(scope="module")
def infos_tree(tree):
    from detmatch_tpu_torch.data import kitti
    infos = kitti.create_infos(tree, os.path.join(tree, "ImageSets",
                                                  "train.txt"))
    with open(os.path.join(tree, "kitti_infos_train.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return tree


TRAIN_LOOPS = {"ssl": ("train_ssl", "train_ssl"),
               "pretrain_3d": ("train_pretrain", "train_pvrcnn"),
               "pretrain_2d": ("train_pretrain", "train_frcnn")}


@pytest.mark.parametrize("task", list(TRAIN_LOOPS))
def test_train_cli_passes_jax_values(task, infos_tree, tmp_path,
                                     monkeypatch):
    """Every keyword value and the work directory, with every argument
    JAX's CLI reads set away from its default (``--autoscale-lr`` on one
    device in both)."""
    module, fn = TRAIN_LOOPS[task]
    argv = [TINY, "--work-dir", str(tmp_path / "w"), "--seed", "3",
            "--max-iters", "7", "--resume-from", "/ckpt/a",
            "--load-from-with-optimizer", "/ckpt/b", "--autoscale-lr",
            "--cfg-options"] + _cfg_options(infos_tree, task) + [
        "lr_3d=0.5", "lr_2d=0.25", "num_unlabeled_samples=2",
        "log_interval=2", "ckpt_interval=3", "evaluation={'interval': 4}",
        "profile_dir=/prof", "vis_interval=5", "tensorboard=True",
        "base_lr=0.004", "batch_size=1", "step_iters=(2, 5)",
        "load_from={'det3d': '/p3', 'det2d': '/p2'}"]
    jrec, prec = Recorder(), Recorder()
    jmod = importlib.import_module(f"detmatch_tpu.apis.{module}")
    pmod = importlib.import_module(f"detmatch_tpu_torch.apis.{module}")
    monkeypatch.setattr(jmod, fn, jrec)
    monkeypatch.setattr(pmod, fn, prec)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    run_jax_main(jax_tool("train"), argv, monkeypatch)
    ptrain.main(argv + ["--device", "cpu"])
    (jargs, jkw), = jrec.calls
    (pargs, pkw), = prec.calls
    assert jkw.keys() == pkw.keys()
    assert _value(jkw) == _value(pkw)
    # the model first; then the voxelizer, datasets, collate, work dir
    assert [_value(a) for a in jargs[1:]] == [_value(a) for a in pargs[1:]]
    if task == "ssl":
        assert pkw["lr_scale"] == 1 / 8 and pkw["vis_interval"] == 5
        assert pkw["ckpt_meta"]["config_text"] == open(TINY).read()
    else:
        assert pkw["max_iters"] == 7 and pkw["seed"] == 3


EVALS = {"ssl": "eval_ssl", "pretrain_3d": "eval_pvrcnn",
         "pretrain_2d": "eval_frcnn"}


@pytest.mark.parametrize("task,thr", [
    ("ssl", []), ("ssl", ["--score-thr", "0.2", "--score-thr-2d", "0.3"]),
    ("pretrain_3d", ["--score-thr-3d", "0.05"]),
    ("pretrain_2d", ["--score-thr", "0.01"])])
def test_test_cli_passes_jax_values(task, thr, infos_tree, monkeypatch,
                                    capsys):
    """The evaluation's keyword values and dataset, and the printed
    metrics (both CLIs restore through a stub: no model runs)."""
    from detmatch_tpu.apis import evaluate as jeval
    from detmatch_tpu.ssl.detector import SSLDetector as JSSLDetector
    from detmatch_tpu.train import checkpoints as jckpt
    from detmatch_tpu_torch.apis import build
    from detmatch_tpu_torch.apis import evaluate as peval
    from detmatch_tpu_torch.train import checkpoints as pckpt

    res = {"tea.3d.mAP_3d_moderate": 0.25, "stu.2d.mAP_bbox_moderate": 0.5}
    jres = res if task == "ssl" else (res, [])
    jrec, prec = Recorder(jres), Recorder(jres)
    monkeypatch.setattr(jeval, EVALS[task], jrec)
    monkeypatch.setattr(peval, EVALS[task], prec)
    monkeypatch.setattr(jckpt, "latest_step", lambda path: 4)
    monkeypatch.setattr(jckpt, "restore", lambda path, step, tmpl: dict(
        state=None, model=None))
    monkeypatch.setattr(JSSLDetector, "init_states",
                        lambda self, *a, **k: None)
    opts = _cfg_options(infos_tree, task)
    cfg = ptrain.load_config(TINY, opts)
    if task == "ssl":
        payload = dict(state=build.build_ssl(cfg, "cpu").state_dict())
    else:
        key = "detector_3d" if task == "pretrain_3d" else "detector_2d"
        payload = dict(model=build.build_detector(cfg, "cpu", key)
                       .state_dict())
    monkeypatch.setattr(pckpt, "latest_step", lambda path: 4)
    monkeypatch.setattr(pckpt, "restore", lambda path, step: payload)
    jax_cfg = os.path.join(infos_tree, f"cfg_{task}.py")
    with open(jax_cfg, "w") as f:  # JAX's test CLI has no --cfg-options
        f.write(f"_base_ = {TINY!r}\n")
        for k, v in ptrain.parse_options(opts).items():
            if "." not in k:
                f.write(f"{k} = {v!r}\n")
        f.write(f"data = {cfg['data']!r}\nmodel = {cfg['model']!r}\n")
    run_jax_main(jax_tool("test"), [jax_cfg, "/ckpt"] + thr, monkeypatch)
    jout = capsys.readouterr().out
    ptest.main([TINY, "/ckpt", "--device", "cpu", "--cfg-options"] + opts
               + thr)
    pout = capsys.readouterr().out
    (jargs, jkw), = jrec.calls
    (pargs, pkw), = prec.calls
    assert jkw == pkw
    # JAX passes the restored variables after the model
    assert [_value(a) for a in jargs[2:]] == [_value(a) for a in pargs[1:]]
    assert pout == jout and "tea.3d.mAP_3d_moderate: 0.2500" in pout


# ------------------------------------------------------------ the real run

def _log(work):
    with open(os.path.join(work, "log.json")) as f:
        return [json.loads(x) for x in f if x.strip()]


def test_cli_pretrain_ssl_resume_test_on_cpu(infos_tree, tmp_path, capsys):
    """pretrain_3d and pretrain_2d one step each, ssl two iterations from
    both (``load_from``, a checkpoint and the three pictures an iteration,
    an evaluation at the end), resumed to three, then ``tools.test`` on
    the SSL checkpoint: the eight tea/stu x 2d/3d AP families."""
    work = tmp_path / "work"
    common = ["--device", "cpu", "--cfg-options"]
    for task in ("pretrain_3d", "pretrain_2d"):
        _, _, hist = ptrain.main(
            [TINY, "--work-dir", str(work / task), "--max-iters", "1"]
            + common + _cfg_options(infos_tree, task)
            + ["base_lr=1e-4", "batch_size=1"])
        assert np.isfinite(hist[0]["loss"])
        assert os.path.isdir(work / task / "ckpt" / "ckpt_1")
    ssl_opts = _cfg_options(infos_tree, "ssl") + [
        "load_from=" + repr({"det3d": str(work / "pretrain_3d" / "ckpt"),
                             "det2d": str(work / "pretrain_2d" / "ckpt")}),
        "log_interval=1", "ckpt_interval=1", "vis_interval=1",
        "evaluation={'interval': 2}"]
    ptrain.main([TINY, "--work-dir", str(work / "ssl"), "--max-iters", "2"]
                + common + ssl_opts)
    ptrain.main([TINY, "--work-dir", str(work / "ssl"), "--max-iters", "3",
                 "--resume-from", str(work / "ssl" / "ckpt")]
                + common + ssl_opts + ["evaluation=None"])
    log = _log(work / "ssl")
    assert [e["iter"] for e in log if e["mode"] == "train"] == [1, 2, 3]
    assert [e["iter"] for e in log if e["mode"] == "val"] == [2]
    assert sorted(os.listdir(work / "ssl" / "ckpt")) == [
        "ckpt_1", "ckpt_2", "ckpt_3"]
    canvas = (64, 128, 3)
    for it in (1, 2, 3):
        for kind, shape in (("bev", (800, 704, 3)), ("2d", canvas),
                            ("pairs", canvas)):
            img = visualize.read_png(work / "ssl" / "vis"
                                     / f"iter{it:06d}_{kind}.png")
            assert img.shape == shape
    capsys.readouterr()
    res = ptest.main([TINY, str(work / "ssl" / "ckpt"), "--out",
                      str(tmp_path / "res.json")] + common
                     + _cfg_options(infos_tree, "ssl"))
    out = capsys.readouterr().out
    for b in ("tea", "stu"):
        for d, m in (("3d", "3d"), ("2d", "bbox")):
            assert f"{b}.{d}.mAP_{m}_moderate: " in out
            assert f"{b}.{d}.num_dets" in res
    assert json.load(open(tmp_path / "res.json")) == pytest.approx(res)


# ------------------------------------------------ multi-process launch, -m

def _dist_env_cleared(monkeypatch):
    for k in ("DETMATCH_COORDINATOR", "DETMATCH_NUM_PROCESSES",
              "DETMATCH_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)


def test_one_process_launch_runs_single_process(monkeypatch, infos_tree):
    """``--dist-num-processes 1`` (and a coordinator) is a one-process
    run: no process group, the loop called once."""
    from detmatch_tpu_torch import parallel
    from detmatch_tpu_torch.apis import train_ssl as ptrain_ssl
    _dist_env_cleared(monkeypatch)
    rec = Recorder("done")
    monkeypatch.setattr(ptrain_ssl, "train_ssl", rec)
    assert ptrain.main([TINY, "--device", "cpu", "--dist-coordinator",
                        "localhost:1234", "--dist-num-processes", "1",
                        "--dist-process-id", "0", "--cfg-options"]
                       + _cfg_options(infos_tree, "ssl")) == "done"
    assert len(rec.calls) == 1
    assert parallel.process_count() == 1
    assert not torch_dist_initialized()


def torch_dist_initialized():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


@pytest.mark.parametrize("by", ["environment", "arguments"])
def test_launch_reaches_init_distributed(by, monkeypatch, tmp_path,
                                        infos_tree):
    """The ``DETMATCH_*`` environment (as ``tools.dist_train`` sets it)
    or the ``--dist-*`` arguments reach ``parallel.start_group``, with
    gloo for ``--device cpu``."""
    from detmatch_tpu_torch.apis import train_ssl as ptrain_ssl
    from detmatch_tpu_torch.parallel import distributed
    _dist_env_cleared(monkeypatch)
    address = f"file://{tmp_path}/store"
    extra = []
    if by == "environment":
        monkeypatch.setenv("DETMATCH_COORDINATOR", address)
        monkeypatch.setenv("DETMATCH_NUM_PROCESSES", "3")
        monkeypatch.setenv("DETMATCH_PROCESS_ID", "2")
    else:
        extra = ["--dist-coordinator", address, "--dist-num-processes", "3",
                 "--dist-process-id", "2"]
    started = Recorder()
    monkeypatch.setattr(distributed, "start_group", started)
    monkeypatch.setattr(ptrain_ssl, "train_ssl", Recorder())
    ptrain.main([TINY, "--device", "cpu"] + extra + ["--cfg-options"]
                + _cfg_options(infos_tree, "ssl"))
    (args, _), = started.calls
    assert args[:4] == (address, 3, 2, "gloo")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_autoscale_lr_scales_by_processes(world, monkeypatch, infos_tree):
    """``--autoscale-lr``: every rate times the processes (one device
    each) over 8 — the SSL loop's ``lr_scale`` and the pretraining
    ``base_lr``."""
    from detmatch_tpu_torch.apis import train_pretrain as ptrain_pre
    from detmatch_tpu_torch.apis import train_ssl as ptrain_ssl
    _dist_env_cleared(monkeypatch)
    monkeypatch.setattr(ptrain, "process_count", lambda: world)
    ssl, pre = Recorder(), Recorder()
    monkeypatch.setattr(ptrain_ssl, "train_ssl", ssl)
    monkeypatch.setattr(ptrain_pre, "train_pvrcnn", pre)
    ptrain.main([TINY, "--device", "cpu", "--autoscale-lr", "--cfg-options"]
                + _cfg_options(infos_tree, "ssl"))
    assert ssl.calls[0][1]["lr_scale"] == world / 8
    ptrain.main([TINY, "--device", "cpu", "--autoscale-lr", "--cfg-options"]
                + _cfg_options(infos_tree, "pretrain_3d") + ["base_lr=0.004"])
    assert pre.calls[0][1]["base_lr"] == pytest.approx(0.004 * world / 8)


def test_tools_run_as_modules():
    """``python -m detmatch_tpu_torch.tools.<name> --help`` for the five
    tools, in one process that blocks the JAX package; the launcher's
    says that JAX's ``--local-devices`` has no counterpart."""
    code = ("import runpy, sys\n"
            "for m in ('jax', 'flax', 'detmatch_tpu'):\n"
            "    sys.modules[m] = None\n"
            "for name in ('train', 'test', 'create_data',\n"
            "             'create_ssl_splits', 'dist_train'):\n"
            "    sys.argv = [name, '--help']\n"
            "    try:\n"
            "        runpy.run_module('detmatch_tpu_torch.tools.' + name,\n"
            "                         run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (name, e.code)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("usage:") == 5
    assert "--local-devices has no counterpart" in proc.stdout
