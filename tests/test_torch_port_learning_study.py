"""The port's learning study (``detmatch_tpu_torch/tools/misc/
learning_study.py``) on the CPU, against the JAX package's
(``tools/misc/learning_study.py``, loaded by path: its import builds no
model).

* ``utils/synth_kitti.make_kitti_random`` writes the tree that the test
  fixture ``tests/kitti_fixture.make_kitti_random`` writes, for each of
  the study's three splits and at the fixture's defaults: velodyne files
  byte for byte, label, calibration and split text equal, images equal
  pixel for pixel after decoding (the port writes its PNGs with
  ``utils.visualize.write_png``, the fixture with PIL).
* ``build_cfg`` gives JAX's config on the same root and paths.
* The data the study trains on equals JAX's through each package's data
  layer (no model): the first collated batch of each split (the
  loaders' first index batch, samples drawn in the same order) and the
  recalibration batches, integers exactly and floats within 1e-6.
* The study's functions run on the CPU (2 iterations an arm, 2
  recalibration passes) at ``configs/tests/ssl_tiny.py``'s widths with
  the checkpoint tests' narrow RoI head and one block a ResNet stage
  (``test_torch_port_checkpoints.micro_cfg``: the loop, not the widths,
  is under test), on a small tree of the study's splits. The report's
  keys equal those of JAX's record ``docs/learning_study.json`` (and
  ``run``); the arms run one at a time (``--arm``: the report waits for
  the second), and a rerun on the same tree resumes at ``max_iters``,
  trains no iteration and returns the cached evaluations.

The loop's per-iteration parity with JAX is held by
``test_torch_port_train_ssl.py`` and ``test_torch_port_ssl_step.py``.
"""
import filecmp
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

from detmatch_tpu.apis import build as jbuild  # noqa: E402
from detmatch_tpu.data import collate as jcollate  # noqa: E402
from detmatch_tpu.data import loader as jloader  # noqa: E402
from detmatch_tpu_torch.apis import build as pbuild  # noqa: E402
from detmatch_tpu_torch.data import collate as pcollate  # noqa: E402
from detmatch_tpu_torch.data import loader as ploader  # noqa: E402
from detmatch_tpu_torch.tools.misc import learning_study as ls  # noqa: E402
from detmatch_tpu_torch.utils.synth_kitti import (  # noqa: E402
    make_kitti_random)
from detmatch_tpu_torch.utils.visualize import read_png  # noqa: E402
from kitti_fixture import make_kitti_random as fixture_random  # noqa: E402
from test_torch_port_checkpoints import micro_cfg  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401
from torch_port_ssl_fixture import port_threads  # noqa: E402

JAX_TOOL = os.path.join(ROOT, "tools", "misc", "learning_study.py")
JAX_RECORD = os.path.join(ROOT, "docs", "learning_study.json")
FLOAT_TOL = 1e-6
# a small tree of the study's splits (the study's seeds and frame ids):
# enough frames for a batch of each loader (2 labeled, 2 x 2 unlabeled)
SMALL_SPECS = dict(lab=(4, 0, 0), unlab=(4, 100, 200), val=(2, 500, 400))
ITERS = 2


def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_learning_study",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def study_split(name):
    n, seed, start = ls.SPECS[name]
    return dict(seed=seed, split=name, start_idx=start, max_objects=4,
                classes=("Car",), yaw_range=(-0.35, 0.35))


@pytest.mark.parametrize("kind", ["lab", "unlab", "val", "defaults"])
def test_make_kitti_random_writes_the_fixtures_tree(kind, tmp_path):
    kw = dict(seed=7) if kind == "defaults" else study_split(kind)
    want = fixture_random(str(tmp_path / "jax") + "/", 2, **kw)
    got = make_kitti_random(str(tmp_path / "port") + "/", 2, **kw)
    assert os.path.basename(got) == os.path.basename(want)
    with open(got) as a, open(want) as b:
        assert a.read() == b.read()
    from PIL import Image
    n = 0
    for sub in ("velodyne", "velodyne_reduced", "calib", "label_2",
                "image_2"):
        names = sorted(os.listdir(tmp_path / "jax" / "training" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / "training"
                                          / sub)) and len(names) == 2
        for f in names:
            a = tmp_path / "port" / "training" / sub / f
            b = tmp_path / "jax" / "training" / sub / f
            if sub == "image_2":
                np.testing.assert_array_equal(
                    read_png(str(a)), np.asarray(Image.open(b)), err_msg=f)
            else:
                assert filecmp.cmp(a, b, shallow=False), (sub, f)
            n += 1
    assert n == 10


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The study's splits at SMALL_SPECS' sizes and both packages' configs
    of both arms on it."""
    root = str(tmp_path_factory.mktemp("study")) + "/"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ls, "SPECS", SMALL_SPECS)
        paths = ls.make_data(root)
    jtool = jax_tool()
    cfgs = {}
    for arm, w in (("labonly", 0.0), ("ssl", 1.0)):
        wd = os.path.join(root, f"run_{arm}")
        cfgs[arm] = (ls.build_cfg(root, paths, 3000, w, wd, seed=0),
                     jtool.build_cfg(root, paths, 3000, w, wd, seed=0))
    return dict(root=root, paths=paths, cfgs=cfgs, jtool=jtool)


def plain(x):
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


@pytest.mark.parametrize("arm", ["labonly", "ssl"])
def test_build_cfg_equals_jax(tree, arm):
    ours, want = tree["cfgs"][arm]
    assert plain(dict(ours)) == plain(dict(want))
    assert ours["model"]["detector_3d"]["grid_size"] == (128, 128, 40)
    assert ours["ssl"]["ssl_weight"] == (0.0 if arm == "labonly" else 1.0)


def assert_tree_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_tree_equal(got[k], want[k], f"{where}.{k}")
        return
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, where
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL,
                                   err_msg=where)
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


def first_batches(b, cfg, collate, ts_collate):
    """The first collated batch of the labeled, unlabeled and val splits as
    ``run_training`` and ``run_eval`` feed them: the datasets built with
    one ``RandomState(0)`` (labeled, then unlabeled), the loaders' first
    index batch (seeds 0 and 1), the val split in order."""
    rng = np.random.RandomState(0)
    data = cfg["data"]
    ck = dict(data.get("collate", {}))
    out = {}
    for split, seed, size in (("train_lab", 0, cfg["batch_size"]),
                              ("train_unlab", 1, cfg["batch_size"]
                               * cfg["num_unlabeled_samples"])):
        ds = b.build_dataset(data[split], rng=rng)
        idx = next(b.Loader(ds, size, None, seed=seed)._index_stream())
        out[split] = ts_collate([ds[int(i)] for i in idx], **ck)
    val = b.build_dataset(data["val"], rng=np.random.RandomState(0))
    out["val"] = collate([val[0], val[1]], **ck)
    return out


def test_first_batches_equal_jax(tree):
    cfg, jcfg = tree["cfgs"]["ssl"]

    class P:
        build_dataset = staticmethod(pbuild.build_dataset)
        Loader = ploader.Loader

    class J:
        build_dataset = staticmethod(jbuild.build_dataset)
        Loader = jloader.Loader

    got = first_batches(P, cfg, pcollate.collate_view, pcollate.collate_ts)
    want = first_batches(J, jcfg, jcollate.collate_view,
                         jcollate.collate_ts)
    want = {k: jax_plain(v) for k, v in want.items()}
    assert got["train_lab"]["stu"]["gt_boxes"][..., 7].max() > 0
    assert got["train_lab"]["stu"]["points"].shape[1] == 4096
    for k in want:
        assert_tree_equal(got[k], want[k], k)


def jax_plain(tree):
    """JAX's collated batch with its NamedTuple aug records as dicts."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: jax_plain(v) for k, v in tree.items()}
    return tree


def test_recalibration_batches_equal_jax(tree):
    cfg, jcfg = tree["cfgs"]["labonly"]
    got = ls.recalibration_samples(cfg)
    lab = jbuild.build_dataset(jcfg["data"]["train_lab"],
                               rng=np.random.RandomState(123))
    ck = dict(jcfg["data"].get("collate", {}))
    n = len(lab)
    want = [jcollate.collate_ts([lab[s0], lab[(s0 + 1) % n]], **ck)
            for s0 in range(0, min(n, 8), 2)]
    assert len(got) == len(want) == 4  # 4 frames, repeated 10 times
    for i, (g, w) in enumerate(zip(got, want)):
        assert_tree_equal(g, jax_plain(w), f"batch {i}")


@pytest.fixture(scope="module")
def cpu_study(tree):
    """The study twice on the small tree (the second run resumes), its
    configs at the tiny widths of ``micro_cfg``."""
    tiny = micro_cfg()

    def tiny_cfg(*args, **kw):
        cfg = build_cfg(*args, **kw)
        cfg["model"] = tiny["model"]
        cfg["voxelizer"] = tiny["voxelizer"]
        cfg["data"]["collate"] = tiny["data"]["collate"]
        for split in ("train_lab", "train_unlab"):
            for key in ("shared_pipeline", "student_pipeline",
                        "teacher_pipeline"):
                cfg["data"][split][key] = tiny["data"][split][key]
        cfg["data"]["val"]["pipeline"] = tiny["data"]["val"]["pipeline"]
        return cfg

    build_cfg = ls.build_cfg
    with pytest.MonkeyPatch.context() as mp, port_threads():
        mp.setattr(ls, "SPECS", SMALL_SPECS)
        mp.setattr(ls, "build_cfg", tiny_cfg)
        # the arms one at a time (``--arm``), then both again
        partial = ls.run_study(tree["root"], ITERS, "cpu", keep=True,
                               recal_passes=2, arms=("labonly",))
        first = ls.run_study(tree["root"], ITERS, "cpu", keep=True,
                             recal_passes=2, arms=("ssl",))
        second = ls.run_study(tree["root"], ITERS, "cpu", keep=True,
                              recal_passes=2)
    return partial, first, second


def test_study_report_has_jax_keys(cpu_study):
    partial, (report, ok), _ = cpu_study
    assert partial == (None, None)  # arm B had no result yet
    assert report["run"]["arms_trained_here"] == ["ssl"]
    with open(JAX_RECORD) as f:
        record = json.load(f)
    assert set(report) == set(record) | {"run"}
    for k in ("ap_init", "ap_labonly", "ap_ssl"):
        assert set(report[k]) == set(record[k]), k
        assert all(np.isfinite(v) for v in report[k].values())
        assert all(0.0 <= report[k][m] <= 100.0 for m in report[k]
                   if "mAP" in m)
    for arm in ("labonly", "ssl"):
        curve = report[f"curve_{arm}"]
        assert [it for it, _ in curve] == [1, 2]
        assert all(np.isfinite(loss) for _, loss in curve)
        assert report["run"][arm]["iterations_run"] == ITERS
    assert report["iters"] == ITERS
    assert report["score_thresh_3d"] == report["score_thr_2d"] == 0.01
    assert report["run"]["learning_check"] == ("PASSED" if ok else "FAILED")


def test_study_rerun_resumes_and_reuses_evals(cpu_study, tree):
    _, (first, _), (second, _) = cpu_study
    for arm in ("labonly", "ssl"):
        assert second["run"][arm]["iterations_run"] == 0
        assert second[f"curve_{arm}"] == first[f"curve_{arm}"]
        ckpt = os.path.join(tree["root"], f"run_{arm}", "ckpt")
        assert sorted(os.listdir(ckpt)) == [f"ckpt_{i}" for i in (1, 2)]
    for k in ("ap_init", "ap_labonly", "ap_ssl"):
        assert second[k] == first[k], k
    with open(os.path.join(tree["root"], "evals.json")) as f:
        cached = json.load(f)
    assert set(cached) == {ls.eval_cache_key(k) for k in (
        "init", f"labonly@{ITERS}", f"ssl@{ITERS}")}
    assert ls.eval_cache_key("init") == "init@f0.01/0.01r1"


def test_main_refuses_the_jax_record_and_a_missing_card(monkeypatch):
    with pytest.raises(SystemExit, match="JAX package's record"):
        ls.main(["--device", "cpu", "--out", JAX_RECORD])
    with pytest.raises(SystemExit, match="--arm needs --data-root"):
        ls.main(["--device", "cpu", "--arm", "ssl"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        ls.main([])


def test_quartiles_and_spike():
    curve = [(75, 7.0), (150, 2.5), (225, 14.0), (300, 1.5), (375, 1.0),
             (450, 1.2), (525, 1.1), (600, 0.9)]
    assert ls.quartile_means(curve) == (4.75, 1.0)
    spike = ls.largest_spike(curve)
    assert spike["iter"] == 225 and spike["loss"] == 14.0
    assert spike["over_median"] == pytest.approx(14.0 / 1.35)
    assert ls.largest_spike(curve[:1]) is None
