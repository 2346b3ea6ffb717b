"""The port's result and checkpoint tools (``detmatch_tpu_torch/tools/
misc/``, ``tools/model_converters/publish_model.py``) on the CPU.

* ``fuse_conv_bn``: on the same arrays (numpy draws in the JAX models'
  shapes, the tiny PV-RCNN of ``utils/tiny.py`` and the tiny CaDDN of
  ``tests/test_caddn.py``), the port's fold of the converted state dict
  equals the conversion of JAX's ``fuse_tree`` fold exactly, pair for
  pair; ``detect`` with the folded weights equals ``detect`` with the
  unfolded ones (dense outputs within 2e-3 of their largest magnitude,
  ``DENSE_TOL``; detections within 1e-5 and the same kept set); the CLI
  folds a checkpoint.
* ``publish_model``: the optimizer state dropped, the hash stable across
  runs and over a reloaded copy, changed by any tensor's change.
* ``print_config``: JAX's ``Config.dump`` text.
* ``visualize_results`` (a KITTI submission directory and a pickle) and
  ``browse_dataset``: their PNGs, on ``tests/kitti_fixture.py``'s tree.
"""
import copy
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from detmatch_tpu.config import Config as JConfig  # noqa: E402
from detmatch_tpu.models.pvrcnn import caddn as jc  # noqa: E402
from detmatch_tpu.models.pvrcnn.pvrcnn import PVRCNN as JPVRCNN  # noqa: E402
from detmatch_tpu.ops import voxelize as jvox  # noqa: E402
from detmatch_tpu_torch.apis.build import build_detector  # noqa: E402
from detmatch_tpu_torch.apis.inference import detect  # noqa: E402
from detmatch_tpu_torch.convert import (  # noqa: E402
    from_jax_caddn, from_jax_pvrcnn)
from detmatch_tpu_torch.eval.kitti_format import (  # noqa: E402
    write_submission)
from detmatch_tpu_torch.ops.voxelize import (  # noqa: E402
    VoxelizerSpec, voxelize_mean)
from detmatch_tpu_torch.tools import create_data  # noqa: E402
from detmatch_tpu_torch.tools.misc import (  # noqa: E402
    browse_dataset, fuse_conv_bn, print_config, visualize_results)
from detmatch_tpu_torch.tools.model_converters import (  # noqa: E402
    publish_model)
from detmatch_tpu_torch.train import checkpoints  # noqa: E402
from detmatch_tpu_torch.utils import tiny  # noqa: E402
from detmatch_tpu_torch.utils.visualize import read_png  # noqa: E402
from kitti_fixture import make_kitti  # noqa: E402
import torch_port_zoo_fixture as zf  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

TINY = os.path.join(ROOT, "configs", "tests", "ssl_tiny.py")
CADDN = dict(num_classes=3, point_cloud_range=(2.0, -8.0, -3.0, 18.0, 8.0,
                                               1.0),
             voxel_size=(0.5, 0.5, 0.5), grid_size=(32, 32, 8),
             depth_bins=16, depth_range=(2.0, 18.0), downsample=4)
# the fold moves the anchor head's logits by 6.8e-4 of their largest
# magnitude (float32 re-association where a batch norm's shift cancels its
# scaled input); JAX's own fold test allows 2e-3 on the BEV output
# (``tests/test_fuse_conv_bn.py``)
DENSE_TOL = 2e-3
DETECT_TOL = 1e-5


def jax_fuse():
    spec = importlib.util.spec_from_file_location(
        "jax_fuse_conv_bn", os.path.join(ROOT, "tools", "misc",
                                         "fuse_conv_bn.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pv_batch(b=2):
    view = tiny.tiny_view(np.random.RandomState(0), b=b, p=256)
    pts = np.asarray(view["points"])
    valid = np.asarray(view["points_valid"])
    vox = jax.vmap(lambda p, v: jvox.voxelize_mean(p, v, jvox.VoxelizerSpec(
        **tiny.TINY_SPEC)))(jnp.asarray(pts), jnp.asarray(valid))
    return pts, valid, dict(points=jnp.asarray(pts),
                            points_valid=jnp.asarray(valid),
                            voxel_features=vox["features"],
                            voxel_keys=vox["keys"],
                            gt_boxes=jnp.zeros((b, 4, 8)))


@pytest.fixture(scope="module")
def variables():
    """Numpy draws in the JAX models' shapes (no program compiled)."""
    _, _, b = pv_batch()
    pv = zf.random_variables(JPVRCNN(**tiny.TINY_PV_CFG), b, 0, ())
    cb = dict(images=jnp.zeros((1, 64, 64, 3)), lidar2cam=jnp.eye(4)[None],
              cam2img=jnp.eye(4)[None, :3])
    cd = zf.random_variables(jc.CaDDN(**CADDN), cb, 1, ())
    return dict(pv=pv, caddn=cd)


def _convert(kind, v):
    if kind == "pv":
        return from_jax_pvrcnn(v["params"], v["batch_stats"],
                               tiny.TINY_PV_CFG)
    return from_jax_caddn(v["params"], v["batch_stats"], v["frozen"], CADDN)


@pytest.mark.parametrize("kind,pairs", (("pv", 2 * 2 + 2), ("caddn", 36)))
def test_fuse_equals_jax_fold(variables, kind, pairs):
    """BEV blocks and deblocks (PV-RCNN's 2 blocks of 1 + 1 convs and 2
    deblocks; CaDDN's 3 blocks of 1 + 10 and 3 deblocks, its collapse and
    the DDN's channel_reduce); not the sparse convs, the point-wise MLPs,
    the ASPP's four convs or the frozen trunk."""
    v = jax.tree.map(np.asarray, variables[kind])
    folded = copy.deepcopy(v)
    n_jax = jax_fuse().fuse_tree(folded["params"], folded["batch_stats"])
    want, before = _convert(kind, folded), _convert(kind, v)
    got, n = fuse_conv_bn.fuse_state_dict(before)
    assert n == n_jax == pairs + (2 if kind == "caddn" else 0)
    assert got.keys() == want.keys()
    for k, t in want.items():
        np.testing.assert_array_equal(got[k].numpy(), t.numpy(), err_msg=k)
    changed = {k for k in want if not torch.equal(want[k], before[k])}
    assert len({k for k in changed if k.endswith("running_var")}) == n


def test_fused_detect_equals_unfused(variables):
    pts, valid, _ = pv_batch()
    model = build_detector({"model": {"detector_3d": tiny.TINY_PV_CFG}},
                           device="cpu")
    sd = _convert("pv", jax.tree.map(np.asarray, variables["pv"]))
    spec = VoxelizerSpec(**tiny.TINY_SPEC)
    p, v = torch.from_numpy(pts), torch.from_numpy(valid)
    outs = []
    for state in (sd, fuse_conv_bn.fuse_state_dict(sd)[0]):
        model.load_state_dict(state)
        with torch.no_grad():
            vox = voxelize_mean(p, v, spec)
            dense = model(dict(points=p, points_valid=v,
                               voxel_features=vox["features"],
                               voxel_keys=vox["keys"]))
        outs.append((dense, detect(model, p, v, spec, score_thresh=0.0)))
    (d0, det0), (d1, det1) = outs
    for k in ("batch_cls_preds", "batch_box_preds", "rcnn_cls", "rcnn_reg"):
        err = float((d1[k] - d0[k]).abs().max() / d0[k].abs().max())
        assert err <= DENSE_TOL, (k, err)
    assert torch.equal(det0["valid"], det1["valid"]) and det0["valid"].any()
    assert torch.equal(det0["labels"], det1["labels"])
    for k in ("boxes", "scores"):
        assert float((det1[k] - det0[k]).abs().max()) <= DETECT_TOL, k


def test_fuse_cli_and_publish_model(variables, tmp_path):
    """``fuse_conv_bn`` folds a checkpoint's model; ``publish_model``
    drops an SSL checkpoint's optimizer state and names its output by a
    stable content hash."""
    sd = _convert("pv", jax.tree.map(np.asarray, variables["pv"]))
    src = str(tmp_path / "ckpt")
    checkpoints.save(src, dict(model=sd), 7)
    assert fuse_conv_bn.main([src, str(tmp_path / "fused")]) == 6
    fused = checkpoints.restore(str(tmp_path / "fused"), 7)["model"]
    want, _ = fuse_conv_bn.fuse_state_dict(sd)
    assert all(torch.equal(fused[k], want[k]) for k in want)

    opt = {"exp_avg": {k: torch.zeros_like(t) for k, t in sd.items()
                       if t.is_floating_point()}}
    checkpoints.save(src, dict(state=sd, opt_state=opt,
                               rng=torch.tensor([1, 2])), 8)
    out, digest = publish_model.main([src, str(tmp_path / "pub")])
    assert out == str(tmp_path / "pub") + "-" + digest
    payload = checkpoints.restore(out, 8)
    assert set(payload) == {"state", "rng"}
    assert all(torch.equal(payload["state"][k], sd[k]) for k in sd)
    assert publish_model.tree_hash(payload) == digest
    again, digest2 = publish_model.main([src, str(tmp_path / "pub2")])
    assert digest2 == digest
    meta = open(os.path.join(out, "ckpt_8", "meta.json")).read()
    assert digest in meta and '"published": true' in meta
    changed = dict(payload, state=dict(payload["state"]))
    k = next(iter(sd))
    changed["state"][k] = changed["state"][k].clone()
    changed["state"][k].view(-1)[0] += 1
    assert publish_model.tree_hash(changed) != digest


@pytest.mark.parametrize("path", (
    TINY, os.path.join(ROOT, "configs/detmatch/001/detmatch/split_0.py")))
def test_print_config_is_jax_dump(path, capsys):
    text = print_config.main([path])
    assert text == JConfig.fromfile(path).dump()
    assert capsys.readouterr().out == text + "\n"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Three frames with infos (``tools.create_data``, no gt database)."""
    root = str(tmp_path_factory.mktemp("kitti_tools"))
    make_kitti(root, n_frames=3, n_points=2000)
    os.makedirs(os.path.join(root, "ImageSets"))
    for name in ("train", "val"):
        with open(os.path.join(root, "ImageSets", f"{name}.txt"), "w") as f:
            f.write("000000\n000001\n000002\n")
    create_data.main(["kitti", "--root", root, "--skip-gt-db",
                      "--skip-reduced"])
    return root


def _opts(root, keys):
    info = os.path.join(root, "kitti_infos_val.pkl")
    return sum(([f"{k}.data_root={root}", f"{k}.ann_file={info}"]
                for k in keys), [])


def test_visualize_results(tree, tmp_path):
    """A submission directory (two frames have results) and the same
    detections pickled give the same pictures."""
    with open(os.path.join(tree, "kitti_infos_val.pkl"), "rb") as f:
        infos = pickle.load(f)
    boxes = np.array([[10.0, 1.0, -1.0, 3.9, 1.6, 1.56, 0.3]], np.float32)
    dets = [dict(boxes3d=boxes, scores=np.array([0.9], np.float32),
                 labels=np.array([0], np.int32),
                 bbox=np.array([[500, 150, 600, 220]], np.float32))
            for _ in infos[:2]]
    sub = str(tmp_path / "sub")
    write_submission(dets, infos[:2], sub)
    opts = _opts(tree, ["data.val"])
    outs = []
    for i, res in enumerate((sub, None)):
        if res is None:
            res = str(tmp_path / "res.pkl")
            with open(res, "wb") as f:
                pickle.dump(visualize_results.load_results(sub, infos), f)
        paths = visualize_results.main([
            TINY, "--results", res, "--out-dir", str(tmp_path / f"vis{i}"),
            "--cfg-options"] + opts)
        outs.append([read_png(p) for p in paths])
    assert len(outs[0]) == 6
    assert [im.shape for im in outs[0]] == [(375, 1242, 3), (800, 704, 3)] * 3
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    green = [(im == (0, 255, 0)).all(-1).any() for im in outs[0][1::2]]
    assert green == [True, True, False]  # the box, on frames 0 and 1


def test_browse_dataset(tree, tmp_path):
    paths = browse_dataset.main([
        TINY, "--out-dir", str(tmp_path / "browse"), "--n", "2",
        "--cfg-options"] + _opts(tree, ["data.train_lab.dataset"]))
    shapes = [read_png(p).shape for p in paths]
    assert len(shapes) == 4 and shapes[0] == (800, 704, 3)
    assert shapes[1][2] == 3 and shapes[1][:2] != (800, 704)
