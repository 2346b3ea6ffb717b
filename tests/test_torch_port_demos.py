"""The port's three demos (``detmatch_tpu_torch/demo/``) on the CPU
(``--device cpu``), one frame of ``tests/kitti_fixture.py``'s tree each:
``main(argv)`` writes its PNG, and its detections equal the port's own
API on the same weights and inputs (``apis.inference.detect``, the
Faster R-CNN's ``simple_test``, CaDDN's forward with
``second_post_processing``): boxes and scores within 1e-6, labels and the
kept set exactly. Weights are the models' own seeded initialisers with
their batch-norm statistics drawn around them, saved as the port's
checkpoints.
"""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from detmatch_tpu_torch.apis.build import (  # noqa: E402
    build_detector, build_ssl, build_voxelizer)
from detmatch_tpu_torch.apis.inference import detect  # noqa: E402
from detmatch_tpu_torch.config import Config  # noqa: E402
from detmatch_tpu_torch.data import kitti  # noqa: E402
from detmatch_tpu_torch.data.pipelines import load_bgr  # noqa: E402
from detmatch_tpu_torch.demo import (  # noqa: E402
    mono_demo, multi_modality_demo, pcd_demo, point_batch)
from detmatch_tpu_torch.models.pvrcnn.second import (  # noqa: E402
    second_post_processing)
from detmatch_tpu_torch.train import checkpoints  # noqa: E402
from detmatch_tpu_torch.utils.visualize import (  # noqa: E402
    CAFFE_MEAN, read_png, write_png)
from PIL import Image  # noqa: E402
from kitti_fixture import make_kitti  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

TINY = os.path.join(ROOT, "configs", "tests", "ssl_tiny.py")
MONO = dict(num_classes=3, point_cloud_range=(2.0, -8.0, -3.0, 18.0, 8.0,
                                              1.0),
            voxel_size=(1.0, 1.0, 0.5), grid_size=(16, 16, 8),
            depth_bins=16, depth_range=(2.0, 18.0), downsample=4)
TOL = 1e-6


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    """One frame's point cloud, image and calibration paths."""
    root = str(tmp_path_factory.mktemp("kitti_demo"))
    make_kitti(root, n_frames=1, n_points=3000)
    sub = os.path.join(root, "training")
    return {k: os.path.join(sub, d, f"000000.{ext}") for k, d, ext in (
        ("pts", "velodyne", "bin"), ("img", "image_2", "png"),
        ("calib", "calib", "txt"))}


def randomize_bn(model, seed):
    """Running statistics drawn around the initialisers' (mean 0.1 N,
    var 0.5 + U) so the eval forward is not the identity on them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(0.1 * torch.randn(
                    m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(
                    m.running_var.shape, generator=g))
    return model


def save(tmp_path, name, payload):
    path = str(tmp_path / name)
    checkpoints.save(path, payload, 1)
    return path


def same(got, want, keys):
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_pcd_demo(frame, tmp_path):
    torch.manual_seed(0)
    cfg = Config.fromfile(TINY)
    model = randomize_bn(build_detector(cfg, device="cpu"), 1)
    ckpt = save(tmp_path, "pre", dict(model=model.state_dict()))
    out = str(tmp_path / "pcd.png")
    res = pcd_demo.main([TINY, ckpt, "--pts", frame["pts"], "--calib",
                         frame["calib"], "--out", out, "--score-thr", "0.0",
                         "--device", "cpu"])
    _, p, v = point_batch(frame["pts"], "cpu")
    det = detect(model, p, v, build_voxelizer(cfg))
    keep = det["valid"][0] & (det["scores"][0] > 0.0)
    same(res, {k: det[k][0][keep].numpy() for k in res},
         ("boxes", "scores", "labels"))
    assert len(res["boxes"]) > 0
    assert read_png(out).shape == (800, 704, 3)


def test_multi_modality_demo(frame, tmp_path):
    """The student branch: the 3D detections against ``detect``, the 2D
    against ``simple_test`` on JAX's caffe canvas (the image scaled by
    min(64 / 375, 128 / 1242), the BGR mean subtracted, zero padding)."""
    torch.manual_seed(0)
    cfg = Config.fromfile(TINY)
    ssl = build_ssl(cfg, device="cpu")
    randomize_bn(ssl.student, 2)
    ckpt = save(tmp_path, "ssl", dict(state=ssl.state_dict()))
    out = str(tmp_path / "mm.png")
    res = multi_modality_demo.main([
        TINY, ckpt, "--pts", frame["pts"], "--img", frame["img"], "--calib",
        frame["calib"], "--out", out, "--score-thr", "0.0", "--branch",
        "student", "--device", "cpu"])
    branch = ssl.student
    _, p, v = point_batch(frame["pts"], "cpu")
    det = detect(branch["det3d"], p, v, build_voxelizer(cfg))
    keep = det["valid"][0] & (det["scores"][0] > 0.0)
    same(res, dict(boxes3d=det["boxes"][0][keep].numpy(),
                   scores3d=det["scores"][0][keep].numpy()),
         ("boxes3d", "scores3d"))
    img = load_bgr(frame["img"])
    canvas, shape, s = multi_modality_demo.caffe_canvas(img, (64, 128))
    assert s == min(64 / 375, 128 / 1242)
    nh, nw = int(375 * s), int(1242 * s)
    assert tuple(shape[0]) == (nh, nw) and canvas.shape == (1, 3, 64, 128)
    np.testing.assert_array_equal(canvas[0, :, nh:], 0)
    np.testing.assert_array_equal(canvas[0, :, :, nw:], 0)
    with torch.inference_mode():
        r2 = branch["det2d"].simple_test(torch.from_numpy(canvas),
                                         torch.from_numpy(shape),
                                         score_thr=0.0)
    k2 = r2["valid"][0] & (r2["scores"][0] > 0.0)
    same(res, dict(boxes2d=r2["boxes"][0][k2].numpy() / s,
                   scores2d=r2["scores"][0][k2].numpy(),
                   labels2d=r2["labels"][0][k2].numpy()),
         ("boxes2d", "scores2d", "labels2d"))
    assert len(res["boxes3d"]) > 0 and len(res["boxes2d"]) > 0
    assert read_png(out).shape == (800, 1242 + 704, 3)


def test_mono_demo(frame, tmp_path):
    """CaDDN on the image in caffe BGR (mean subtracted) with the
    frame's ``R0 @ Tr_velo_to_cam`` and ``P2``; the image is the frame's
    128 x 400 crop around the principal point (P2's moved with it), so
    the CPU's ResNet-50 runs in seconds."""
    torch.manual_seed(0)
    with Image.open(frame["img"]) as im:
        img = np.asarray(im.convert("RGB"))[116:244, 404:804]
    with open(frame["calib"]) as f:
        text = f.read()
    frame = dict(frame, img=str(tmp_path / "crop.png"),
                 calib=str(tmp_path / "crop.txt"))
    write_png(frame["img"], img)
    with open(frame["calib"], "w") as f:
        f.write(text.replace("P2: 707.0 0.0 604.0 45.75 0.0 707.0 180.0",
                             "P2: 707.0 0.0 200.0 45.75 0.0 707.0 64.0"))
    cfg_path = str(tmp_path / "mono.py")
    with open(cfg_path, "w") as f:
        f.write(f"model = dict(detector_mono={MONO!r})\n")
    model = randomize_bn(build_detector(
        Config.fromfile(cfg_path), device="cpu", key="detector_mono"), 3)
    ckpt = save(tmp_path, "mono", dict(model=model.state_dict()))
    out = str(tmp_path / "mono.png")
    res = mono_demo.main([cfg_path, ckpt, "--img", frame["img"], "--calib",
                          frame["calib"], "--out", out, "--score-thr", "0.0",
                          "--device", "cpu"])
    calib = kitti.read_calib(frame["calib"])
    batch = dict(
        images=torch.from_numpy((load_bgr(frame["img"]) - CAFFE_MEAN)[None]),
        lidar2cam=torch.from_numpy(calib.R0 @ calib.V2C)[None],
        cam2img=torch.from_numpy(calib.P2[:3].copy())[None])
    with torch.inference_mode():
        post = second_post_processing(model(batch), score_thresh=0.0)
    keep = post["valid"][0]
    same(res, {k: post[k][0][keep].numpy() for k in res},
         ("boxes", "scores", "labels"))
    assert len(res["boxes"]) > 0
    assert read_png(out).shape == (800, 704, 3)
