"""CPU parity of the port's evaluation layer (``detmatch_tpu_torch/eval``:
``kitti_eval``, ``kitti_format``; ``native``; ``apis/evaluate.py``)
against the JAX package, and ``eval_ssl`` and ``recalibrate_batch_stats``
at the tiny size.

The rotated overlaps (bev, 3d) are the port's torch IoU where JAX runs
its jnp kernel. They are held to JAX's kernel run op by op
(``jax.disable_jit``): its arithmetic is the port's, and the two differ
only by the last bits of the trig functions, which the shoelace sum
amplifies. The shoelace works on absolute coordinates (products near
40 m x 10 m), so float32 cancellation moves a pedestrian's IoU by up to
~4e-4 between JAX's jitted program (fused multiply-adds) and JAX op by
op; no tolerance of 1e-6 holds against either on such boxes, and 1e-5
holds against the op-by-op run.

Everything after the overlaps is the same numpy and C code, so the APs
must be equal: the port's sweep fed JAX's overlap matrices gives JAX's
APs exactly, for bbox, bev, 3d and AOS, and so does the port end to end
on these detections (no IoU lies within the jitter of a threshold). The
C matcher must equal the numpy sweep it replaces.
"""
import os
import pickle
import sys

import jax
import torch
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from detmatch_tpu.eval import kitti_eval as jke  # noqa: E402
from detmatch_tpu.eval import kitti_format as jkf  # noqa: E402
from detmatch_tpu_torch import native  # noqa: E402
from detmatch_tpu_torch.apis.build import (build_dataset,  # noqa: E402
                                           build_detector, build_ssl,
                                           build_voxelizer)
from detmatch_tpu_torch.apis.evaluate import (  # noqa: E402
    eval_ssl, recalibrate_batch_stats)
from detmatch_tpu_torch.apis.train_pretrain import (  # noqa: E402
    to_device_batch)
from detmatch_tpu_torch.config import Config  # noqa: E402
from detmatch_tpu_torch.data import kitti as pkitti  # noqa: E402
from detmatch_tpu_torch.data.collate import collate_view  # noqa: E402
from detmatch_tpu_torch.eval import kitti_eval as pke  # noqa: E402
from detmatch_tpu_torch.eval import kitti_format as pkf  # noqa: E402
from detmatch_tpu_torch.utils import tiny  # noqa: E402
from kitti_fixture import make_kitti_random  # noqa: E402
from torch_port_ssl_fixture import one_torch_thread  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = os.path.join(ROOT, "configs", "tests", "ssl_tiny.py")
OVERLAP_TOL = 1e-5  # against JAX op by op; see the module docstring
NAMES = ("Car", "Car", "Car", "Pedestrian", "Cyclist", "Van",
         "Person_sitting", "DontCare")


def _calib():
    from test_kitti_format import _calib as calib
    return calib(2)


def _gt(rng, calib):
    """One image's gt: cars, a pedestrian, a cyclist, their neighbour
    classes and a DontCare region, at mixed occlusion, truncation and
    2D height (every difficulty gate takes part)."""
    n = len(NAMES)
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, 0] = rng.rand(n) * 40 + 6
    boxes[:, 1] = rng.rand(n) * 24 - 12
    boxes[:, 2] = -0.9 + rng.randn(n) * 0.1
    boxes[:, 3:6] = [3.9, 1.6, 1.56]
    boxes[3:5, 3:6] = [0.8, 0.6, 1.73]
    boxes[:, 6] = rng.rand(n) * 2 * np.pi - np.pi
    x1 = rng.rand(n) * 1100
    y1 = rng.rand(n) * 150 + 100
    bbox = np.stack([x1, y1, x1 + rng.rand(n) * 90 + 20,
                     y1 + rng.rand(n) * 60 + 20], 1).astype(np.float32)
    cam = pkf.geometry.boxes_lidar_to_camera(boxes, calib.lidar_to_rect)
    alpha = -np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6]
    boxes[-1] = 0.0  # DontCare rows carry no 3D box
    return dict(name=np.array(NAMES), bbox=bbox,
                occluded=rng.randint(0, 3, n).astype(np.int32),
                truncated=(rng.rand(n) * 0.4).astype(np.float32),
                alpha=alpha.astype(np.float32), boxes3d=boxes)


def _det(rng, gt, n_fp=3):
    """Jittered copies of the non-DontCare gts (some dropped) and false
    positives, with the detections' own observation angles."""
    keep = np.flatnonzero((gt["name"] != "DontCare")
                          & (rng.rand(len(gt["name"])) < 0.85))
    m = len(keep) + n_fp
    boxes = np.zeros((m, 7), np.float32)
    boxes[:len(keep)] = gt["boxes3d"][keep] + rng.randn(
        len(keep), 7).astype(np.float32) * [0.15, 0.15, 0.05, 0.1, 0.05,
                                            0.05, 0.1]
    boxes[len(keep):] = gt["boxes3d"][rng.randint(0, 5, n_fp)] + [
        4, 3, 0, 0, 0, 0, 1]
    bbox = np.concatenate([
        gt["bbox"][keep] + rng.randn(len(keep), 4).astype(np.float32) * 3,
        gt["bbox"][rng.randint(0, 5, n_fp)] + 40], 0).astype(np.float32)
    cls = {"Car": 2, "Van": 2, "Pedestrian": 0, "Person_sitting": 0,
           "Cyclist": 1}
    labels = np.array([cls[n] for n in gt["name"][keep]]
                      + list(rng.randint(0, 3, n_fp)), np.int32)
    return dict(labels=labels, scores=rng.rand(m).astype(np.float32),
                bbox=bbox, boxes3d=boxes,
                alpha=(gt["alpha"][rng.randint(0, 5, m)]
                       + rng.randn(m).astype(np.float32) * 0.2
                       ).astype(np.float32))


@pytest.fixture(scope="module")
def annos():
    rng = np.random.RandomState(5)
    calib = _calib()
    gts = [_gt(rng, calib) for _ in range(12)]
    dets = [_det(rng, g) for g in gts]
    dets[4] = _det(rng, gts[4], n_fp=0)
    for k in dets[7]:  # one image without detections
        dets[7][k] = dets[7][k][:0]
    return gts, dets


@pytest.mark.parametrize("metric", ["bev", "3d"])
def test_overlap_matrices_match_jax(annos, metric):
    """Every per-image matrix has JAX's shape; its entries against real
    gt boxes are within 1e-5 of JAX's kernel run op by op. (The DontCare
    column is a zero-size box, whose 'IoU' is the other box's area over
    the 1e-6 floor in both packages; the evaluation never reads it.)"""
    gts, dets = annos
    ours = pke.precompute_overlaps(gts, dets, metric, device="cpu")
    with jax.disable_jit():
        theirs = jke.precompute_overlaps(gts, dets, metric)
    assert len(ours) == len(theirs) == 12 and ours[7].shape == (0, 8)
    for a, b, g in zip(ours, theirs, gts):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        real = g["name"] != "DontCare"
        np.testing.assert_allclose(a[:, real], b[:, real], rtol=0,
                                   atol=OVERLAP_TOL)
    assert max(float(a.max(initial=0)) for a in ours) > 0.5


@pytest.mark.parametrize("metric", ["bbox", "bev", "3d"])
def test_kitti_eval_equals_jax(annos, metric):
    """Every AP (and with bbox every AOS) of the port equals JAX's: on
    JAX's overlaps, and end to end on the port's own."""
    gts, dets = annos
    aos = metric == "bbox"
    want = jke.kitti_eval(gts, dets, metrics=(metric,), compute_aos=aos)
    ours = pke.kitti_eval(gts, dets, metrics=(metric,), compute_aos=aos,
                          device="cpu")
    assert ours == want
    ov = jke.precompute_overlaps(gts, dets, metric)
    for cls in pke.CLASSES:
        for d in range(3):
            assert pke.eval_class(gts, dets, cls, d, metric, overlaps=ov,
                                  compute_aos=aos) == jke.eval_class(
                gts, dets, cls, d, metric, overlaps=ov, compute_aos=aos)
    assert any(v > 0 for k, v in want.items() if k.startswith("Car_")), want
    if aos:
        assert want["mAP_aos_moderate"] > 0


def test_coco_style_equals_jax(annos):
    gts, dets = annos
    assert pke.kitti_eval_coco_style(gts, dets, device="cpu") == \
        jke.kitti_eval_coco_style(gts, dets)


@pytest.mark.parametrize("metric,aos", [("bbox", False), ("bbox", True),
                                        ("bev", False), ("3d", False)])
def test_native_sweep_equals_numpy_sweep(annos, monkeypatch, metric, aos):
    """``eval_class`` through the C matcher and through the numpy
    ``_statistics`` loop give the same AP (and AOS) for every class and
    difficulty."""
    gts, dets = annos
    assert native.get_lib() is not None
    ov = pke.precompute_overlaps(gts, dets, metric, device="cpu")
    cases = [(c, d) for c in pke.CLASSES for d in range(3)]
    with_c = [pke.eval_class(gts, dets, c, d, metric, overlaps=ov,
                             compute_aos=aos) for c, d in cases]
    monkeypatch.setattr(native, "get_lib", lambda: None)
    plain = [pke.eval_class(gts, dets, c, d, metric, overlaps=ov,
                            compute_aos=aos) for c, d in cases]
    assert with_c == plain


def test_native_library_is_built_into_build_dir():
    path = native.build()
    assert path == native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert path.name.startswith("libkitti_eval-")


def test_submission_round_trip_gives_jax_ap(annos, tmp_path):
    """internal → ``write_submission`` → ``read_kitti_txt`` →
    ``kitti_anno_to_internal``: the files equal JAX's byte for byte, the
    re-read APs equal JAX's re-read APs, and they stay within 1e-3 of the
    originals (the txt's %.4f rounding; the JAX package's bound)."""
    gts, dets = annos
    calib = _calib()
    # the file carries the observation angle of the box, so the
    # detections get theirs before the original AP is taken
    dets = [dict(d, alpha=pkf.det_to_kitti_anno(d, calib)["alpha"])
            for d in dets]
    infos = [dict(image=dict(image_idx=i, image_shape=None),
                  calib=dict(P2=calib.P2, R0_rect=calib.R0,
                             Tr_velo_to_cam=calib.V2C))
             for i in range(len(gts))]
    ours = pkf.write_submission(dets, infos, str(tmp_path / "port"))
    theirs = jkf.write_submission(dets, infos, str(tmp_path / "jax"))
    for p, j in zip(ours, theirs):
        assert open(p).read() == open(j).read()
    back = [pkf.kitti_anno_to_internal(pkf.read_kitti_txt(p), calib)
            for p in ours]
    jback = [jkf.kitti_anno_to_internal(jkf.read_kitti_txt(p), calib)
             for p in theirs]
    ap = pke.kitti_eval(gts, back, compute_aos=True, device="cpu")
    assert ap == jke.kitti_eval(gts, jback, compute_aos=True)
    orig = pke.kitti_eval(gts, dets, compute_aos=True, device="cpu")
    for k in orig:
        assert abs(orig[k] - ap[k]) < 1e-3, (k, orig[k], ap[k])
    with pytest.raises(ValueError):
        pkf.write_submission(dets[:3], infos, str(tmp_path / "short"))


def test_eval_ssl_on_a_tree(tmp_path):
    """``eval_ssl`` of the tiny SSL detector on a 4-frame val tree: the
    {tea, stu} × {3d, 2d} keys and num_dets, finite APs, the models'
    modes restored."""
    root = str(tmp_path)
    split = make_kitti_random(root, 4, seed=1)
    with open(os.path.join(root, "kitti_infos_train.pkl"), "wb") as f:
        pickle.dump(pkitti.create_infos(root, split), f)
    cfg = Config.fromfile(TINY)
    val = dict(cfg["data"]["val"], data_root=root,
               ann_file=os.path.join(root, "kitti_infos_train.pkl"))
    ssl = build_ssl(cfg, device="cpu").train()
    res = eval_ssl(ssl, build_dataset(val),
                   lambda s: collate_view(s, **cfg["data"]["collate"]),
                   build_voxelizer(cfg), score_thresh_3d=0.0,
                   score_thr_2d=0.0)
    for branch in ("tea", "stu"):
        for k in ("3d.mAP_3d_moderate", "3d.mAP_bev_moderate",
                  "3d.mAP_bbox_moderate", "3d.mAP_aos_moderate",
                  "2d.mAP_bbox_moderate", "3d.num_dets", "2d.num_dets"):
            assert np.isfinite(res[f"{branch}.{k}"]), (branch, k)
        assert res[f"{branch}.3d.num_dets"] > 0
    assert ssl.student.training and not ssl.teacher.training


def test_recalibrate_batch_stats_moves_only_the_statistics():
    """Train-mode forwards without gradients: every BN running statistic
    moves, no parameter does, and the model's mode is restored."""
    cfg = Config.fromfile(TINY)
    cfg["model"]["detector_3d"]["roi_head_cfg"] = dict(
        grid_size=2, pool_nsamples=(4, 4), pool_mlps=((8, 8), (8, 8)),
        shared_fc=(32, 32), cls_fc=(32, 32), reg_fc=(32, 32))
    model = build_detector(cfg, device="cpu")
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(2):
        v = tiny.tiny_view(rng, b=1, p=256, with_gt=True)
        batches.append(to_device_batch(
            {k: np.asarray(v[k]) for k in ("points", "points_valid",
                                            "gt_boxes")},
            build_voxelizer(cfg), "cpu"))
    params = {n: p.clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()
             if n.endswith("running_mean")}
    out = recalibrate_batch_stats(model, batches, passes=3)
    assert out is model and not model.training
    assert all(torch.equal(p, params[n]) for n, p in model.named_parameters())
    moved = [n for n, b in model.named_buffers()
             if n in stats and not torch.equal(b, stats[n])]
    assert len(moved) == len(stats) > 0
