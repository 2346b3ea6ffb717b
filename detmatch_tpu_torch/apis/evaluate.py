"""Evaluation: run detectors over a val dataset and compute KITTI AP
(counterpart of ``detmatch_tpu/apis/evaluate.py``).

Mirrors the reference flow (``apis/test.py`` → ``KittiDataset.evaluate``
fanout ``kitti_dataset.py:320-372``): for an SSL detector the metrics fan
out over {teacher, student} × {2d, 3d} with prefixed keys. The models run
on the device they live on, in eval mode (each model's mode is restored
afterwards); the datasets and the AP sweep are host numpy, the rotated
overlaps run on the model's device.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Dict

import numpy as np
import torch

from ..data import kitti
from ..data import np_geometry as geometry
from ..data.loader import epoch_batches
from ..eval.kitti_eval import kitti_eval
from .inference import detect


def _gt_annos_from_dataset(ds: kitti.KittiDataset):
    out = []
    for info in ds.infos:
        annos = info["annos"]
        calib = kitti.calib_from_info(info)
        boxes, _, _ = kitti.annos_to_lidar_boxes(annos, calib)
        n_all = len(annos["name"])
        boxes_full = np.zeros((n_all, 7), np.float32)
        boxes_full[:len(boxes)] = boxes  # DontCare rows (excluded) zeroed
        out.append(dict(name=annos["name"], bbox=annos["bbox"],
                        occluded=annos["occluded"],
                        truncated=annos["truncated"],
                        alpha=annos["alpha"], boxes3d=boxes_full))
    return out


@contextlib.contextmanager
def _eval_mode(model):
    was_training = model.training
    model.eval()
    try:
        yield next(model.parameters()).device
    finally:
        model.train(was_training)


def _warn_if_no_dets(det_annos, tag, floor):
    """Self-report the score-floor trap: a floor above the model's score
    range hard-zeroes AP by truncating the PR curve."""
    if det_annos and not any(len(d["scores"]) for d in det_annos):
        logging.warning(
            "eval[%s]: ZERO detections survived the score floor %.3g on "
            "all %d images — AP will be exactly 0. If the model is weak/"
            "early-training, lower the floor (score_thresh/score_thr).",
            tag, floor, len(det_annos))


def eval_pvrcnn(model, ds, collate_fn, vox_spec, batch_size=2, max_dets=100,
                score_thresh=0.1):
    """3D eval of a PV-RCNN: ``apis.inference.detect`` on each batch, the
    2D boxes from the 3D boxes' projection, then bbox, bev and 3d AP and
    AOS.

    ``score_thresh`` is the pre-NMS confidence floor (reference default
    0.1, ``detector3d_template.py:176-309``); AP sweeps thresholds over
    the surviving detections, so a floor above the model's score range
    truncates the PR curve to AP=0 — pass a low value when evaluating
    small or early-training models.
    Returns (the AP dict, the per-image det annos).
    """
    det_annos = []
    with _eval_mode(model) as device:
        for batch_np, true in epoch_batches(ds, batch_size, collate_fn):
            post = detect(model,
                          torch.from_numpy(batch_np["points"]).to(device),
                          torch.from_numpy(batch_np["points_valid"]).to(
                              device), vox_spec, score_thresh=score_thresh)
            post = {k: v.cpu().numpy() for k, v in post.items()}
            for i in range(true):
                v = post["valid"][i]
                boxes = post["boxes"][i][v][:max_dets]
                bb2d, _ = geometry.boxes_3d_to_2d(
                    boxes, batch_np["lidar2img"][i],
                    img_shape=batch_np["ori_shape"][i])
                calib = kitti.calib_from_info(ds.infos[len(det_annos)])
                cam = geometry.boxes_lidar_to_camera(
                    boxes, calib.lidar_to_rect) if len(boxes) else \
                    np.zeros((0, 7), np.float32)
                # observation angle (reference bbox2result_kitti,
                # kitti_dataset.py:500-501)
                alpha = (-np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6]
                         ).astype(np.float32)
                det_annos.append(dict(
                    labels=(post["labels"][i][v][:max_dets] - 1
                            ).astype(np.int32),
                    scores=post["scores"][i][v][:max_dets],
                    bbox=np.asarray(bb2d), boxes3d=boxes, alpha=alpha))
    gt_annos = _gt_annos_from_dataset(ds)
    _warn_if_no_dets(det_annos, "3d", score_thresh)
    res = kitti_eval(gt_annos, det_annos, metrics=("bbox", "bev", "3d"),
                     compute_aos=True, device=device)
    return res, det_annos


def eval_frcnn(model, ds, collate_fn, batch_size=2, score_thr=0.05):
    """2D eval of a Faster R-CNN: ``simple_test`` on each batch, the boxes
    mapped back to the original image by the recorded 2D scale, then bbox
    AP. ``score_thr`` as in :func:`eval_pvrcnn` (mmdet's simple-test
    default 0.05). Returns (the AP dict, the per-image det annos)."""
    det_annos = []
    with _eval_mode(model) as device, torch.inference_mode():
        for batch_np, true in epoch_batches(ds, batch_size, collate_fn):
            img = torch.from_numpy(batch_np["img"]).to(device)
            res = model.simple_test(
                img.permute(0, 3, 1, 2).contiguous(),
                torch.from_numpy(batch_np["img_shape"]).to(device),
                score_thr=score_thr)
            res = {k: v.cpu().numpy() for k, v in res.items()}
            for i in range(true):
                v = res["valid"][i]
                sf = batch_np["aug2d"]["scale"][i]
                det_annos.append(dict(
                    labels=res["labels"][i][v].astype(np.int32),
                    scores=res["scores"][i][v],
                    bbox=res["boxes"][i][v] / sf[None],
                    boxes3d=np.zeros((int(v.sum()), 7), np.float32)))
    gt_annos = _gt_annos_from_dataset(ds)
    _warn_if_no_dets(det_annos, "2d", score_thr)
    res = kitti_eval(gt_annos, det_annos, metrics=("bbox",), device=device)
    return res, det_annos


def eval_ssl(ssl, ds, collate_fn, vox_spec, batch_size=2,
             score_thresh_3d=0.1, score_thr_2d=0.05, return_dets=False):
    """SSL fanout: {tea, stu} × {3d, 2d} prefixed metrics
    (reference ``kitti_dataset.py:320-372``), plus
    ``<branch>.<dim>.num_dets`` (mean detections per image), so an AP of
    0 is diagnosable (no detections against bad localization). With
    ``return_dets`` also returns {'tea.3d': [...], ...}, the per-image det
    annos (for ``eval.kitti_format.write_submission``)."""
    out: Dict[str, float] = {}
    dets: Dict[str, list] = {}
    for branch in ("teacher", "student"):
        half = getattr(ssl, branch)
        res3, det3 = eval_pvrcnn(half["det3d"], ds, collate_fn, vox_spec,
                                 batch_size, score_thresh=score_thresh_3d)
        out.update({f"{branch[:3]}.3d.{k}": v for k, v in res3.items()})
        out[f"{branch[:3]}.3d.num_dets"] = float(
            np.mean([len(d["scores"]) for d in det3]))
        dets[f"{branch[:3]}.3d"] = det3
        res2, det2 = eval_frcnn(half["det2d"], ds, collate_fn, batch_size,
                                score_thr=score_thr_2d)
        out.update({f"{branch[:3]}.2d.{k}": v for k, v in res2.items()})
        out[f"{branch[:3]}.2d.num_dets"] = float(
            np.mean([len(d["scores"]) for d in det2]))
        dets[f"{branch[:3]}.2d"] = det2
    return (out, dets) if return_dets else out


def recalibrate_batch_stats(model, batches, generator=None, passes=300):
    """Refresh a PV-RCNN's batch-norm running statistics with frozen
    parameters: ``passes`` train-mode forwards without gradients, cycling
    through ``batches`` (voxelized batches on the model's device, as
    ``apis.train_pretrain.to_device_batch`` makes them).

    With the reference's BN momentum 0.01 the running estimate is an
    exponential average with a ~100-iteration window, so a checkpoint
    whose last training phase was short evaluates with stale statistics;
    the reference sidesteps this by pretraining 30k-60k iterations, and
    for short runs an explicit recalibration is the standard remedy.
    ``generator`` (default: seeded with 0 on the model's device) feeds the
    forward's RoI sampling and dropout. Returns the model, in the mode it
    came in.
    """
    was_training = model.training
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    batches = list(batches)
    model.train()
    try:
        with torch.no_grad():
            for k in range(passes):
                model(batches[k % len(batches)], train=True,
                      generator=generator)
    finally:
        model.train(was_training)
    return model
