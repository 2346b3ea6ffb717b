"""Tiny DetMatch fixtures for the CPU tests (a numpy-only copy of
``detmatch_tpu/utils/tiny.py``): the smallest PV-RCNN and Faster R-CNN
configs that still run every branch of the teacher phase, and one
synthetic multimodal view (with ground truth for a labeled view). The
same ``rng`` gives the same view, array for array, as the JAX package's
``tiny_view``."""
from __future__ import annotations

import numpy as np

TINY_PCR = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
TINY_CANVAS = (64, 128)

TINY_PV_CFG = dict(
    num_classes=3, point_cloud_range=TINY_PCR, voxel_size=(0.5, 0.5, 0.1),
    grid_size=(32, 32, 40), num_keypoints=32,
    backbone_caps=(384, 384, 256, 256),
    train_nms=dict(nms_pre=128, nms_post=24, nms_thresh=0.8),
    test_nms=dict(nms_pre=128, nms_post=12, nms_thresh=0.7),
    backbone3d_cfg=dict(channels=(8, 8, 16, 16, 16), out_channels=32),
    bev_cfg=dict(layer_nums=(1, 1), num_filters=(32, 64),
                 num_upsample_filters=(32, 32)),
    roi_head_cfg=dict(
        grid_size=3, pool_nsamples=(4, 4), pool_mlps=((16, 16), (16, 16)),
        shared_fc=(32, 32), cls_fc=(32, 32), reg_fc=(32, 32),
        target_cfg=dict(roi_per_image=16, fg_ratio=0.5, reg_fg_thresh=0.55,
                        cls_fg_thresh=0.75, cls_bg_thresh=0.25,
                        cls_bg_thresh_lo=0.1, hard_bg_ratio=0.8)))
TINY_FR_CFG = dict(canvas=TINY_CANVAS, train_rpn_nms_pre=96,
                   train_rpn_max=48, test_rpn_nms_pre=96, test_rpn_max=24,
                   rcnn_num_samples=24,
                   backbone_cfg=dict(stage_blocks=(1, 1, 1, 1)))
# keyword arguments of ops.voxelize.VoxelizerSpec
TINY_SPEC = dict(point_cloud_range=TINY_PCR, voxel_size=(0.5, 0.5, 0.1),
                 max_voxels=384, max_points=5)


def tiny_view(rng, b=1, p=256, with_gt=False):
    """One synthetic view as numpy arrays: points, image (B, H, W, 3),
    calibration and identity augmentation records (``aug3d`` / ``aug2d``
    dicts of the ``Aug3D`` / ``Aug2D`` fields); with ``with_gt`` also
    6-slot ground truth (3 valid): ``gt_boxes`` (B, 6, 8), ``gt_boxes2d``,
    ``gt_labels2d`` (0-based) and ``gt2d_valid``."""
    pts = np.stack([
        rng.rand(b, p) * 15 + 0.5, rng.rand(b, p) * 15 - 7.5,
        rng.rand(b, p) * 3.5 - 2.8, rng.rand(b, p)], axis=-1
    ).astype(np.float32)
    canvas = TINY_CANVAS
    view = dict(
        points=pts,
        points_valid=np.ones((b, p), bool),
        img=rng.randn(b, *canvas, 3).astype(np.float32),
        img_shape=np.tile([[canvas[0], canvas[1]]], (b, 1)
                          ).astype(np.float32),
        ori_shape=np.tile([[375.0, 1242.0]], (b, 1)).astype(np.float32),
        lidar2img=np.tile(np.array(
            [[[0, -700, 0, 620 * 10],
              [0, 0, -700, 180 * 10],
              [1, 0, 0, 0],
              [0, 0, 0, 1]]], np.float32), (b, 1, 1)),
        aug3d=dict(flip_x=np.zeros((b,), np.float32),
                   rot=np.zeros((b,), np.float32),
                   scale=np.ones((b,), np.float32),
                   trans=np.zeros((b, 3), np.float32)),
        aug2d=dict(scale=np.ones((b, 4), np.float32),
                   flip=np.zeros((b,), np.float32),
                   img_w=np.full((b,), float(canvas[1]), np.float32)),
    )
    if with_gt:
        g = 6
        gt = np.zeros((b, g, 8), np.float32)
        gt[:, :3, 0] = rng.rand(b, 3) * 12 + 2
        gt[:, :3, 1] = rng.rand(b, 3) * 10 - 5
        gt[:, :3, 2] = -1.0
        gt[:, :3, 3:6] = [3.9, 1.6, 1.56]
        gt[:, :3, 6] = rng.rand(b, 3) - 0.5
        gt[:, :3, 7] = rng.randint(1, 4, (b, 3))
        g2 = np.zeros((b, g, 4), np.float32)
        g2[:, :3, :2] = rng.rand(b, 3, 2) * 60
        g2[:, :3, 2:] = g2[:, :3, :2] + 20
        view.update(gt_boxes=gt, gt_boxes2d=g2,
                    gt_labels2d=rng.randint(0, 3, (b, g)).astype(np.int32),
                    gt2d_valid=np.arange(g)[None, :].repeat(b, 0) < 3)
    return view


def tiny_ssl_batch(rng, b=1, p=256):
    """A full SSL batch: labeled (student view with gt) and unlabeled,
    student and teacher views (the JAX ``tiny_ssl_batch``)."""
    return dict(lab=dict(stu=tiny_view(rng, b, p, with_gt=True),
                         tea=tiny_view(rng, b, p)),
                unlab=dict(stu=tiny_view(rng, b, p), tea=tiny_view(rng, b, p)))
