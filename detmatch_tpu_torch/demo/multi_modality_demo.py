"""Multi-modality inference demo (counterpart of
``demo/multi_modality_demo.py``): an SSL (3D + 2D) checkpoint on one KITTI
frame, points and image → the image with the 3D detections projected
(green) and the 2D detections drawn, beside a BEV picture of the 3D
boxes.

Usage:
    python -m detmatch_tpu_torch.demo.multi_modality_demo CONFIG CKPT_DIR
        --pts x.bin --img x.png --calib x.txt [--out demo_mm.png]
        [--score-thr 0.3] [--branch teacher|student] [--device cuda|cpu]

The image goes onto the Faster R-CNN's canvas as JAX's demo puts it:
resized by min(canvas_h / h, canvas_w / w) (``cv2.resize``, bilinear),
caffe mean subtracted in BGR, zero padding right and below. ``main``
returns the detections kept: ``boxes3d`` (M, 7), ``scores3d``,
``boxes2d`` (K, 4) in the original image's pixels, ``scores2d``,
``labels2d``, numpy.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data.pipelines import load_bgr
from ..utils.visualize import CAFFE_MEAN
from . import point_batch


def caffe_canvas(img_bgr, canvas):
    """(H, W, 3) float BGR → ((1, 3, ch, cw) canvas, (1, 2) img_shape
    (nh, nw), scale s), JAX's ``multi_modality_demo.py:65-73``."""
    import cv2
    ch, cw = canvas
    s = min(ch / img_bgr.shape[0], cw / img_bgr.shape[1])
    nh, nw = int(img_bgr.shape[0] * s), int(img_bgr.shape[1] * s)
    resized = cv2.resize(img_bgr, (nw, nh))
    out = np.zeros((1, ch, cw, 3), np.float32)
    out[0, :nh, :nw] = resized - CAFFE_MEAN[None, None]
    return (out.transpose(0, 3, 1, 2), np.array([[nh, nw]], np.float32), s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("checkpoint")
    ap.add_argument("--pts", required=True)
    ap.add_argument("--img", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--out", default="demo_mm.png")
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--branch", default="teacher",
                    choices=("teacher", "student"))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the models (default cuda)")
    args = ap.parse_args(argv)

    import torch
    from ..apis.build import build_ssl, build_voxelizer
    from ..apis.inference import detect
    from ..config import Config
    from ..data import kitti
    from ..data.np_geometry import boxes_3d_to_2d
    from ..train.checkpoints import restore_latest
    from ..utils.visualize import bev_canvas, draw_boxes_2d, write_png_bgr

    cfg = Config.fromfile(args.config)
    ssl = build_ssl(cfg, device=args.device)
    ssl.load_state_dict(restore_latest(args.checkpoint)[0]["state"])
    branch = getattr(ssl, args.branch)
    calib = kitti.read_calib(args.calib)
    pts, p, v = point_batch(args.pts, args.device)
    det = detect(branch["det3d"], p, v, build_voxelizer(cfg))
    keep = det["valid"][0] & (det["scores"][0] > args.score_thr)
    boxes3d = det["boxes"][0][keep].cpu().numpy()

    img = load_bgr(args.img)
    canvas, img_shape, s = caffe_canvas(img, branch["det2d"].canvas)
    with torch.inference_mode():
        res2d = branch["det2d"].simple_test(
            torch.from_numpy(canvas).to(args.device),
            torch.from_numpy(img_shape).to(args.device),
            score_thr=args.score_thr)
    k2 = res2d["valid"][0] & (res2d["scores"][0] > args.score_thr)
    out = dict(boxes3d=boxes3d, scores3d=det["scores"][0][keep].cpu().numpy(),
               boxes2d=res2d["boxes"][0][k2].cpu().numpy() / s,
               scores2d=res2d["scores"][0][k2].cpu().numpy(),
               labels2d=res2d["labels"][0][k2].cpu().numpy())
    print(f"3D: {len(boxes3d)} dets, 2D: {len(out['boxes2d'])} dets "
          f"above {args.score_thr}")

    vis = img.astype(np.uint8)
    if len(boxes3d):
        bb, ok = boxes_3d_to_2d(boxes3d, calib.lidar2img,
                                img_shape=np.array(vis.shape[:2], np.float32))
        vis = draw_boxes_2d(vis, np.asarray(bb), valid=np.asarray(ok))
    vis = draw_boxes_2d(vis, out["boxes2d"], labels=out["labels2d"],
                        scores=out["scores2d"])
    bev = bev_canvas(pts, [(boxes3d, None)],
                     point_cloud_range=cfg["voxelizer"]["point_cloud_range"])
    h = max(vis.shape[0], bev.shape[0])

    def pad(im):
        return np.pad(im, ((0, h - im.shape[0]), (0, 0), (0, 0)))

    write_png_bgr(args.out, np.concatenate([pad(vis), pad(bev)], axis=1))
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
