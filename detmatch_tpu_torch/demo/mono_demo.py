"""Monocular 3D detection demo (counterpart of ``demo/mono_demo.py``): a
CaDDN checkpoint on one image and its calibration → a BEV picture of the
predicted 3D boxes.

Usage:
    python -m detmatch_tpu_torch.demo.mono_demo CONFIG CKPT_DIR --img x.png
        --calib x.txt [--out demo_mono.png] [--score-thr 0.3]
        [--device cuda|cpu]

CONFIG defines ``model.detector_mono`` (CaDDN keywords; a CaDDN at JAX's
defaults if it holds none, ``configs/caddn/caddn_kitti.py``). CaDDN
takes the image in caffe BGR, the mean subtracted (its batch contract,
``models/pvrcnn/caddn.py``); JAX's demo feeds RGB without the mean
subtraction, which its model's docstring does not ask for. ``main``
returns the detections kept (boxes (M, 7), scores, labels), numpy.
"""
from __future__ import annotations

import argparse

from ..data.pipelines import load_bgr
from ..utils.visualize import CAFFE_MEAN


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("checkpoint")
    ap.add_argument("--img", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--out", default="demo_mono.png")
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from ..apis.build import build_detector
    from ..config import Config
    from ..data import kitti
    from ..models.pvrcnn.second import second_post_processing
    from ..train.checkpoints import restore_latest
    from ..utils.visualize import bev_canvas, write_png_bgr

    cfg = Config.fromfile(args.config)
    model = build_detector(cfg, device=args.device, key="detector_mono")
    model.load_state_dict(restore_latest(args.checkpoint)[0]["model"])
    calib = kitti.read_calib(args.calib)
    img = load_bgr(args.img) - CAFFE_MEAN
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[None])).to(
        args.device) for k, v in (("images", img),
                                  ("lidar2cam", calib.R0 @ calib.V2C),
                                  ("cam2img", calib.P2[:3]))}
    with torch.inference_mode():
        post = second_post_processing(model(batch),
                                      score_thresh=args.score_thr)
    keep = post["valid"][0]
    res = {k: post[k][0][keep].cpu().numpy()
           for k in ("boxes", "scores", "labels")}
    print(f"{int(keep.sum())} detections above {args.score_thr}")
    write_png_bgr(args.out, bev_canvas(np.zeros((0, 4), np.float32),
                                   [(res["boxes"], None)],
                                   point_cloud_range=model.point_cloud_range))
    print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
