"""Render saved detection results over a dataset (counterpart of
``tools/misc/visualize_results.py``): reads a KITTI-format submission
directory (``tools.test --out-kitti``) or a pickled list of result dicts,
draws the 2D boxes on each image and the 3D boxes on a BEV picture, and
writes ``<frame>_img.png`` and ``<frame>_bev.png``.

Usage:
    python -m detmatch_tpu_torch.tools.misc.visualize_results CONFIG
        --results DIR_OR_FILE [--out-dir vis] [--score-thr 0.3]
        [--max-frames 20] [--cfg-options k=v ...]

Returns the paths written.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def load_results(path, infos):
    """A submission directory or a pickle → one internal detection dict
    (labels, scores, bbox, boxes3d) a frame of ``infos``; a frame without
    a file has none."""
    from ...data import kitti
    from ...eval.kitti_format import kitti_anno_to_internal, read_kitti_txt
    if not os.path.isdir(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    dets = []
    for info in infos:
        p = os.path.join(path, f"{int(info['image']['image_idx']):06d}.txt")
        if os.path.exists(p):
            dets.append(kitti_anno_to_internal(read_kitti_txt(p),
                                               kitti.calib_from_info(info)))
        else:
            dets.append(dict(labels=np.zeros(0, np.int32),
                             scores=np.zeros(0, np.float32),
                             bbox=np.zeros((0, 4), np.float32),
                             boxes3d=np.zeros((0, 7), np.float32)))
    return dets


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("--results", required=True)
    ap.add_argument("--out-dir", default="vis")
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--max-frames", type=int, default=20)
    ap.add_argument("--cfg-options", nargs="*", default=None)
    args = ap.parse_args(argv)

    from ...apis import build
    from ...data import kitti
    from ...data.pipelines import load_bgr
    from ...utils.visualize import bev_canvas, draw_boxes_2d, write_png_bgr
    from ..train import load_config

    cfg = load_config(args.config, args.cfg_options)
    ds = build.build_dataset(cfg["data"]["val"],
                             rng=np.random.RandomState(0))
    dets = load_results(args.results, ds.infos)
    os.makedirs(args.out_dir, exist_ok=True)
    pcr = cfg.get("point_cloud_range", (0.0, -40.0, -3.0, 70.4, 40.0, 1.0))
    paths = []
    for info, det in list(zip(ds.infos, dets))[:args.max_frames]:
        keep = det["scores"] >= args.score_thr
        idx = f"{int(info['image']['image_idx']):06d}"
        img_path = os.path.join(ds.root, "training", "image_2",
                                f"{idx}.png")
        if os.path.exists(img_path):
            paths.append(os.path.join(args.out_dir, f"{idx}_img.png"))
            write_png_bgr(paths[-1], draw_boxes_2d(
                load_bgr(img_path), det["bbox"][keep],
                labels=det["labels"][keep], scores=det["scores"][keep]))
        paths.append(os.path.join(args.out_dir, f"{idx}_bev.png"))
        write_png_bgr(paths[-1], bev_canvas(kitti.load_points(ds.root, info),
                                        [(det["boxes3d"][keep], None)],
                                        point_cloud_range=pcr))
    n = min(len(ds.infos), args.max_frames)
    print(f"wrote {n} frames to {args.out_dir}")
    return paths


if __name__ == "__main__":
    main()
