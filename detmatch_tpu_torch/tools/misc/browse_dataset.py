"""Render dataset samples after their pipeline (counterpart of
``tools/misc/browse_dataset.py``): a BEV picture with the gt boxes and
the image with its 2D gt boxes, one pair of PNGs a sample.

Usage:
    python -m detmatch_tpu_torch.tools.misc.browse_dataset CONFIG
        [--out-dir browse_vis] [--n 5] [--split train_lab]
        [--cfg-options k=v ...]

A teacher-student sample shows its student view. Returns the paths
written.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("--out-dir", default="browse_vis")
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--split", default="train_lab",
                    help="data key: train_lab / train_unlab / train / val")
    ap.add_argument("--cfg-options", nargs="*", default=None)
    args = ap.parse_args(argv)

    from ...apis import build
    from ...utils.visualize import (bev_canvas, denormalize_caffe,
                                    draw_boxes_2d, write_png_bgr)
    from ..train import load_config

    cfg = load_config(args.config, args.cfg_options)
    data_cfg = cfg["data"].get(args.split) or cfg["data"]["val"]
    ds = build.build_dataset(data_cfg, rng=np.random.RandomState(0))
    os.makedirs(args.out_dir, exist_ok=True)
    paths = []
    for i in range(min(args.n, len(ds))):
        s = ds[i]
        if "stu" in s:  # TSDataset
            s = s["stu"]
        paths.append(os.path.join(args.out_dir, f"{i}_bev.png"))
        write_png_bgr(paths[-1], bev_canvas(s["points"],
                                        [(s.get("gt_bboxes_3d"), None)]))
        img = denormalize_caffe(s["img"])
        if "gt_bboxes" in s:
            img = draw_boxes_2d(img, s["gt_bboxes"],
                                labels=s.get("gt_labels"))
        paths.append(os.path.join(args.out_dir, f"{i}_img.png"))
        write_png_bgr(paths[-1], img)
    print(f"wrote {len(paths) // 2} samples to {args.out_dir}")
    return paths


if __name__ == "__main__":
    main()
