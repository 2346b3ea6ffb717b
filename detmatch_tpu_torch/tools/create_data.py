"""Offline KITTI data preparation (counterpart of ``tools/create_data.py``):
info pickles, reduced point clouds and the gt database, equal to the JAX
tool's files.

Usage:
    python -m detmatch_tpu_torch.tools.create_data kitti --root data/kitti
        [--train-split ImageSets/train.txt] [--val-split ImageSets/val.txt]
        [--skip-reduced] [--skip-gt-db] [--export-2d]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..data import dbsampler, kitti
from ..data.np_geometry import project_to_image


def create_reduced_point_cloud(root, infos):
    """Crop each frame's velodyne points to the camera's field of view
    (positive depth, inside the image) into
    ``training/velodyne_reduced/`` (reference
    ``kitti_converter.create_reduced_point_cloud``)."""
    out_dir = os.path.join(root, "training", "velodyne_reduced")
    os.makedirs(out_dir, exist_ok=True)
    for info in infos:
        pts = kitti.load_points(root, info)
        calib = kitti.calib_from_info(info)
        h, w = info["image"]["image_shape"][:2]
        uv, depth = project_to_image(pts[:, :3], calib.lidar2img)
        keep = ((depth > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < w)
                & (uv[:, 1] >= 0) & (uv[:, 1] < h))
        name = os.path.basename(info["point_cloud"]["velodyne_path"])
        pts[keep].astype(np.float32).tofile(os.path.join(out_dir, name))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dataset", choices=["kitti"])
    ap.add_argument("--root", required=True)
    ap.add_argument("--train-split", default="ImageSets/train.txt")
    ap.add_argument("--val-split", default="ImageSets/val.txt")
    ap.add_argument("--skip-reduced", action="store_true")
    ap.add_argument("--skip-gt-db", action="store_true")
    ap.add_argument("--export-2d", action="store_true",
                    help="also export COCO-format 2D annotations "
                         "(reference kitti_converter.export_2d_annotation)")
    args = ap.parse_args(argv)

    for split_name, split_file in (("train", args.train_split),
                                   ("val", args.val_split)):
        path = os.path.join(args.root, split_file)
        if not os.path.exists(path):
            print(f"skip {split_name}: no {path}")
            continue
        infos = kitti.create_infos(args.root, path, training=True)
        out = os.path.join(args.root, f"kitti_infos_{split_name}.pkl")
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        print(f"wrote {out} ({len(infos)} frames)")
        if split_name == "train":
            if not args.skip_reduced:
                create_reduced_point_cloud(args.root, infos)
                print("wrote reduced point clouds")
            if not args.skip_gt_db:
                dbsampler.create_gt_database(args.root, infos,
                                             classes=kitti.CLASS_NAMES)
                print("wrote gt database")
        if args.export_2d:
            kitti.export_2d_annotation(args.root, out)
            print(f"wrote 2D COCO annotations for {split_name}")


if __name__ == "__main__":
    main()
