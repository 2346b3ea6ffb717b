"""Point-cloud inference demo (counterpart of ``demo/pcd_demo.py``): a
PV-RCNN checkpoint on one KITTI frame → a BEV picture of its detections.

Usage:
    python -m detmatch_tpu_torch.demo.pcd_demo CONFIG CKPT_DIR --pts x.bin
        --calib x.txt [--out demo_out.png] [--score-thr 0.3]
        [--device cuda|cpu]

``CKPT_DIR`` holds ``ckpt_<n>`` directories of a pretraining run
(``dict(model=state_dict)``); the newest is restored. ``main`` returns
the detections kept (boxes (M, 7), scores, labels), numpy.
"""
from __future__ import annotations

import argparse

from . import point_batch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("checkpoint")
    ap.add_argument("--pts", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--out", default="demo_out.png")
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda)")
    args = ap.parse_args(argv)

    from ..apis.build import build_detector, build_voxelizer
    from ..apis.inference import detect
    from ..config import Config
    from ..data import kitti
    from ..train.checkpoints import restore_latest
    from ..utils.visualize import bev_canvas, write_png_bgr

    cfg = Config.fromfile(args.config)
    kitti.read_calib(args.calib)  # required as JAX's; the BEV needs none
    model = build_detector(cfg, device=args.device)
    model.load_state_dict(restore_latest(args.checkpoint)[0]["model"])
    pts, p, v = point_batch(args.pts, args.device)
    det = detect(model, p, v, build_voxelizer(cfg))
    keep = det["valid"][0] & (det["scores"][0] > args.score_thr)
    res = {k: det[k][0][keep].cpu().numpy()
           for k in ("boxes", "scores", "labels")}
    print(f"{int(keep.sum())} detections above {args.score_thr}")
    write_png_bgr(args.out, bev_canvas(
        pts, [(res["boxes"], None)],
        point_cloud_range=cfg["voxelizer"]["point_cloud_range"]))
    print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
