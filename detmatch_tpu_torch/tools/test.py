"""Evaluation CLI (counterpart of ``tools/test.py``): restore a
checkpoint, run inference over the config's val set and print the KITTI
AP metrics; an SSL checkpoint fans out teacher / student × 2d / 3d.

Usage:
    python -m detmatch_tpu_torch.tools.test CONFIG CHECKPOINT_DIR
        [--eval kitti] [--out JSON] [--score-thr T] [--score-thr-3d T]
        [--score-thr-2d T] [--out-kitti DIR] [--cfg-options k=v ...]
        [--device cuda|cpu]

``CHECKPOINT_DIR`` holds ``ckpt_<n>`` directories (the latest is
restored). ``--cfg-options`` overrides the config as the training CLI's
does (the data paths a run was trained with).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("checkpoint")
    ap.add_argument("--eval", default="kitti")
    ap.add_argument("--out", default=None)
    ap.add_argument("--score-thr", type=float, default=None,
                    help="pre-NMS confidence floor override for both "
                         "branches (defaults: 0.1 3D / 0.05 2D)")
    ap.add_argument("--score-thr-3d", type=float, default=None,
                    help="3D-only floor override (wins over --score-thr)")
    ap.add_argument("--score-thr-2d", type=float, default=None,
                    help="2D-only floor override (wins over --score-thr)")
    ap.add_argument("--out-kitti", default=None, metavar="DIR",
                    help="also write KITTI-format result txts; SSL "
                         "checkpoints write tea.3d/ and stu.3d/ "
                         "subdirectories")
    ap.add_argument("--cfg-options", nargs="*", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the models (default cuda)")
    args = ap.parse_args(argv)

    from ..apis import build
    from ..apis.evaluate import eval_frcnn, eval_pvrcnn, eval_ssl
    from ..data.collate import collate_view
    from ..eval.kitti_format import write_submission
    from ..train import checkpoints
    from .train import load_config

    cfg = load_config(args.config, args.cfg_options)
    ds = build.build_dataset(cfg["data"]["val"],
                             rng=np.random.RandomState(0))
    ck = dict(cfg["data"].get("collate", {}))
    collate_fn = lambda s: collate_view(s, **ck)  # noqa: E731
    task = cfg.get("task", "ssl")
    payload, _ = checkpoints.restore_latest(args.checkpoint)

    def thr(specific):
        return specific if specific is not None else args.score_thr

    thr3, thr2 = thr(args.score_thr_3d), thr(args.score_thr_2d)
    if task == "ssl":
        ssl = build.build_ssl(cfg, device=args.device)
        ssl.load_state_dict(payload["state"])
        kw = {}
        if thr3 is not None:
            kw["score_thresh_3d"] = thr3
        if thr2 is not None:
            kw["score_thr_2d"] = thr2
        vox = build.build_voxelizer(cfg)
        if args.out_kitti:
            res, dets = eval_ssl(ssl, ds, collate_fn, vox, return_dets=True,
                                 **kw)
            for key in ("tea.3d", "stu.3d"):
                write_submission(dets[key], ds.infos,
                                 os.path.join(args.out_kitti, key))
        else:
            res = eval_ssl(ssl, ds, collate_fn, vox, **kw)
    elif task == "pretrain_3d":
        model = build.build_detector(cfg, args.device, "detector_3d")
        model.load_state_dict(payload["model"])
        kw = {} if thr3 is None else dict(score_thresh=thr3)
        res, dets = eval_pvrcnn(model, ds, collate_fn,
                                build.build_voxelizer(cfg), **kw)
        if args.out_kitti:
            write_submission(dets, ds.infos, args.out_kitti)
    else:
        model = build.build_detector(cfg, args.device, "detector_2d")
        model.load_state_dict(payload["model"])
        kw = {} if thr2 is None else dict(score_thr=thr2)
        res, _ = eval_frcnn(model, ds, collate_fn, **kw)
    if args.out_kitti and task in ("ssl", "pretrain_3d"):
        print(f"KITTI submission written to {args.out_kitti}")

    for k in sorted(res):
        print(f"{k}: {res[k]:.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
