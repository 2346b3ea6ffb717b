"""Training CLI (counterpart of ``tools/train.py``).

Usage:
    python -m detmatch_tpu_torch.tools.train CONFIG [--work-dir DIR]
        [--resume-from CKPT_DIR] [--load-from-with-optimizer CKPT_DIR]
        [--seed N] [--max-iters N] [--cfg-options k=v ...]
        [--autoscale-lr] [--device cuda|cpu] [--dist-coordinator HOST:PORT
        --dist-num-processes N --dist-process-id R]

The config's ``task`` picks the loop: "ssl" (DetMatch, the default),
"pretrain_3d" (PV-RCNN) or "pretrain_2d" (Faster R-CNN), each called
with the keyword values JAX's CLI passes; ``main`` returns what the loop
returns. The models live on ``--device``: the card unless ``cpu`` is
asked for. One process trains on one device; several (``--dist-*`` or
the ``DETMATCH_*`` environment, as ``tools/dist_train.py`` sets it) train
data-parallel (``parallel``): over NCCL on the card, over gloo with
``--device cpu``.
"""
from __future__ import annotations

import argparse
import ast
import os

import numpy as np

from ..parallel import init_distributed, process_count, shutdown


def parse_options(pairs):
    """``["a.b=1", "c=x"]`` → ``{"a.b": 1, "c": "x"}``: each value a Python
    literal where it parses as one, else the string."""
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def load_config(path, options):
    from ..config import Config
    cfg = Config.fromfile(path)
    cfg.merge_from_options(parse_options(options))
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--resume-from", default=None)
    ap.add_argument("--load-from-with-optimizer", default=None,
                    help="SSL ckpt dir: restore model+optimizer, reset "
                         "the iteration counter (bootstrapped resume)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--cfg-options", nargs="*", default=None)
    ap.add_argument("--dist-coordinator", default=None,
                    help="host:port of process 0 (multi-process; or set "
                         "DETMATCH_COORDINATOR / run tools.dist_train)")
    ap.add_argument("--dist-num-processes", type=int, default=None)
    ap.add_argument("--dist-process-id", type=int, default=None)
    ap.add_argument("--autoscale-lr", action="store_true",
                    help="linear-scale learning rates by the processes "
                         "(one device each) over 8 (reference "
                         "tools/train.py:124-132)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the models (default cuda)")
    args = ap.parse_args(argv)
    init_distributed(args.dist_coordinator, args.dist_num_processes,
                     args.dist_process_id,
                     backend="gloo" if args.device == "cpu" else None)
    result = run(args)
    shutdown()
    return result


def run(args):
    """The loop of ``args``'s config, in this process."""
    cfg = load_config(args.config, args.cfg_options)
    work_dir = args.work_dir or cfg.get("work_dir") or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    if args.max_iters:
        cfg["max_iters"] = args.max_iters
    if args.autoscale_lr:
        # linear scaling rule (arXiv:1706.02677): every rate scales by the
        # share of the reference's 8-device fleet in use
        scale = process_count() / 8.0
        if "base_lr" in cfg:
            cfg["base_lr"] = cfg["base_lr"] * scale
        cfg["autoscale_lr_factor"] = scale

    from ..apis import build
    from ..data.collate import collate_ts, collate_view

    rng = np.random.RandomState(args.seed)
    task = cfg.get("task", "ssl")
    ck = dict(cfg["data"].get("collate", {}))
    view = lambda s: collate_view(s, **ck)  # noqa: E731
    if task == "ssl":
        from ..apis.train_ssl import train_ssl
        ssl = build.build_ssl(cfg, device=args.device)
        vox = build.build_voxelizer(cfg)
        lab = build.build_dataset(cfg["data"]["train_lab"], rng=rng)
        unlab = build.build_dataset(cfg["data"]["train_unlab"], rng=rng)
        val = None
        if cfg["data"].get("val") and cfg.get("evaluation"):
            val = build.build_dataset(cfg["data"]["val"], rng=rng)
        with open(args.config) as f:
            config_text = f.read()
        return train_ssl(
            ssl, vox, lab, unlab, lambda s: collate_ts(s, **ck), work_dir,
            max_iters=cfg.get("max_iters", 5000),
            batch_size=cfg.get("batch_size", 4),
            lr_3d=cfg.get("lr_3d"), lr_2d=cfg.get("lr_2d"),
            lr_scale=cfg.get("autoscale_lr_factor", 1.0),
            num_unlabeled=cfg.get("num_unlabeled_samples", 1),
            seed=args.seed, resume_from=args.resume_from,
            load_from=cfg.get("load_from"),
            load_from_with_optimizer=(args.load_from_with_optimizer
                                      or cfg.get("load_from_with_optimizer")),
            log_interval=cfg.get("log_interval", 10),
            ckpt_interval=cfg.get("ckpt_interval", 5000),
            val_dataset=val, val_collate_fn=view,
            eval_interval=(cfg.get("evaluation") or {}).get("interval"),
            profile_dir=cfg.get("profile_dir"),
            vis_interval=cfg.get("vis_interval"),
            tensorboard=cfg.get("tensorboard", False),
            ckpt_meta=dict(classes=cfg.get("class_names", (
                "Pedestrian", "Cyclist", "Car")), config_text=config_text))
    if task == "pretrain_3d":
        from ..apis.train_pretrain import train_pvrcnn
        model = build.build_detector(cfg, args.device, "detector_3d")
        ds = build.build_dataset(cfg["data"]["train"], rng=rng)
        return train_pvrcnn(model, build.build_voxelizer(cfg), ds, view,
                            work_dir, max_iters=cfg.get("max_iters", 1000),
                            base_lr=cfg.get("base_lr", 0.001),
                            batch_size=cfg.get("batch_size", 2),
                            seed=args.seed)
    if task == "pretrain_2d":
        from ..apis.train_pretrain import train_frcnn
        model = build.build_detector(cfg, args.device, "detector_2d")
        ds = build.build_dataset(cfg["data"]["train"], rng=rng)
        return train_frcnn(model, ds, view, work_dir,
                           max_iters=cfg.get("max_iters", 1000),
                           base_lr=cfg.get("base_lr", 0.02),
                           batch_size=cfg.get("batch_size", 2),
                           step_iters=cfg.get("step_iters", ()),
                           seed=args.seed)
    raise ValueError(f"unknown task {task}")


if __name__ == "__main__":
    main()
