"""Import the reference's PyTorch checkpoints into port checkpoints
(counterpart of ``tools/model_converters/import_torch_ckpt.py``): a pcdet
PV-RCNN and an mmdet Faster R-CNN, the two pretrained detectors DetMatch
starts from.

The port keeps pcdet's and mmdet's module names and weight layouts
(``convert.py``): spconv 1.x kernels (kz, ky, kx, in, out), pcdet's
C-outer height compression, the C-outer RoI shared fc, mmdet's (C, 7, 7)
first shared fc. So the import re-lays nothing out: it builds the model
of a config (``apis/build.py``), keeps the checkpoint's keys that the
model has, names every key it drops, refuses a checkpoint that lacks a
key of the model or holds one in another shape, loads the rest strictly
and writes a port checkpoint, ``OUT_DIR/ckpt_0/state.pt`` holding
``dict(model=state_dict)`` with ``meta.json`` beside it
(``train/checkpoints.py``). An SSL config's ``load_from``
(``{"det3d": OUT_DIR, "det2d": OUT_DIR}``) reads that into both the
student and the teacher (``apis/train_ssl.train_ssl``).

Unlike the JAX tool, nothing is permuted on the way in: pcdet's
``point_head.cls_layers.0`` keeps pcdet's row order, which the port's
point head reads, and the ResNet's depth is the config's
``backbone_cfg.stage_blocks`` (any depth the config names), not a fixed
(3, 4, 6, 3).

The input is read with ``torch.load(weights_only=True)``: a checkpoint is
a pickle, and a full unpickle can run code, so only tensors, numbers,
strings and containers are read. pcdet's (``model_state``,
``optimizer_state``, ``epoch``, ``it``, ``version``) and mmdet's
(``state_dict``, ``optimizer``, ``meta`` of strings and numbers)
checkpoints are made of those. A file that pickles other objects is
refused with the name of the first one; re-save its state dict
(``torch.save(ckpt["state_dict"], path)``) where it can be trusted.

Usage:
    python -m detmatch_tpu_torch.tools.model_converters.import_torch_ckpt
        {pvrcnn,frcnn} IN.pth OUT_DIR [--config CFG]

``CFG`` defaults to ``configs/detmatch/001/detmatch/split_0.py``, whose
``model.detector_3d`` (pvrcnn) or ``model.detector_2d`` (frcnn) is built.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Tuple

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
DEFAULT_CONFIG = os.path.join(REPO, "configs", "detmatch", "001", "detmatch",
                              "split_0.py")
KINDS = {"pvrcnn": "detector_3d", "frcnn": "detector_2d"}
# where each library keeps the weights inside a checkpoint (JAX tool
# ``import_torch_ckpt.py:337``): mmdet, pcdet, else a bare state dict
CONTAINERS = ("state_dict", "model_state")


def read_state_dict(path) -> Dict[str, torch.Tensor]:
    """The tensors of a pcdet (``model_state``), mmdet (``state_dict``) or
    bare state-dict checkpoint at ``path``, on the CPU; other entries
    (optimizer state, meta, epochs) are left out. Read with
    ``weights_only=True`` (the module docstring)."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: refused by torch.load(weights_only=True), which reads "
            f"tensors, numbers, strings and containers only ({e}); re-save "
            "its state dict where the file can be trusted") from e
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: a {type(ckpt).__name__}, not a "
                         "checkpoint dict")
    for key in CONTAINERS:
        if isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    return {k: v for k, v in ckpt.items() if isinstance(v, torch.Tensor)}


def filter_state_dict(sd, model) -> Tuple[Dict[str, torch.Tensor],
                                          List[str], List[str], List[str]]:
    """(the entries of ``sd`` that ``model`` has, the keys dropped, the
    model's keys that ``sd`` lacks, the keys whose shape differs as
    "key: (checkpoint shape) vs (model shape)")."""
    want = model.state_dict()
    kept = {k: v for k, v in sd.items() if k in want}
    dropped = sorted(k for k in sd if k not in want)
    missing = sorted(k for k in want if k not in sd)
    misshapen = sorted(
        f"{k}: {tuple(v.shape)} vs {tuple(want[k].shape)}"
        for k, v in kept.items() if tuple(v.shape) != tuple(want[k].shape))
    return kept, dropped, missing, misshapen


def build_model(kind, config):
    """The detector that ``kind`` names, built on the CPU from the
    config at path ``config`` (or a loaded config dict)."""
    from ...apis.build import build_detector
    from ...config import Config

    cfg = Config.fromfile(config) if isinstance(config, str) else config
    return build_detector(cfg, device="cpu", key=KINDS[kind])


def import_checkpoint(kind, src, out_dir, config=DEFAULT_CONFIG, log=print):
    """Import the checkpoint at ``src`` as a ``kind`` ("pvrcnn" or
    "frcnn") detector of ``config`` into ``out_dir/ckpt_0``. Raises
    ValueError, naming the keys, if the checkpoint lacks a key of the
    model or holds one in another shape. Returns (the state dict
    written, the keys dropped)."""
    from ...train import checkpoints

    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: expected one of {sorted(KINDS)}")
    model = build_model(kind, config)
    sd = read_state_dict(src)
    kept, dropped, missing, misshapen = filter_state_dict(sd, model)
    for k in dropped:
        log(f"[import] dropped {k} {tuple(sd[k].shape)}: not in the model")
    if missing or misshapen:
        raise ValueError(
            f"{src} does not fit the {kind} of the config: "
            + "; ".join([f"missing {k}" for k in missing]
                        + [f"misshapen {k}" for k in misshapen]))
    model.load_state_dict(kept, strict=True)
    state = model.state_dict()
    checkpoints.save(out_dir, dict(model=state), 0, meta=checkpoints.
                     default_meta(imported_from=os.path.abspath(src),
                                  kind=kind, dropped=dropped,
                                  config=config if isinstance(config, str)
                                  else None))
    log(f"[import] {kind}: {len(kept)} tensors from {src} -> "
        f"{os.path.join(out_dir, 'ckpt_0')} ({len(dropped)} dropped)")
    return state, dropped


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kind", choices=sorted(KINDS))
    ap.add_argument("src", help="the pcdet or mmdet checkpoint (.pth)")
    ap.add_argument("out_dir", help="the port checkpoint directory that an "
                                    "SSL config's load_from names")
    ap.add_argument("--config", default=DEFAULT_CONFIG,
                    help="the config whose model the checkpoint loads into "
                         "(default: the DetMatch split_0 config)")
    args = ap.parse_args(argv)
    try:
        import_checkpoint(args.kind, args.src, args.out_dir, args.config)
    except ValueError as e:
        raise SystemExit(f"import_torch_ckpt: {e}")


if __name__ == "__main__":
    main()
