"""Prepare a checkpoint for release (counterpart of
``tools/model_converters/publish_model.py``): drop the optimizer state,
re-save, and stamp the output directory's name and its meta with a short
content hash of what is kept.

Usage:
    python -m detmatch_tpu_torch.tools.model_converters.publish_model
        IN_CKPT_DIR OUT_DIR

The newest ``ckpt_<n>`` is published to ``OUT_DIR-<hash>/ckpt_<n>``.
Returns (output directory, hash).
"""
from __future__ import annotations

import argparse
import hashlib
import os

import numpy as np
import torch

DROP_KEYS = ("opt_state",)


def tree_hash(tree) -> str:
    """sha256 (first 8 hex digits) over the payload's keys in sorted
    order and each tensor's dtype, shape and bytes: the same content
    gives the same hash, whichever device or order it was saved from."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node, key=str):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            h.update(repr(path).encode())
            if isinstance(node, torch.Tensor):
                a = node.detach().cpu().contiguous()
                h.update(f"{a.dtype}{tuple(a.shape)}".encode())
                h.update(a.reshape(-1).view(torch.uint8).numpy().tobytes()
                         if a.numel() else b"")
            else:
                h.update(repr(np.asarray(node).tolist()).encode())

    walk(tree, ())
    return h.hexdigest()[:8]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("out")
    args = ap.parse_args(argv)

    from ...train import checkpoints

    payload, step = checkpoints.restore_latest(args.ckpt)
    kept = {k: v for k, v in payload.items() if k not in DROP_KEYS}
    dropped = sorted(set(payload) - set(kept))
    digest = tree_hash(kept)
    out = args.out.rstrip("/")
    if not out.endswith(digest):
        out = f"{out}-{digest}"
    os.makedirs(out, exist_ok=True)
    checkpoints.save(out, kept, step, meta=checkpoints.default_meta(
        published=True, content_hash=digest))
    print(f"published step {step} -> {out} "
          f"(dropped: {dropped or 'nothing'}; hash {digest})")
    return out, digest


if __name__ == "__main__":
    main()
