"""Time the DetMatch SSL iteration of the port in one tree, on one or more
of its sparse-conv paths, so that two trees (a parent commit unpacked
with ``git archive`` and this one) can be compared inside one chip call,
in turns.

Run from the repository root, with one card visible:

    python3 tools/port_probes/ssl_iteration_ab.py [TREE] [REPS] [PATHS]

TREE (default: this repository) is the root of the tree whose
``chip_smoke.py`` and ``detmatch_tpu_torch`` are used; its kernels build
into its own ``build/kernels``. PATHS is a comma-separated list of the
backbone's ``conv_impl`` values (default ``window``; ``key`` runs K5,
``rulebook`` K7). Per path, the SSL detector of its
``chip_smoke.SSL_CONFIG`` (seeded initialisers, fp32, TF32 off) trains on
one synthetic batch of 4 labeled + 4 unlabeled frames with
``chip_smoke.iteration_split``: one iteration warms up, then REPS
(default 3) are timed with CUDA events. Prints one JSON line a path: the
tree, the path, the mean iteration and stage times in ms, peak memory and
the card.
"""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch


def main():
    tree = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parents[2]).resolve()
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    paths = sys.argv[3].split(",") if len(sys.argv) > 3 else ["window"]
    if not torch.cuda.is_available():
        raise SystemExit("ssl_iteration_ab.py runs on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from detmatch_tpu_torch.apis.build import build_voxelizer
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.train.optim import detmatch_branch_optimizers

    for path in paths:
        cfg = Config.fromfile(str(cs.SSL_CONFIG))
        det3d = cfg["model"]["detector_3d"]
        det3d["backbone3d_cfg"] = dict(det3d.get("backbone3d_cfg") or {},
                                       conv_impl=path)
        spec = build_voxelizer(cfg)
        model = cs.ssl_model(cfg)
        batch_np = cs.ssl_batch_np(cfg, np.random.RandomState(cs.SEED))
        m = copy.deepcopy(model).train()
        del model
        opts = detmatch_branch_optimizers(m, 0.04, 0.16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        split = cs.iteration_split(m, batch_np, spec, opts,
                                   torch.Generator(cs.DEVICE).manual_seed(
                                       cs.SEED), reps=reps)
        print(json.dumps(dict(
            tree=str(tree), path=path, reps=reps,
            iteration_ms=split.pop("iteration"), split_ms=split,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            card=cs.card_line())), flush=True)
        del m, opts


if __name__ == "__main__":
    main()
