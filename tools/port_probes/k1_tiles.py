"""Time K1's forward and backward on the card at each gather-GEMM tile
height (32, 64 and 128 output rows a block) on the 12 backbone convs of
one B=8 batch, beside the rows that ``window_key_conv.tile_rows`` picks.

Run from the repository root, with one card visible:

    python3 tools/port_probes/k1_tiles.py

The PV-RCNN backbone of ``chip_smoke.CONFIG`` (the model's own seeded
initialisers, eval mode, fp32) runs on 8 synthetic frames of 18,000
points (the student's batch of one SSL iteration); its 12 K1 calls are
recorded and each is timed with CUDA events (forward writing its
rulebook, as the student's does, and the backward with dF) at every
tile height whose shared memory fits 227 KB. The backward's dW passes
do not depend on the tile height; the difference is dF's.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from detmatch_tpu_torch.apis.build import (  # noqa: E402
    build_detector, build_voxelizer)
from detmatch_tpu_torch.config import Config  # noqa: E402
from detmatch_tpu_torch.ops.cuda import KERNELS  # noqa: E402
from detmatch_tpu_torch.ops.cuda import window_key_conv as wkc  # noqa: E402
from detmatch_tpu_torch.ops.voxelize import voxelize_mean  # noqa: E402
from detmatch_tpu_torch.utils.synth_kitti import lidar_batch  # noqa: E402

B = 8
POINTS = 18000
REPS = 10


def record_calls():
    cfg = Config.fromfile(str(cs.CONFIG))
    spec = build_voxelizer(cfg)
    torch.manual_seed(cs.SEED)
    model = build_detector(cfg).eval()
    rng = np.random.RandomState(cs.SEED)
    pts, valid = lidar_batch(rng, B, POINTS, spec.point_cloud_range)
    vox = voxelize_mean(torch.from_numpy(pts).cuda(),
                        torch.from_numpy(valid).cuda(), spec)
    calls = []
    with torch.no_grad():
        model.backbone_3d(vox["features"], vox["keys"],
                          ops=cs.recording(KERNELS, calls))
    return [c[1] for c in calls if c[0] == "window_key_conv_batched"]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k1_tiles.py runs on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    calls = record_calls()
    planned = wkc.tile_rows
    totals = {}
    g = torch.Generator("cuda").manual_seed(cs.SEED)
    for i, args in enumerate(calls):
        feats, _, nkeys, _, w, _ = args
        k, c, co = w.shape
        dout = torch.randn(B, nkeys.shape[1], co, generator=g, device="cuda")
        _, rb = wkc.window_key_conv_fwd(*args, rulebook=True)
        cells = []
        for rows in wkc.TILE_ROWS:
            fits = [wkc.tile_smem_bytes(rows, k, cx, cy) <= wkc.MAX_SMEM
                    for cx, cy in ((c, co), (co, c))]
            if not all(fits):
                cells.append(f"{rows}: does not fit")
                continue
            wkc.tile_rows = lambda *_, r=rows: r
            fwd = cs.cuda_ms(lambda: wkc.window_key_conv_fwd(
                *args, rulebook=True), reps=REPS)
            bwd = cs.cuda_ms(lambda: wkc.window_key_conv_bwd(
                dout, feats, rb, w), reps=REPS)
            wkc.tile_rows = planned
            t = totals.setdefault(rows, [0.0, 0.0, 0])
            t[0] += fwd
            t[1] += bwd
            t[2] += 1
            cells.append(f"{rows}: fwd {fwd:.4f} bwd {bwd:.4f}")
        print(f"conv {i} (B, M, K)={tuple(nkeys.shape)} C={c} Co={co}, plan "
              f"fwd {planned(k, c, co)} dF {planned(k, co, c)} rows: "
              + "; ".join(cells) + f" ms [{card}]")
    for rows, (fwd, bwd, n) in totals.items():
        print(f"rows {rows}: fwd {fwd:.3f} bwd {bwd:.3f} ms over {n} convs "
              f"[{card}]")


if __name__ == "__main__":
    main()
