"""Time K2 (ball query) per group width G on the ball-query calls of one
DetMatch SSL iteration, and K3 (farthest-point sampling) per cluster size
C and points a thread at B = 1, 4 and 8, with K3's step floor at a
minimal sweep.

Run from the repository root, with one card visible:

    python3 tools/port_probes/k2k3_plans.py

The SSL detector of ``chip_smoke.SSL_CONFIG`` (seeded initialisers, fp32)
runs one teacher phase (B=4) and one student forward (B=8) on the
synthetic batch that ``chip_smoke.py`` uses; its 24 K2 calls are
recorded. Printed:
1. the per-call breakdown that ``chip_smoke.py`` prints (site, shapes,
   window, positions scanned, count, ms by CUDA events and the kernel's
   device ms beside the bound), at the planned launch;
2. each K2 call's device ms (profiler kernel time) at every G of
   ``ball_query.GROUP_LANES`` beside the planned one, and the sums per
   G;
3. K3 on synthetic frames at B = 1, 4, 8 and N = 16,384, 18,000 (2,048
   samples, CUDA events) at every cluster size that holds the frame,
   with the fewest points a thread and up to four more, beside the
   planned launch, and the card's active clusters of each;
4. K3's step floor (``chip_smoke.k3_step_floor``): N = one point a
   thread of the planned cluster (B = 1 and 8), 2,048 samples, in µs per
   step.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from detmatch_tpu_torch.ops.cuda import KERNELS  # noqa: E402
from detmatch_tpu_torch.ops.cuda import ball_query as bq  # noqa: E402
from detmatch_tpu_torch.ops.cuda import fps  # noqa: E402
from detmatch_tpu_torch.utils.synth_kitti import (  # noqa: E402
    SSL_PCR, lidar_batch)

SAMPLES = 2048
REPS = 5


def record_ssl_calls():
    """The K2 and K3 calls of one SSL iteration's teacher phase and
    student forward, as ``chip_smoke.ssl_phases`` records them."""
    from detmatch_tpu_torch.apis.build import build_voxelizer
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.train.ssl_step import (teacher_step,
                                                   to_device_views,
                                                   voxelize_views)
    cfg = Config.fromfile(str(cs.SSL_CONFIG))
    spec = build_voxelizer(cfg)
    model = cs.ssl_model(cfg).train()
    rng = np.random.RandomState(cs.SEED)
    batch = voxelize_views(to_device_views(cs.ssl_batch_np(cfg, rng),
                                           cs.DEVICE), spec)
    canvas = tuple(cfg["model"]["detector_2d"]["canvas"])
    for view in (batch["unlab"]["tea"], batch["unlab"]["stu"]):
        view["aug3d"], view["aug2d"] = cs.aug_records(
            rng, cs.SSL_B, canvas, view["ori_shape"][0].tolist())
    calls = []
    model.ops = cs.recording(KERNELS, calls)
    with torch.no_grad():
        pseudo = teacher_step(model, batch)
        model.student_losses_3d_concat(
            batch, pseudo, 0, torch.Generator(cs.DEVICE).manual_seed(cs.SEED))
    return [c for c in calls if c[0] in ("ball_query_batched", "fps_batched")]


def k2_per_group(calls, card):
    """Device ms (profiler) of each K2 call at every G the kernel is
    built for."""
    totals = dict.fromkeys(bq.GROUP_LANES, 0.0)
    planned = 0.0
    k2 = [c for c in calls if c[0] == "ball_query_batched"]
    for j, (_, args, kwargs, _) in enumerate(k2):
        centers, cvalid, pts, pvalid, radius, ns = args
        table = kwargs["table"]
        m, n = centers.shape[1], pts.shape[1]
        want = bq.group_lanes(m, n, radius, ns)
        cells = []
        for g in bq.GROUP_LANES:
            ms = cs.kernel_device_ms(lambda: bq.ball_query_launch(
                centers, cvalid, table, radius, ns, g), "ball_query_kernel",
                reps=REPS)
            totals[g] += ms
            planned += ms if g == want else 0.0
            cells.append(f"G={g} {ms:.4f}")
        print(f"  K2 {j}: {cs.K2_SITES[j % 12]} B={centers.shape[0]} M={m} "
              f"N={n} r={radius} ns={ns} plan G={want}: " + ", ".join(cells)
              + f" ms [{card}]")
    print("  K2 device ms over the calls: " + ", ".join(
        f"G={g} {ms:.3f}" for g, ms in totals.items())
        + f", planned {planned:.3f} [{card}]")


def k3_per_cluster(card):
    """K3 at every cluster size that holds the frame, with the fewest
    points a thread and with up to four more (lanes that own no point)."""
    rng = np.random.RandomState(cs.SEED)
    for n in (16384, cs.TRAIN_POINTS):
        pts, valid = lidar_batch(rng, 8, n, SSL_PCR)
        xyz8 = torch.from_numpy(pts[..., :3].copy()).cuda()
        valid8 = torch.from_numpy(valid).cuda()
        for b in (1, 4, 8):
            xyz, v = xyz8[:b].contiguous(), valid8[:b].contiguous()
            cells = []
            for c in fps.CLUSTER_SIZES:
                fewest = -(-n // (c * fps.CTA_THREADS))
                for p in range(fewest, min(fewest + 4, fps.MAX_PER_THREAD)
                               + 1):
                    plan = fps.FpsPlan(c, p)
                    ms = cs.cuda_ms(lambda: fps.fps_launch(
                        xyz, v, SAMPLES, plan), reps=3)
                    cells.append(f"C={c} P={p} {ms:.4f} (active clusters "
                                 f"{fps.active_clusters(plan)})")
            print(f"  K3 B={b} N={n} plan {tuple(fps.fps_plan(b, n))}: "
                  + "; ".join(cells) + f" ms [{card}]")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k2k3_plans.py runs on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card)
    calls = record_ssl_calls()
    with torch.no_grad():
        print("per-call breakdown at the planned G:")
        cs.k2_breakdown(calls, card)
        for j, (_, args, _, _) in enumerate(
                c for c in calls if c[0] == "fps_batched"):
            cs.k3_line(f"SSL {j}", *args, card)
        print("K2 per G (device ms):")
        k2_per_group(calls, card)
        print("K3 per cluster size:")
        k3_per_cluster(card)
        for b in (1, 8):
            cs.k3_step_floor(b, SAMPLES, card)


if __name__ == "__main__":
    main()
