"""Time K4 (JV assignment) on the teacher phase's and one DetMatch SSL
iteration's problems, with its step floor, and K5's forward (key-compare
conv) on the 12 student convs of the key path; with ``--plans``, K4 per
design and K5 per tile height.

Run from the repository root, with one card visible:

    python3 tools/port_probes/k4k5_plans.py [TREE] [--plans]

TREE (default: this repository) is the root of the tree whose
``detmatch_tpu_torch`` (and whose kernels, built into its own
``build/kernels``) are timed, so that a parent commit unpacked with
``git archive`` and this tree can be compared inside one chip call; the
measuring code is this repository's ``chip_smoke.py`` either way.
``--plans`` needs this tree's kernels (``hungarian.solve_masked_launch``,
``key_conv.key_conv_fwd``). The problems are recorded with the plain
twins, so both trees get the same ones:
- K4: the teacher phase's call (``chip_smoke.teacher_phases``' model,
  seeded random weights, B=4) and the SSL iteration's fusion and
  consistency calls (``chip_smoke.ssl_model``, its batch);
- K5: the SSL iteration on ``conv_impl="key"``, the student's 12 convs
  (B=8).
Printed: ``chip_smoke.k4_line`` per K4 call, ``chip_smoke.k4_step_floor``,
``chip_smoke.k5_breakdown``; with ``--plans`` each K4 call's device ms at
every design that takes its K (1-4 columns a lane of the warp design,
and the block design), equal to the twin, and each K5 conv's ms at 32, 64
and 128 rows a block, bit-equal across launches and its largest
difference from the planned tile; then one JSON line of the sums.
"""
from __future__ import annotations

import copy
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def load_chip_smoke():
    """This repository's chip_smoke.py as a module (its functions import
    ``detmatch_tpu_torch`` from the first tree on sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_k4k5",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record(cs):
    """(K4 problems as (label, cost, row_valid), K5 student argument
    tuples), all recorded through the plain twins."""
    from detmatch_tpu_torch.apis.build import build_ssl, build_voxelizer
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.ops.cuda import PLAIN
    from detmatch_tpu_torch.train.ssl_step import (teacher_step,
                                                   to_device_views,
                                                   voxelize_views)
    from detmatch_tpu_torch.utils.synth_kitti import ssl_view

    cfg = Config.fromfile(str(cs.SSL_CONFIG))
    spec = build_voxelizer(cfg)
    canvas = tuple(cfg["model"]["detector_2d"]["canvas"])

    def views(rng, batch):
        for view in (batch["unlab"]["tea"], batch["unlab"]["stu"]):
            view["aug3d"], view["aug2d"] = cs.aug_records(
                rng, cs.SSL_B, canvas, view["ori_shape"][0].tolist())
        return batch

    jv = []
    # the teacher phase, as chip_smoke.teacher_phases builds it
    model = build_ssl(cfg)
    cs.randomize_(model.teacher["det3d"], cs.SEED)
    cs.randomize_(model.teacher["det2d"], cs.SEED + 1)
    points = cfg["data"]["collate"]["max_points"]
    rng = np.random.RandomState(cs.SEED)
    batch = views(rng, voxelize_views(to_device_views(dict(unlab=dict(
        tea=ssl_view(rng, cs.SSL_B, points, canvas),
        stu=ssl_view(rng, cs.SSL_B, points, canvas))), cs.DEVICE), spec))
    calls = []
    with torch.inference_mode():
        model.ops = cs.recording(PLAIN, calls)
        model.teacher_pseudo_labels(batch)
    jv += [("teacher phase", *c[1]) for c in calls
           if c[0] == "solve_masked_batched"]
    del model, batch, calls

    # the SSL iteration, window path for K4 and key path for K5
    model = cs.ssl_model(cfg)
    rng = np.random.RandomState(cs.SEED)
    batch = views(rng, voxelize_views(to_device_views(
        cs.ssl_batch_np(cfg, rng), cs.DEVICE), spec))
    cfg_key = copy.deepcopy(cfg)
    det3d = cfg_key["model"]["detector_3d"]
    det3d["backbone3d_cfg"] = dict(det3d.get("backbone3d_cfg") or {},
                                   conv_impl="key")
    key_model = build_ssl(cfg_key)
    key_model.load_state_dict(model.state_dict())
    out = {}
    for label, mdl in (("window", model), ("key", key_model)):
        m = copy.deepcopy(mdl).train()
        calls = []
        m.ops = cs.recording(PLAIN, calls)
        with torch.no_grad():
            pseudo = teacher_step(m, batch)
            m.student_losses_3d_concat(batch, pseudo, 0, torch.Generator(
                cs.DEVICE).manual_seed(cs.SEED))
        out[label] = calls
        del m
    k4 = [c[1] for c in out["window"] if c[0] == "solve_masked_batched"]
    jv += [(label, *args) for label, args in zip(
        ("SSL fusion", "SSL consistency"), k4)]
    k5 = [c[1] for c in out["key"] if c[0] == "key_conv_batched"
          and c[1][0].shape[0] == 2 * cs.SSL_B]
    return jv, k5


def k4_designs(cs, jv, card):
    """Device ms of each K4 problem at every design that takes its K."""
    from detmatch_tpu_torch.ops.cuda import hungarian
    problems = jv + [(f"chain K={k}", *cs.k4_chain(k)) for k in (32, 128)]
    for label, cost, rv in problems:
        k = cost.shape[-1]
        want = hungarian.solve_masked_plain(cost, rv)
        steps = int(hungarian.inner_steps(cost, rv).max())
        cells = []
        designs = [c for c in range(1, hungarian.WARP_MAX_COLS + 1)
                   if 32 * c >= k] + [0]
        for cols in designs:
            plan = hungarian.JvPlan(cols, 0)
            same = torch.equal(hungarian.solve_masked_launch(cost, rv, plan),
                               want)
            dev = cs.device_ms(lambda: hungarian.solve_masked_launch(
                cost, rv, plan), reps=10)
            name = f"warp {cols} cols" if cols else "block"
            cells.append(f"{name} {dev:.4f} ms ({1e3 * dev / max(steps, 1):.4f}"
                         f" us/step, equal {same})")
        print(f"  K4 {label} K={k} (planned {hungarian.jv_plan(k)}): "
              + "; ".join(cells) + f" [{card}]")


def k5_tiles(cs, k5, card):
    """K5's ms at each tile height on each student conv; bit-equal across
    two launches, and the largest difference from the planned tile."""
    from detmatch_tpu_torch.ops.cuda import key_conv as kc
    from detmatch_tpu_torch.ops.cuda import window_key_conv as wkc
    totals = dict.fromkeys(wkc.TILE_ROWS, 0.0)
    planned = 0.0
    for j, args in enumerate(k5):
        feats, keys, nkeys, w, _ = args
        k, c, co = w.shape
        shape = kc.rounded_shapes(0, 0, k, c, co)[1]
        want = wkc.tile_rows(*shape)
        ref, _ = kc.key_conv_fwd(feats, keys, nkeys, w, want)
        cells = []
        for rows in wkc.TILE_ROWS:
            if wkc.tile_smem_bytes(rows, *shape) > wkc.MAX_SMEM:
                continue
            a, _ = kc.key_conv_fwd(feats, keys, nkeys, w, rows)
            same = torch.equal(a, kc.key_conv_fwd(feats, keys, nkeys, w,
                                                  rows)[0])
            diff = float((a - ref).abs().max())
            ms = cs.cuda_ms(lambda: kc.key_conv_fwd(feats, keys, nkeys, w,
                                                    rows), reps=10)
            totals[rows] += ms
            planned += ms if rows == want else 0.0
            cells.append(f"{rows} rows {ms:.4f} ms (twice equal {same}, "
                         f"vs planned {diff:.2e})")
        print(f"  K5 conv {j}: K={k} C={c} Co={co} M={nkeys.shape[1]} plan "
              f"{want}: " + "; ".join(cells) + f" [{card}]")
    print("  K5 ms over the convs: " + ", ".join(
        f"{r} rows {ms:.3f}" for r, ms in totals.items())
        + f", planned {planned:.3f} [{card}]")


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    plans = "--plans" in sys.argv[1:]
    tree = Path(args[0] if args else ROOT).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("k4k5_plans.py runs on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(tree))
    cs = load_chip_smoke()
    card = cs.card_line()
    print(f"tree {tree} [{card}]", flush=True)
    from detmatch_tpu_torch.ops.cuda import build
    build.load_library()
    jv, k5 = record(cs)
    res = dict(tree=str(tree), card=card, k4={})
    with torch.no_grad():
        for label, cost, rv in jv:
            res["k4"][label] = cs.k4_line(label, cost, rv, card)
        cs.k4_step_floor(card)
        res["k5_ms"], res["k5_device_ms"] = cs.k5_breakdown(k5, card)
        if plans:
            k4_designs(cs, jv, card)
            k5_tiles(cs, k5, card)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
