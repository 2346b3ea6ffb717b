"""Time K6's forward on the 12 student convs of one DetMatch SSL
iteration's rulebook path and K8's gather on its student forward's
``pointnet.gather_rows`` calls (the operands ``chip_smoke.py`` replays),
each against its bound; with ``--plans``, K6's forward by both designs:
the port's bf16 tensor-core tile and the fp32 tile on bf16-rounded
operands (``k6k8_designs.cu``).

Run from the repository root, with one card visible:

    python3 tools/port_probes/k6k8_plans.py [TREE] [--plans]

TREE (default: this repository) is the root of the tree whose
``detmatch_tpu_torch`` (and whose kernels, built into its own
``build/kernels``) are timed, so that a parent commit unpacked with
``git archive`` and this tree can be compared inside one chip call; the
measuring code is this repository's ``chip_smoke.py`` either way. The
operands are recorded with the plain twins (``chip_smoke.ssl_model``,
its batch), so both trees get the same ones. ``--plans`` builds
``tools/port_probes/k6k8_designs.cu`` against this repository's
``csrc/gather_gemm.cuh`` with the port's nvcc flags into
``build/probes/``.
Printed: per call ms (CUDA events), device ms (``chip_smoke.device_ms``)
and bound; per K6 design its ms, device ms, its largest difference from
the twin over the twin's largest magnitude and whether two launches give
the same bits; then one JSON line of the sums.
"""
from __future__ import annotations

import copy
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
DESIGNS_SRC = Path(__file__).resolve().parent / "k6k8_designs.cu"


def load_chip_smoke():
    """This repository's chip_smoke.py as a module (its functions import
    ``detmatch_tpu_torch`` from the first tree on sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_k6k8",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record(cs):
    """(K6 operands (feats (B*N, C), flat rulebook (B*M, K), w), K8
    operands (x (B, N, C), idx (B, Q) int32)) of one SSL iteration's
    rulebook-path student forward, recorded through the plain twins."""
    from detmatch_tpu_torch.apis.build import build_ssl, build_voxelizer
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.models.pvrcnn import anchor_head
    from detmatch_tpu_torch.ops import pointnet
    from detmatch_tpu_torch.ops.cuda import PLAIN
    from detmatch_tpu_torch.train.ssl_step import (teacher_step,
                                                   to_device_views,
                                                   voxelize_views)

    cfg = Config.fromfile(str(cs.SSL_CONFIG))
    spec = build_voxelizer(cfg)
    canvas = tuple(cfg["model"]["detector_2d"]["canvas"])
    model = cs.ssl_model(cfg)
    rng = np.random.RandomState(cs.SEED)
    batch = voxelize_views(to_device_views(cs.ssl_batch_np(cfg, rng),
                                           cs.DEVICE), spec)
    for view in (batch["unlab"]["tea"], batch["unlab"]["stu"]):
        view["aug3d"], view["aug2d"] = cs.aug_records(
            rng, cs.SSL_B, canvas, view["ori_shape"][0].tolist())
    c = copy.deepcopy(cfg)
    det3d = c["model"]["detector_3d"]
    det3d["backbone3d_cfg"] = dict(det3d.get("backbone3d_cfg") or {},
                                   conv_impl="rulebook")
    m = build_ssl(c)
    m.load_state_dict(model.state_dict())
    m.train()
    del model
    calls, rows = [], []
    m.ops = cs.recording(PLAIN, calls)
    own = pointnet.gather_rows

    def record_gather(x, idx):
        rows.append((x.detach().contiguous(),
                     idx.detach().reshape(x.shape[0], -1).to(torch.int32)))
        return own(x, idx)

    with torch.no_grad():
        pseudo = teacher_step(m, batch)
        pointnet.gather_rows = anchor_head.gather_rows = record_gather
        try:
            m.student_losses_3d_concat(batch, pseudo, 0, torch.Generator(
                cs.DEVICE).manual_seed(cs.SEED))
        finally:
            pointnet.gather_rows = anchor_head.gather_rows = own
    convs = []
    for name, args, _, _ in calls:
        if name != "gather_conv_batched" or args[0].shape[0] != 2 * cs.SSL_B:
            continue
        feats, rb, w = args
        b, n, ch = feats.shape
        base = (torch.arange(b, dtype=torch.int32, device=rb.device)
                * n)[:, None, None]
        flat = torch.where(rb >= 0, rb + base, -1).reshape(-1, rb.shape[-1])
        convs.append((feats.reshape(b * n, ch), flat.contiguous(), w))
    return convs, rows


def designs_library():
    """k6k8_designs.cu built with the port's nvcc and arch flags into
    build/probes/, loaded with its C signature declared."""
    from detmatch_tpu_torch.ops.cuda import build
    out = ROOT / "build" / "probes" / "libk6k8_designs.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.ARCH, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-I",
                    str(ROOT / "detmatch_tpu_torch" / "csrc"), "-o",
                    str(out), str(DESIGNS_SRC)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_k6_fp32_tile.argtypes = (p, p, p, p, p, p, i, i, i, i, i, i, p)
    lib.probe_k6_fp32_tile.restype = ctypes.c_int
    return lib


def k6_designs(cs, convs, card):
    """Per conv: the port's K6 forward and the fp32-tile route, ms
    (events), device ms, largest difference from the twin over its
    largest magnitude, and two launches bit-equal. Returns the sums."""
    from detmatch_tpu_torch.ops.cuda import onehot_gather as og
    from detmatch_tpu_torch.ops.cuda import window_key_conv as wkc
    lib = designs_library()
    tot = dict(tc_ms=0.0, tc_dev=0.0, fp32_ms=0.0, fp32_dev=0.0)
    for j, (feats, flat, w) in enumerate(convs):
        n, c = feats.shape
        m, k = flat.shape
        co = w.shape[-1]
        c4, co4 = wkc.vec4(c), wkc.vec4(co)
        fr = torch.empty(n, c4, device=feats.device)
        wr = torch.empty(k, c4, co4, device=feats.device)
        out = torch.empty(m, co, device=feats.device)
        rows = wkc.tile_rows(k, c4, co4)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def fp32_tile():
            err = lib.probe_k6_fp32_tile(
                *(ctypes.c_void_p(t.data_ptr())
                  for t in (feats, flat, w, fr, wr, out)),
                n, m, k, c, co, rows, stream)
            if err:
                raise RuntimeError(f"fp32 tile: CUDA error {err}")
            return out.clone()

        ref = og.onehot_gather_forward_plain(feats, flat, w)
        scale = float(ref.abs().max())
        cells = []
        for label, fn in (("tc", lambda: og.onehot_gather_conv(feats, flat,
                                                                w)),
                          ("fp32", fp32_tile)):
            a, b = fn(), fn()
            torch.cuda.synchronize()
            err = float((a - ref).abs().max()) / max(scale, 1e-30)
            ms = cs.cuda_ms(fn, reps=10)
            dev = cs.device_ms(fn)
            tot[f"{label}_ms"] += ms
            tot[f"{label}_dev"] += dev
            cells.append(f"{label} {ms:.4f} ms, device {dev:.4f} (err "
                         f"{err:.2e}, twice bit-equal {torch.equal(a, b)})")
        print(f"  K6 design conv {j}: M={m} N={n} K={k} C={c} Co={co}: "
              + "; ".join(cells) + f" [{card}]")
    print(f"  K6 designs over {len(convs)} convs: bf16 tensor-core tile "
          f"{tot['tc_ms']:.3f} ms (device {tot['tc_dev']:.3f}), fp32 tile "
          f"on rounded operands {tot['fp32_ms']:.3f} ms (device "
          f"{tot['fp32_dev']:.3f}) [{card}]")
    return tot


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    plans = "--plans" in sys.argv[1:]
    tree = Path(args[0] if args else ROOT).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("k6k8_plans.py runs on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(tree))
    cs = load_chip_smoke()
    card = cs.card_line()
    print(f"tree {tree} [{card}]", flush=True)
    from detmatch_tpu_torch.ops.cuda import build
    from detmatch_tpu_torch.ops.cuda import onehot_gather as og
    from detmatch_tpu_torch.ops.cuda import onehot_rows as orows
    build.load_library()
    convs, rows = record(cs)
    res = dict(tree=str(tree), card=card, k6_calls=len(convs),
               k8_calls=len(rows))
    with torch.no_grad():
        for name, fn, calls, rate in (
                ("onehot_gather_conv", og.onehot_gather_conv, convs,
                 cs.BF16_FLOP_PER_S),
                ("onehot_take_rows_batched", orows.onehot_take_rows_batched,
                 rows, cs.FP32_FLOP_PER_S)):
            t = dict(ms=0.0, dev=0.0)
            for j, args in enumerate(calls):
                ms = cs.cuda_ms(lambda: fn(*args), reps=10)
                dev = cs.device_ms(lambda: fn(*args))
                t["ms"] += ms
                t["dev"] += dev
                b = {}
                cs.add_bound(b, *cs.work(name, args, {}), rate)
                cs.add_bound(t, *cs.work(name, args, {}), rate)
                print(f"  {name}[{j}] {[tuple(a.shape) for a in args]}: "
                      f"{ms:.4f} ms, device {dev:.4f} (bound "
                      f"{b['bound_ms']:.5f} by {b['bound_by']}) [{card}]")
            print(f"  {name} over {len(calls)} calls: {t['ms']:.3f} ms, "
                  f"device {t['dev']:.3f} (bound {t['bound_ms']:.4f}, "
                  f"{t['bound_ms'] / t['ms']:.1%}) [{card}]")
            res[name] = t
        if plans:
            res["k6_designs"] = k6_designs(cs, convs, card)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
