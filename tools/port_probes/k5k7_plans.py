"""Time K7 (rulebook gather-GEMM) on the 12 student convs of one DetMatch
SSL iteration's rulebook path, K5's backward (S of the key-compare
conv) on the 12 student convs of its key path and K1 (forward and
backward) on the 12 of its window path, pass by pass; with ``--plans``,
K7 per tile height and K5's backward per design.

Run from the repository root, with one card visible:

    python3 tools/port_probes/k5k7_plans.py [TREE] [--plans]

TREE (default: this repository) is the root of the tree whose
``detmatch_tpu_torch`` (and whose kernels, built into its own
``build/kernels``) are timed, so that a parent commit unpacked with
``git archive`` and this tree can be compared inside one chip call; the
measuring code is this repository's ``chip_smoke.py`` either way. The
convs are recorded with the plain twins (``chip_smoke.ssl_model``, its
batch, B=8 student convs), so both trees get the same ones. K5's
backward reads the forward's rulebook (``spconv.rulebook_batched`` of
the recorded keys, which the forward kernel's equals) where the tree's
kernel takes it, and the keys where it searches them (the earlier
design).
``--plans`` needs this tree's K7 (``gather_conv.gather_conv_fwd``) and
K5 backward (``key_conv.key_conv_bwd`` on the rulebook), and builds
``tools/port_probes/k5_bwd_designs.cu`` (other designs of that backward)
with the port's nvcc flags into ``build/probes/``.
Printed: ``chip_smoke.k7_breakdown``, ``chip_smoke.k5_bwd_breakdown``
(ms, device ms, passes, library ms, bound) and ``chip_smoke.k1_breakdown``
(K1 forward and backward ms, the backward's passes; the window path's
convs recorded with autograd on, so that each says whether it needs dF,
as in ``chip_smoke.py``); with ``--plans`` each K7
conv's ms at 32, 64 and 128 rows a block, bit-equal to the planned
tile, and each K5 backward design's device ms, equal to the port's S;
then one JSON line of the sums.
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
DESIGNS_SRC = Path(__file__).resolve().parent / "k5_bwd_designs.cu"
# the designs of k5_bwd_designs.cu, by number
K5_BWD_DESIGNS = ("rows a block step, 4 in flight, streaming stores",
                  "the same, plain stores", "one step in flight",
                  "flat float4 index", "a warp per 32 rows",
                  "zero fill + matched rows", "zero fill alone (not S)")


def load_chip_smoke():
    """This repository's chip_smoke.py as a module (its functions import
    ``detmatch_tpu_torch`` from the first tree on sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_k5k7",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record(cs):
    """(K7 student argument tuples, K5 student argument tuples, K1 student
    (argument tuple, needs dF)) of one SSL iteration's rulebook, key and
    window paths, recorded through the plain twins."""
    from detmatch_tpu_torch.apis.build import build_ssl, build_voxelizer
    from detmatch_tpu_torch.config import Config
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
    out = {}
    for impl, name in (("rulebook", "gather_conv_batched"),
                       ("key", "key_conv_batched"),
                       ("window", "window_key_conv_batched")):
        c = copy.deepcopy(cfg)
        det3d = c["model"]["detector_3d"]
        det3d["backbone3d_cfg"] = dict(det3d.get("backbone3d_cfg") or {},
                                       conv_impl=impl)
        m = build_ssl(c)
        m.load_state_dict(model.state_dict())
        m.train()
        calls = []
        m.ops = cs.recording(PLAIN, calls)
        with torch.no_grad():
            pseudo = teacher_step(m, batch)
        # with autograd on for the window path: its record says which
        # convs need dF
        with torch.set_grad_enabled(impl == "window"):
            m.student_losses_3d_concat(batch, pseudo, 0, torch.Generator(
                cs.DEVICE).manual_seed(cs.SEED))
        out[impl] = [(c[1], c[3]) if impl == "window" else c[1]
                     for c in calls if c[0] == name
                     and c[1][0].shape[0] == 2 * cs.SSL_B]
        del m, calls
    return out["rulebook"], out["key"], out["window"]


def k1_cases(k1):
    """(args, needs dF, dout, rb) of each K1 student conv: a seeded
    cotangent and the plain rulebook, as ``chip_smoke.k1_breakdown``
    takes them."""
    from detmatch_tpu_torch.ops import spconv
    g = torch.Generator("cuda").manual_seed(0)
    cases = []
    for args, need in k1:
        feats, keys, nkeys, _, w, _ = args
        dout = torch.randn(feats.shape[0], nkeys.shape[1], w.shape[-1],
                           generator=g, device="cuda")
        cases.append((args, need, dout,
                      spconv.rulebook_batched(keys, nkeys)))
    return cases


def k5_cases(k5):
    """(dout, keys, nkeys, rb) of each K5 student conv: a seeded
    cotangent and the plain rulebook."""
    from detmatch_tpu_torch.ops import spconv
    g = torch.Generator("cuda").manual_seed(0)
    cases = []
    for feats, keys, nkeys, w, _ in k5:
        dout = torch.randn(feats.shape[0], nkeys.shape[1], w.shape[-1],
                           generator=g, device="cuda")
        cases.append((dout, keys, nkeys,
                      spconv.rulebook_batched(keys, nkeys)))
    return cases


def k5_scatter(kc):
    """The tree's K5 backward as scatter(dout, keys, nkeys, rb)."""
    if hasattr(kc, "key_scatter_from_rulebook_plain"):  # reads rb
        return lambda dout, keys, nkeys, rb: kc.key_conv_bwd(
            dout, rb, keys.shape[1])
    return lambda dout, keys, nkeys, rb: kc.key_conv_bwd(dout, keys, nkeys)


def k7_tiles(cs, k7, card):
    """K7's ms at each tile height on each student conv, bit-equal to the
    planned tile."""
    from detmatch_tpu_torch.ops.cuda import gather_conv as gc
    from detmatch_tpu_torch.ops.cuda import window_key_conv as wkc
    totals = dict.fromkeys(wkc.TILE_ROWS, 0.0)
    planned = 0.0
    for j, (feats, rb, w) in enumerate(k7):
        k, c, co = w.shape
        want = gc.k7_tile_rows(k, c, co)
        ref = gc.gather_conv_fwd(feats, rb, w)
        cells = []
        for rows in wkc.TILE_ROWS:
            if wkc.tile_smem_bytes(rows, k, c, co) > wkc.MAX_SMEM:
                continue
            same = torch.equal(gc.gather_conv_fwd(feats, rb, w, rows), ref)
            ms = cs.cuda_ms(lambda: gc.gather_conv_fwd(feats, rb, w, rows),
                            reps=10)
            totals[rows] += ms
            planned += ms if rows == want else 0.0
            cells.append(f"{rows} rows {ms:.4f} ms (equal to planned "
                         f"{same})")
        print(f"  K7 conv {j}: K={k} C={c} Co={co} M={rb.shape[1]} plan "
              f"{want}: " + "; ".join(cells) + f" [{card}]")
    print("  K7 ms over the convs: " + ", ".join(
        f"{r} rows {ms:.3f}" for r, ms in totals.items())
        + f", planned {planned:.3f} [{card}]")


def designs_library():
    """k5_bwd_designs.cu built with the port's nvcc and arch flags into
    build/probes/, loaded with its C signature declared."""
    from detmatch_tpu_torch.ops.cuda import build
    out = ROOT / "build" / "probes" / "libk5_bwd_designs.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.ARCH, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(out),
                    str(DESIGNS_SRC)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_k5_bwd.argtypes = (i, p, p, p, p, i, i, i, i, i, p)
    lib.probe_k5_bwd.restype = ctypes.c_int
    return lib


def k5_bwd_designs(cs, cases, card):
    """Device ms of each K5 backward design on each student conv (the
    port's kernel through its wrapper first), and whether it wrote the
    port's S."""
    from detmatch_tpu_torch.ops.cuda import key_conv as kc
    lib = designs_library()
    totals = [0.0] * (len(K5_BWD_DESIGNS) + 1)
    for j, (dout, keys, nkeys, rb) in enumerate(cases):
        b, n = keys.shape
        m, k, co = nkeys.shape[1], nkeys.shape[2], dout.shape[-1]
        ref = kc.key_conv_bwd(dout, rb, n)
        ms = cs.device_ms(lambda: kc.key_conv_bwd(dout, rb, n))
        totals[0] += ms
        cells = [f"port {ms:.4f}"]
        inv = torch.empty(k * b * n, dtype=torch.int32, device=dout.device)
        s = torch.empty_like(ref)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for d, name in enumerate(K5_BWD_DESIGNS):
            def run():
                err = lib.probe_k5_bwd(
                    d, ctypes.c_void_p(dout.data_ptr()),
                    ctypes.c_void_p(rb.data_ptr()),
                    ctypes.c_void_p(inv.data_ptr()),
                    ctypes.c_void_p(s.data_ptr()), b, n, m, k, co, stream)
                if err:
                    raise RuntimeError(f"design {d}: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            same = "" if d == 6 or torch.equal(s, ref) else " NOT S"
            ms = cs.device_ms(run)
            totals[d + 1] += ms
            cells.append(f"{d} {ms:.4f}{same}")
        print(f"  K5 bwd conv {j}: K={k} N={n} M={m} Co={co}: device ms "
              + "; ".join(cells) + f" [{card}]")
        del ref, inv, s
    print("  K5 bwd device ms over the convs: port " + f"{totals[0]:.3f}; "
          + "; ".join(f"{d} ({name}) {t:.3f}" for d, (name, t) in
                      enumerate(zip(K5_BWD_DESIGNS, totals[1:])))
          + f" [{card}]")


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    plans = "--plans" in sys.argv[1:]
    tree = Path(args[0] if args else ROOT).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("k5k7_plans.py runs on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(tree))
    cs = load_chip_smoke()
    card = cs.card_line()
    print(f"tree {tree} [{card}]", flush=True)
    from detmatch_tpu_torch.ops.cuda import build
    from detmatch_tpu_torch.ops.cuda import gather_conv as gc
    from detmatch_tpu_torch.ops.cuda import key_conv as kc
    build.load_library()
    k7, k5, k1 = record(cs)
    rows = getattr(gc, "k7_tile_rows", None)
    res = dict(tree=str(tree), card=card)
    with torch.no_grad():
        res["k7_ms"], res["k7_device_ms"] = cs.k7_breakdown(k7, card, rows)
        cases = k5_cases(k5)
        del k5
        res["k5_bwd"] = cs.k5_bwd_breakdown(cases, card, k5_scatter(kc))
        if plans:
            k7_tiles(cs, k7, card)
            k5_bwd_designs(cs, cases, card)
        del cases
        res["k1"] = cs.k1_breakdown(k1_cases(k1), card)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
