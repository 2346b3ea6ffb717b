"""Drive the PyTorch port's PV-RCNN inference once on a CUDA card, check
its CUDA kernels against their plain PyTorch twins, and time both.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases (any failure exits non-zero without printing the result line):
1. device — a CUDA card is required; prints its nvidia-smi name and
   power limit;
2. precision — TF32 off for matmuls and cuDNN convs;
3. build — compiles ``detmatch_tpu_torch/csrc/*.cu`` (timed);
4. kernels — every sparse-conv, FPS and ball-query call of the main path
   (B=4 synthetic KITTI frames of 16,384 points, 16,000-voxel cap, plus a
   B=3 batch with uneven valid counts), kernel against twin on the same
   inputs: integer outputs exactly equal, conv max relative error <= 1e-5;
5. end to end — full-width PV-RCNN from
   ``configs/detmatch/001/pretrain_pvrcnn/split_0.py`` with seeded random
   weights runs ``detect`` (all launch counters must move, outputs
   finite), then the kernel path is compared with the plain path on the
   card (B=4) and with the plain path on the CPU (B=1);
6. timing with CUDA events — B=1 latency, B=4 frames/s, each kernel
   against its twin;
7. a JSON line of the kernels, then the result line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs/detmatch/001/pretrain_pvrcnn/split_0.py"
SEED = 0
NUM_POINTS = 16384  # the BENCH=infer shape (bench.py:62)
CONV_RTOL = 1e-5
E2E_RTOL = 1e-4
MATCH_SHARE = 0.99
DEVICE = "cuda"

KERNEL_META = {
    "window_key_conv_batched": dict(
        source="detmatch_tpu_torch/csrc/window_key_conv.cu",
        replaces="detmatch_tpu/ops/pallas/window_key_conv.py:142"),
    "fps_batched": dict(
        source="detmatch_tpu_torch/csrc/fps.cu",
        replaces="detmatch_tpu/ops/pallas/fps.py:94"),
    "ball_query_batched": dict(
        source="detmatch_tpu_torch/csrc/ball_query.cu",
        replaces="detmatch_tpu/ops/pallas/ball_query.py:152"),
}


def phase(name):
    print(f"== {name}", flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a, b):
    if b.numel() == 0:
        return float("inf")
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))


def randomize_(model, seed):
    """Seeded random weights: fan-in scaled normal for conv/linear
    weights, BN affine near identity, BN running statistics randomized
    (var 0.5 + U[0,1), mean 0.2 N(0,1)) so BN is not the identity."""
    g = torch.Generator().manual_seed(seed)
    sd = model.state_dict()
    for k, v in sd.items():
        if not v.is_floating_point():
            continue
        if k.endswith("running_var"):
            new = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith("running_mean"):
            new = 0.2 * torch.randn(v.shape, generator=g)
        elif v.dim() == 1:
            base = 1.0 if k.endswith(".weight") else 0.0
            new = base + 0.1 * torch.randn(v.shape, generator=g)
        else:
            out = v.shape[-1] if v.dim() == 5 else v.shape[0]
            new = torch.randn(v.shape, generator=g) / np.sqrt(v.numel() / out)
        sd[k] = new.to(v.dtype)
    model.load_state_dict(sd)


def recording(base, calls):
    """An Ops whose functions log their arguments and call ``base``."""
    from detmatch_tpu_torch.ops.cuda import Ops

    def wrap(name, fn):
        def rec(*args, **kwargs):
            calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return rec

    return Ops(*(wrap(n, f) for n, f in zip(Ops._fields, base)))


def make_batch(spec, b, valid_counts=None):
    from detmatch_tpu_torch.ops.voxelize import voxelize_mean
    from detmatch_tpu_torch.utils.synth_kitti import lidar_batch
    rng = np.random.RandomState(SEED)
    pts, valid = lidar_batch(rng, b, NUM_POINTS, spec.point_cloud_range)
    if valid_counts is not None:
        for i, n in enumerate(valid_counts):
            valid[i, n:] = False
    points = torch.from_numpy(pts).to(DEVICE)
    points_valid = torch.from_numpy(valid).to(DEVICE)
    vox = voxelize_mean(points, points_valid, spec)
    return dict(points=points, points_valid=points_valid,
                voxel_features=vox["features"], voxel_keys=vox["keys"])


def check_kernels(calls, label, stats):
    """Run each recorded main-path call through kernel and twin."""
    from detmatch_tpu_torch.ops.cuda import KERNELS, PLAIN
    kern = dict(zip(KERNELS._fields, KERNELS))
    plain = dict(zip(PLAIN._fields, PLAIN))
    ok = True
    for i, (name, args, kwargs) in enumerate(calls):
        k_out = kern[name](*args, **kwargs)
        p_out = plain[name](*args, **kwargs)
        torch.cuda.synchronize()
        st = stats.setdefault(name, dict(max_abs_err=0.0, cases=0))
        st["cases"] += 1
        if name == "window_key_conv_batched":
            err = rel_err(k_out, p_out)
            st["max_abs_err"] = max(st["max_abs_err"],
                                    float((k_out - p_out).abs().max()))
            good = err <= CONV_RTOL
            desc = (f"rel_err={err:.3e} shape={tuple(k_out.shape)} "
                    f"taps={args[2].shape[-1]}")
        else:
            k_out = k_out if isinstance(k_out, tuple) else (k_out,)
            p_out = p_out if isinstance(p_out, tuple) else (p_out,)
            good = all(torch.equal(a, b) for a, b in zip(k_out, p_out))
            diff = max(int((a.long() - b.long()).abs().max())
                       for a, b in zip(k_out, p_out))
            st["max_abs_err"] = max(st["max_abs_err"], float(diff))
            extra = ""
            if name == "ball_query_batched":
                extra = (f" r={args[4]} ns={args[5]} "
                         f"mean_cnt={float(k_out[1].float().mean()):.2f}")
            desc = (f"exact={good} shape={tuple(k_out[0].shape)}{extra}")
        print(f"  {label} {name}[{i}] {desc} {'ok' if good else 'FAIL'}")
        ok &= good
    return ok


def compare_dense(out_k, out_p):
    """Keypoints exactly, and every output before the proposal NMS."""
    ok = torch.equal(out_k["keypoints"], out_p["keypoints"])
    print(f"  keypoints exactly equal: {ok}")
    pairs = [(f"backbone.{n}.feats", out_k["backbone"][n]["feats"],
              out_p["backbone"][n]["feats"]) for n in out_k["backbone"]]
    pairs += [(k, out_k[k], out_p[k]) for k in (
        "spatial_features", "bev_features", "batch_box_preds",
        "batch_cls_preds", "point_logits", "point_features")]
    for name, a, b in pairs:
        ok &= report(name, rel_err(a, b))
    return ok


def report(name, err):
    good = err <= E2E_RTOL
    print(f"  {name}: rel_err={err:.3e} {'ok' if good else 'FAIL'}")
    return good


def roi_share(out_k, out_p):
    """Share of proposal slots holding the same roi (within tolerance)."""
    roi_err = (out_k["rois"] - out_p["rois"]).abs().amax(-1)
    same = roi_err <= E2E_RTOL * out_p["rois"].abs().max()
    return same, float(same.float().mean())


def compare_paths(out_k, out_p):
    """Kernel path against plain path on the same card."""
    ok = compare_dense(out_k, out_p)
    same, share = roi_share(out_k, out_p)
    print(f"  rois matching within {E2E_RTOL:g}: {share:.4f} of slots")
    ok &= share >= MATCH_SHARE
    for k in ("rcnn_cls", "rcnn_reg"):
        ok &= report(f"{k} on matching rois",
                     rel_err(out_k[k][same], out_p[k][same]))
    return ok


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def match_share(det_k, det_p):
    """Share of valid detections with a counterpart on the other path
    (same label, box within 1e-3, score within 1e-4)."""
    matched = total = 0
    for b in range(det_k["boxes"].shape[0]):
        vk, vp = det_k["valid"][b], det_p["valid"][b]
        bk, bp = det_k["boxes"][b][vk], det_p["boxes"][b][vp]
        sk, sp = det_k["scores"][b][vk], det_p["scores"][b][vp]
        lk, lp = det_k["labels"][b][vk], det_p["labels"][b][vp]
        total += max(len(bk), len(bp))
        if len(bk) == 0 or len(bp) == 0:
            continue
        close = (((bk[:, None] - bp[None]).abs().amax(-1) <= 1e-3)
                 & ((sk[:, None] - sp[None]).abs() <= 1e-4)
                 & (lk[:, None] == lp[None]))
        matched += int(close.any(1).sum())
    return matched / max(total, 1), total


def run():
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase("precision")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 off (matmul, cudnn)")

    sys.path.insert(0, str(ROOT))
    from detmatch_tpu_torch.apis.build import build_detector, build_voxelizer
    from detmatch_tpu_torch.apis.inference import detect
    from detmatch_tpu_torch.config import Config
    from detmatch_tpu_torch.ops import cuda as cuda_ops
    from detmatch_tpu_torch.ops.cuda import KERNELS, PLAIN, build
    from detmatch_tpu_torch.ops.voxelize import INVALID_KEY

    phase("build")
    t0 = time.perf_counter()
    res = build.build()
    build.load_library()
    print(f"built={res.built} nvcc_s={res.seconds:.2f} "
          f"total_s={time.perf_counter() - t0:.2f} -> {res.path.name}")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    cfg = Config.fromfile(str(CONFIG))
    spec = build_voxelizer(cfg)
    model = build_detector(cfg, device=DEVICE)
    randomize_(model, SEED)
    batch4 = make_batch(spec, 4)
    batch3 = make_batch(spec, 3, valid_counts=(NUM_POINTS, 9000, 4000))
    for b, bt in ((4, batch4), (3, batch3)):
        n_vox = (bt["voxel_keys"] != INVALID_KEY).sum(1).tolist()
        print(f"voxels per frame B={b}: {n_vox}")

    phase("kernels against plain twins (main-path shapes)")
    stats = {}
    calls4, calls3 = [], []
    with torch.inference_mode():
        model.ops = recording(PLAIN, calls4)
        model(batch4)
        model.ops = recording(PLAIN, calls3)
        model(batch3)
        model.ops = KERNELS
        ok = check_kernels(calls4, "B=4", stats)
        ok &= check_kernels(calls3, "B=3", stats)
    counts = {n: sum(c[0] == n for c in calls4) for n in KERNEL_META}
    print(f"calls per forward: {counts}")
    if not ok:
        raise AssertionError("a kernel disagrees with its plain twin")

    phase("end to end (kernel path)")
    with torch.inference_mode():
        cuda_ops.reset_launch_counts()
        det_k = detect(model, batch4["points"], batch4["points_valid"], spec,
                       score_thresh=0.0)
        torch.cuda.synchronize()
        launches = cuda_ops.launch_counts()
    print(f"launches in detect(): {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError("a kernel of the path was not launched")
    n_valid = det_k["valid"].sum(1).tolist()
    finite = all(bool(torch.isfinite(det_k[k]).all())
                 for k in ("boxes", "scores"))
    print(f"detections per frame: {n_valid} finite={finite} "
          f"boxes {tuple(det_k['boxes'].shape)}")
    if not finite or min(n_valid) == 0:
        raise AssertionError("non-finite or empty detections")

    phase("end to end (kernel path against plain path)")
    with torch.inference_mode():
        model.ops = KERNELS
        out_k = model(batch4)
        model.ops = PLAIN
        out_p = model(batch4)
        det_p = detect(model, batch4["points"], batch4["points_valid"], spec,
                       score_thresh=0.0)
        model.ops = KERNELS
    ok = compare_paths(out_k, out_p)
    share, total = match_share(det_k, det_p)
    print(f"  detections matched: {share:.4f} of {total}")
    if not ok or share < MATCH_SHARE:
        raise AssertionError("kernel path disagrees with the plain path")

    phase("end to end (kernel path on the card against plain path on "
          "the CPU, B=1)")
    batch1 = {k: v[:1] for k, v in batch4.items()}
    cpu_model = build_detector(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    with torch.inference_mode():
        out_k1 = to_cpu(model(batch1))
        out_c1 = cpu_model({k: v.cpu() for k, v in batch1.items()})
        # the RoI head on the card's own proposals: random weights give
        # densely tied proposal scores, and 1e-6 noise between devices
        # reorders them at the top-k / NMS cut
        rcnn_c1 = cpu_model.roi_head(
            out_k1["rois"], out_k1["keypoints"], out_k1["kp_valid"],
            out_k1["point_features"], out_k1["point_scores"])
    ok = compare_dense(out_k1, out_c1)
    for k, ref in zip(("rcnn_cls", "rcnn_reg"), rcnn_c1):
        ok &= report(f"{k} on the same rois", rel_err(out_k1[k], ref))
    _, share = roi_share(out_k1, out_c1)
    print(f"  proposal slots equal across devices: {share:.4f} "
          "(information: NMS order under 1e-6 score noise)")
    if not ok:
        raise AssertionError("kernel path disagrees with the CPU reference")

    phase(f"timing (CUDA events) on {card}")
    timing = {}
    with torch.inference_mode():
        for path, ops in (("kernel", KERNELS), ("plain", PLAIN)):
            model.ops = ops
            for b, bt in ((1, batch1), (4, batch4)):
                ms = cuda_ms(lambda: detect(model, bt["points"],
                                            bt["points_valid"], spec,
                                            score_thresh=0.0), reps=5)
                timing[(path, b)] = ms
                print(f"  {path} path B={b}: {ms:.3f} ms/call "
                      f"({1000.0 * b / ms:.3f} frames/s) [{card}]")
        model.ops = KERNELS
        kern = dict(zip(KERNELS._fields, KERNELS))
        plain = dict(zip(PLAIN._fields, PLAIN))
        per_kernel = {n: dict(ms=0.0, plain_ms=0.0) for n in KERNEL_META}
        for name, args, kwargs in calls4:
            k_ms = cuda_ms(lambda: kern[name](*args, **kwargs), reps=10)
            p_ms = cuda_ms(lambda: plain[name](*args, **kwargs), reps=3)
            per_kernel[name]["ms"] += k_ms
            per_kernel[name]["plain_ms"] += p_ms
        for name, t in per_kernel.items():
            print(f"  {name}: {t['ms']:.3f} ms per forward "
                  f"(plain {t['plain_ms']:.3f} ms, {counts[name]} calls, "
                  f"B=4) [{card}]")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=meta["source"],
             replaces=meta["replaces"], launches=launches[name],
             max_abs_err=stats[name]["max_abs_err"],
             ms=per_kernel[name]["ms"], plain_ms=per_kernel[name]["plain_ms"])
        for name, meta in KERNEL_META.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main():
    try:
        run()
    except Exception:  # report the failing phase, never the result line
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
