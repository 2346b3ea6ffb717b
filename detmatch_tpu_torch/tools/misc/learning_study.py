"""Proof that the port's SSL machinery learns, end to end, on synthetic
data (counterpart of ``tools/misc/learning_study.py``).

The parity tests hold one step or one iteration against JAX; this study
runs the whole loop for thousands of iterations: the EMA teacher over
time, the SSL weight's ramp-up, the warm-up learning rate, checkpoints
and resume, batch-norm recalibration and evaluation on held-out frames.
On a generated mini-KITTI tree (randomized scenes, held-out val split:
``utils/synth_kitti.make_kitti_random``) it runs, at the tiny config's
scale made learnable (:func:`build_cfg`):

  A. labeled-only: the SSL loop with ``ssl_weight=0`` (the supervised
     signal of the labeled split alone) for N iterations;
  B. DetMatch SSL: the full loop (teacher pseudo-labels, fusion,
     consistency, EMA) on the labeled and unlabeled splits for N
     iterations, from the same random initialisation;

and evaluates {init, A, B} x {student, teacher} on the held-out split
with the KITTI AP-R40 evaluator. The criteria (JAX's):

  * run A's train loss falls (first-quartile mean > last-quartile mean);
  * run B's 3D mAP (moderate) beats the initialisation's teacher;
  * run B's 3D mAP (moderate) is at least run A's.

Writes ``docs/learning_study_torch.json``: JAX's report keys (the curves,
the APs and ``num_dets``) and ``run`` (the card, the predictions' metrics:
ms an iteration, wall time, peak memory, the kernels' launches, and run
A's largest loss spike). Run:

    python -m detmatch_tpu_torch.tools.misc.learning_study [--iters N]
        [--out PATH] [--keep] [--data-root DIR] [--device cuda|cpu]
        [--arm labonly|ssl]

``--data-root`` reuses a tree from a cut run: its checkpoints resume
training and its ``evals.json`` returns finished evaluations. ``--arm``
trains and evaluates one arm only and reads the other's results (its
``evals.json`` entry, ``run_<arm>/log.json`` and ``run_<arm>/run.json``)
from the data root; the report is written once both arms have one. On
one H100 an arm of 3,000 iterations takes most of an hour, host-bound,
so the two arms can run in two processes at once on one card, on one
data root (write the tree first with :func:`make_data`): the process
that finishes last writes the report.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
TINY_CONFIG = os.path.join(REPO, "configs", "tests", "ssl_tiny.py")
DEFAULT_OUT = os.path.join(REPO, "docs", "learning_study_torch.json")

# (frames, seed, first frame id) of each split: 12 labeled scenes (at 6,
# JAX's model plateaued at val IoU3D ~0.3-0.5, under KITTI's 0.7 Car
# bar), 24 unlabeled, 8 held out
SPECS = dict(lab=(12, 0, 0), unlab=(24, 100, 200), val=(8, 500, 400))
RECAL_PASSES = 300
RECAL_SAMPLES = 8
# low score floors: AP sweeps thresholds, and a small model's scores can
# sit below the production 0.1 floor, which truncates the PR curve to
# AP 0; echoed into the report so its APs are never compared with evals
# at the 0.1 / 0.05 defaults
SCORE_THRESH_3D = 0.01
SCORE_THR_2D = 0.01
KEY = "3d.mAP_3d_moderate"
ARMS = ("labonly", "ssl")
# the kernels of the study's path (the window conv path)
STUDY_KERNELS = ("window_key_conv_batched", "window_key_conv_bwd",
                 "ball_query_batched", "fps_batched",
                 "solve_masked_batched")


def make_data(root):
    """The lab (12) / unlab (24) / val (8) randomized scenes under
    ``root`` and their info pkls ``kitti_infos_<split>.pkl``; returns
    {split: pkl path}. Cars only, 1-4 a scene, yaws within +-0.35 rad
    (near-axis, as KITTI traffic, which the anchor recipe assumes). An
    existing pkl (a ``--data-root`` rerun) is reused as it is."""
    from ...data import kitti
    from ...utils.synth_kitti import make_kitti_random

    paths = {}
    for name, (n, seed, start) in SPECS.items():
        p = os.path.join(root, f"kitti_infos_{name}.pkl")
        if not os.path.exists(p):
            split = make_kitti_random(root, n, seed=seed, split=name,
                                      start_idx=start, max_objects=4,
                                      classes=("Car",),
                                      yaw_range=(-0.35, 0.35))
            infos = kitti.create_infos(root, split, training=True)
            with open(p, "wb") as f:
                pickle.dump(infos, f)
        paths[name] = p
    return paths


def build_cfg(root, paths, iters, ssl_weight, work_dir, seed):
    """``configs/tests/ssl_tiny.py`` on the study's tree, made learnable
    as JAX's study makes it: 4,096 points a cloud (ssl_tiny's 256 cut the
    clouds to background), 0.125 m voxels on a (128, 128, 40) grid (1 m
    anchor spacing), 128 keypoints, backbone caps following the 4,096
    voxels, a 96 x 320 canvas (cars inside the 2D anchor pyramid), small
    3D augmentation ranges, B = 2 + 2, a log line every iters / 40, a
    checkpoint every iters / 4, no in-loop evaluation, and the SSL weight
    ``ssl_weight`` ramped in over the first third."""
    from ...config import Config

    cfg = Config.fromfile(TINY_CONFIG)
    d = cfg["data"]
    for split, key in (("train_lab", "lab"), ("train_unlab", "unlab")):
        d[split]["dataset"]["data_root"] = root
        d[split]["dataset"]["ann_file"] = paths[key]
    d["val"]["data_root"] = root
    d["val"]["ann_file"] = paths["val"]
    cfg["data"]["collate"]["max_points"] = 4096
    vs = [0.125, 0.125, 0.1]
    pcr = cfg["point_cloud_range"]
    cfg["voxelizer"] = dict(point_cloud_range=pcr, voxel_size=vs,
                            max_voxels=4096, max_points=5)
    m3 = cfg["model"]["detector_3d"]
    m3["voxel_size"] = tuple(vs)
    m3["grid_size"] = (128, 128, 40)
    m3["num_keypoints"] = 128
    m3["backbone_caps"] = (4096, 4096, 2048, 2048)
    canvas = (96, 320)
    cfg["model"]["detector_2d"]["canvas"] = canvas
    scale_wh = (canvas[1], canvas[0])
    for split in ("train_lab", "train_unlab"):
        for key in ("shared_pipeline", "student_pipeline",
                    "teacher_pipeline"):
            for step in d[split].get(key, []):
                if step.get("type") == "Resize":
                    step["img_scale"] = (scale_wh, scale_wh)
                if step.get("type") == "PadToCanvas":
                    step["canvas"] = canvas
                if step.get("type") == "GlobalRotScaleTrans":
                    step["rot_range"] = (-0.15, 0.15)
                    step["scale_ratio_range"] = (0.98, 1.02)
    for step in d["val"]["pipeline"]:
        if step.get("type") == "PadToCanvas":
            step["canvas"] = canvas
    cfg["max_iters"] = iters
    cfg["batch_size"] = 2
    cfg["num_unlabeled_samples"] = 2
    cfg["log_interval"] = max(1, iters // 40)
    cfg["ckpt_interval"] = max(1, iters // 4)
    cfg["evaluation"] = None
    cfg["ssl"] = dict(cfg.get("ssl", {}), ssl_weight=ssl_weight,
                      ssl_weight_rampup_start_iter=0,
                      ssl_weight_rampup_num_iter=max(1, iters // 3))
    cfg["work_dir"] = work_dir
    return cfg


def build_models(cfg, seed=0, device="cuda"):
    """The SSL detector of ``cfg`` with the models' own initialisers
    seeded from ``seed`` (the same weights for every arm), and its
    voxelizer spec."""
    from ...apis import build

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        ssl = build.build_ssl(cfg, device=device)
    return ssl, build.build_voxelizer(cfg)


def run_training(cfg, seed=0, device="cuda"):
    """One arm: ``train_ssl`` on the labeled and unlabeled splits at the
    study's rates (``lr_3d`` 4e-3, ``lr_2d`` 1e-2: the batch-scaled
    defaults diverge at this scale), a warm-up of ``max(50, iters //
    10)``, resumed from the latest checkpoint under ``work_dir/ckpt``
    where there is one (at ``max_iters`` no iteration runs). Returns
    (ssl, vox, this call's iteration logs)."""
    from ...apis import build
    from ...apis.train_ssl import train_ssl
    from ...data.collate import collate_ts
    from ...train import checkpoints

    rng = np.random.RandomState(seed)
    ssl, vox = build_models(cfg, seed, device)
    lab = build.build_dataset(cfg["data"]["train_lab"], rng=rng)
    unlab = build.build_dataset(cfg["data"]["train_unlab"], rng=rng)
    ck = dict(cfg["data"].get("collate", {}))
    ckpt_dir = os.path.join(cfg["work_dir"], "ckpt")
    step = checkpoints.latest_step(ckpt_dir)
    if step:
        print(f"[train] resuming from {ckpt_dir} @ {step}", flush=True)
    ssl, _, history = train_ssl(
        ssl, vox, lab, unlab, lambda s: collate_ts(s, **ck),
        cfg["work_dir"], max_iters=cfg["max_iters"],
        batch_size=cfg["batch_size"],
        lr_3d=cfg.get("lr_3d", 4e-3), lr_2d=cfg.get("lr_2d", 1e-2),
        num_unlabeled=cfg["num_unlabeled_samples"], seed=seed,
        log_interval=cfg["log_interval"],
        ckpt_interval=cfg["ckpt_interval"],
        resume_from=ckpt_dir if step else None,
        warmup_iters=cfg.get("warmup_iters",
                             max(50, cfg["max_iters"] // 10)))
    return ssl, vox, history


def recalibration_samples(cfg):
    """The recalibration's collated numpy batches: the first
    ``RECAL_SAMPLES`` labeled samples in pairs, drawn with
    ``RandomState(123)`` (JAX's ``recalibrate``)."""
    from ...apis import build
    from ...data.collate import collate_ts

    lab = build.build_dataset(cfg["data"]["train_lab"],
                              rng=np.random.RandomState(123))
    ck = dict(cfg["data"].get("collate", {}))
    n = len(lab)
    return [collate_ts([lab[s0], lab[(s0 + 1) % n]], **ck)
            for s0 in range(0, min(n, RECAL_SAMPLES), 2)]


def recalibration_batches(cfg, vox, device):
    """:func:`recalibration_samples`' student views, voxelized, on
    ``device``."""
    from ...train.ssl_step import to_device_views, voxelize_views

    return [voxelize_views(to_device_views(dict(lab=b), device),
                           vox)["lab"]["stu"]
            for b in recalibration_samples(cfg)]


def recalibrate(cfg, ssl, vox, passes=RECAL_PASSES):
    """Refresh the student's and then the teacher's PV-RCNN batch-norm
    running statistics with frozen weights (``apis.evaluate.
    recalibrate_batch_stats``): ``passes`` train-mode forwards cycling
    through :func:`recalibration_batches`. BN momentum 0.01 averages over
    ~100 iterations, which at the study's horizon still cover a moving
    training phase."""
    from ...apis.evaluate import recalibrate_batch_stats

    device = next(ssl.parameters()).device
    batches = recalibration_batches(cfg, vox, device)
    for half in (ssl.student, ssl.teacher):
        recalibrate_batch_stats(half["det3d"], batches, passes=passes)
    print(f"[recal] BN stats refreshed ({passes} passes)", flush=True)
    return ssl


def eval_cache_key(key):
    """The ``evals.json`` key of a stage, JAX's: the score floors folded
    in, ``r1`` for the recalibrated protocol."""
    return f"{key}@f{SCORE_THRESH_3D}/{SCORE_THR_2D}r1"


def run_eval(cfg, ssl, vox, cache=None, cache_key=None):
    """``eval_ssl`` on the val split at the study's score floors. With
    ``cache`` (a directory) and ``cache_key`` the result is read from, or
    else written to, ``cache/evals.json`` under :func:`eval_cache_key`."""
    from ...apis import build
    from ...apis.evaluate import eval_ssl
    from ...data.collate import collate_view

    path = stored = None
    if cache and cache_key:
        cache_key = eval_cache_key(cache_key)
        path = os.path.join(cache, "evals.json")
        stored = {}
        if os.path.exists(path):
            with open(path) as f:
                stored = json.load(f)
        if cache_key in stored:
            print(f"[eval] reusing cached result {cache_key!r}",
                  flush=True)
            return stored[cache_key]
    val = build.build_dataset(cfg["data"]["val"],
                              rng=np.random.RandomState(0))
    ck = dict(cfg["data"].get("collate", {}))
    res = eval_ssl(ssl, val, lambda s: collate_view(s, **ck), vox,
                   score_thresh_3d=SCORE_THRESH_3D, score_thr_2d=SCORE_THR_2D)
    res = {k: float(v) for k, v in res.items()}
    if path:
        _store_eval(path, cache_key, res)
    return res


def _store_eval(path, key, res):
    """Add ``key: res`` to the ``evals.json`` at ``path`` under a file
    lock, merged with what the file holds then: the two arms may run at
    once, in two processes, on one data root."""
    import fcntl
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        stored = {}
        if os.path.exists(path):
            with open(path) as f:
                stored = json.load(f)
        stored[key] = res
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(stored, f)
        os.replace(tmp, path)


def init_state(cfg, seed=0, device="cuda"):
    """The untrained SSL detector (both arms' start) and its voxelizer."""
    return build_models(cfg, seed, device)


def _train_lines(work_dir):
    """The ``mode == "train"`` entries of ``work_dir/log.json``."""
    with open(os.path.join(work_dir, "log.json")) as f:
        entries = [json.loads(line) for line in f if line.strip()]
    return [e for e in entries if e.get("mode") == "train"]


def loss_curve(work_dir):
    """[(iter, loss)] of the train lines of ``work_dir/log.json``."""
    return [(e["iter"], float(e["loss"])) for e in _train_lines(work_dir)]


def iteration_seconds(work_dir):
    """The ``time`` (seconds an iteration, averaged over a log interval)
    of every train line of ``work_dir/log.json`` but the first (the
    first interval holds the warm-up)."""
    return [float(e["time"]) for e in _train_lines(work_dir)][1:]


def quartile_means(curve):
    """(mean of the first quarter, mean of the last quarter) of a curve's
    losses."""
    v = np.array([loss for _, loss in curve])
    q = max(1, len(v) // 4)
    return float(v[:q].mean()), float(v[-q:].mean())


def largest_spike(curve):
    """Run A's largest logged loss after its first log line: (iter, loss,
    loss over the curve's median) (``VERDICT.md`` Weak #3: JAX's
    labeled-only loss reached 14.16 at iteration 600)."""
    if len(curve) < 2:
        return None
    it, loss = max(curve[1:], key=lambda c: c[1])
    return dict(iter=int(it), loss=float(loss), over_median=float(
        loss / np.median([x for _, x in curve])))


def card_line():
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def _launches():
    from ...ops import cuda as cuda_ops
    counts = cuda_ops.launch_counts()
    return {k: counts[k] for k in STUDY_KERNELS}


def _reset():
    from ...ops import cuda as cuda_ops
    cuda_ops.reset_launch_counts()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def _measure(device):
    """(peak GiB since :func:`_reset`, the study kernels' launches) on the
    card; (None, launches) elsewhere."""
    if torch.device(device).type != "cuda":
        return None, _launches()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 30, _launches()


def _arm(name, cfg, seed, device, passes, cache, iters):
    """Train, recalibrate and evaluate one arm; (APs, its run record)."""
    _reset()
    t0 = time.perf_counter()
    ssl, vox, history = run_training(cfg, seed, device)
    train_s = time.perf_counter() - t0
    peak, launches = _measure(device)
    print(f"[train] {name}: {len(history)} iterations in {train_s:.1f} s; "
          f"launches {launches}; peak "
          f"{'not measured' if peak is None else f'{peak:.3f} GiB'}",
          flush=True)
    t0 = time.perf_counter()
    recalibrate(cfg, ssl, vox, passes)
    recal_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ap = run_eval(cfg, ssl, vox, cache=cache, cache_key=f"{name}@{iters}")
    eval_s = time.perf_counter() - t0
    del ssl
    secs = iteration_seconds(cfg["work_dir"])
    run = dict(
        iterations_run=len(history), train_s=train_s, recal_s=recal_s,
        eval_s=eval_s, peak_gib=peak, launches=launches,
        ms_per_iter_median=(float(np.median(secs)) * 1e3 if secs else None),
        ms_per_iter_mean=(float(np.mean(secs)) * 1e3 if secs else None))
    with open(os.path.join(cfg["work_dir"], "run.json"), "w") as f:
        json.dump(run, f)
    return ap, run


def _stored_arm(name, cfg, root, iters):
    """(APs, run record) of an arm that an earlier call (``--arm``)
    trained and evaluated under ``root``: its ``evals.json`` entry and
    ``run_<arm>/run.json``; None where either is missing."""
    evals = os.path.join(root, "evals.json")
    run = os.path.join(cfg["work_dir"], "run.json")
    if not (os.path.exists(evals) and os.path.exists(run)):
        return None
    with open(evals) as f:
        ap = json.load(f).get(eval_cache_key(f"{name}@{iters}"))
    if ap is None:
        return None
    with open(run) as f:
        return ap, json.load(f)


def _ap_view(ap):
    return {k: v for k, v in ap.items() if "mAP" in k or "num_dets" in k}


def run_study(root, iters, device="cuda", keep=True,
              recal_passes=RECAL_PASSES, seed=0, arms=ARMS):
    """The study on the tree under ``root`` (written where missing): the
    initialisation's evaluation, then arms A and B, each trained (or
    resumed), recalibrated and evaluated; with ``keep`` the evaluations
    are cached in ``root/evals.json``. ``arms`` names the arms to train
    here; the others' results are read from ``root``, where an earlier
    call with ``keep`` left them. Returns (report, ok): JAX's report keys
    and ``run``; ok if the three criteria hold; (None, None) while an arm
    has no result yet."""
    t_all = time.perf_counter()
    print(f"[data] generating under {root}", flush=True)
    paths = make_data(root)
    wd_a = os.path.join(root, "run_labonly")
    wd_b = os.path.join(root, "run_ssl")
    cfg_a = build_cfg(root, paths, iters, 0.0, wd_a, seed=seed)
    cfg_b = build_cfg(root, paths, iters, 1.0, wd_b, seed=seed)
    cache = root if keep else None

    print("[eval] init", flush=True)
    ssl0, vox0 = init_state(cfg_b, seed, device)
    ap_init = run_eval(cfg_b, ssl0, vox0, cache=cache, cache_key="init")
    del ssl0

    arm_cfgs = (("labonly", cfg_a, "A: labeled-only"),
                ("ssl", cfg_b, "B: DetMatch SSL"))
    results = {}
    for name, cfg, title in arm_cfgs:
        if name in arms:
            print(f"[train] {title}, {iters} iters", flush=True)
            results[name] = _arm(name, cfg, seed, device, recal_passes,
                                 cache, iters)
    for name, cfg, _ in arm_cfgs:
        if name not in arms:
            results[name] = _stored_arm(name, cfg, root, iters)
            if results[name] is None:
                print(f"[study] arm {name} has no result under {root} yet: "
                      f"run it with --arm {name} --data-root {root}",
                      flush=True)
                return None, None
    (ap_a, run_a), (ap_b, run_b) = results["labonly"], results["ssl"]

    curve_a, curve_b = loss_curve(wd_a), loss_curve(wd_b)
    # the loss's fall is judged on run A: run B's total is confounded by
    # the SSL weight ramping in
    first_a, last_a = quartile_means(curve_a)
    report = dict(
        iters=iters,
        score_thresh_3d=SCORE_THRESH_3D, score_thr_2d=SCORE_THR_2D,
        loss_first_quartile=first_a, loss_last_quartile=last_a,
        ap_init=_ap_view(ap_init), ap_labonly=_ap_view(ap_a),
        ap_ssl=_ap_view(ap_b), curve_labonly=curve_a, curve_ssl=curve_b)
    init_m = ap_init[f"tea.{KEY}"]
    a_m = max(ap_a[f"stu.{KEY}"], ap_a[f"tea.{KEY}"])
    b_m = max(ap_b[f"stu.{KEY}"], ap_b[f"tea.{KEY}"])
    ok = (last_a < first_a) and (b_m > init_m) and (b_m >= a_m)
    report["run"] = dict(
        card=card_line() if torch.device(device).type == "cuda" else None,
        device=(torch.cuda.get_device_name(0)
                if torch.device(device).type == "cuda" else str(device)),
        torch=torch.__version__, recal_passes=recal_passes,
        arms_trained_here=[a for a in ARMS if a in arms],
        tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                  cudnn=torch.backends.cudnn.allow_tf32),
        labonly=run_a, ssl=run_b, wall_s=time.perf_counter() - t_all,
        spike_labonly=largest_spike(curve_a),
        spike_ssl=largest_spike(curve_b),
        num_dets={arm: {k: ap[k] for k in ap if k.endswith("num_dets")}
                  for arm, ap in (("init", ap_init), ("labonly", ap_a),
                                  ("ssl", ap_b))},
        map_3d_moderate=dict(init=init_m, labonly=a_m, ssl=b_m),
        learning_check="PASSED" if ok else "FAILED")
    print(f"3D mAP(mod): init {init_m:.2f} | labeled-only {a_m:.2f} | "
          f"SSL {b_m:.2f}", flush=True)
    return report, ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--data-root", default=None,
                    help="reuse an existing study tree (data, checkpoints "
                         "and evaluations) from a cut run; implies --keep")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the models (default cuda)")
    ap.add_argument("--arm", choices=ARMS, default=None,
                    help="train and evaluate this arm only (needs "
                         "--data-root); the other arm's results are read "
                         "from the data root, and the report is written "
                         "once both arms have one")
    args = ap.parse_args(argv)
    if args.arm and not args.data_root:
        raise SystemExit("--arm needs --data-root: the other arm's results "
                         "are read from there")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "study on the CPU")
    if os.path.abspath(args.out) == os.path.join(REPO, "docs",
                                                 "learning_study.json"):
        raise SystemExit("docs/learning_study.json is the JAX package's "
                         "record; write the port's elsewhere")

    if args.data_root:
        root = args.data_root.rstrip("/") + "/"
        os.makedirs(root, exist_ok=True)
        args.keep = True
    else:
        root = tempfile.mkdtemp(prefix="learn_kitti_") + "/"
    report, ok = run_study(root, args.iters, args.device, keep=args.keep,
                           arms=(args.arm,) if args.arm else ARMS)
    if report is None:
        return
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items()
                      if not k.startswith("curve")}, indent=1), flush=True)
    if not args.keep:
        shutil.rmtree(root, ignore_errors=True)
    if not ok:
        print("LEARNING CHECK FAILED", flush=True)
        sys.exit(1)
    print("LEARNING CHECK PASSED", flush=True)


if __name__ == "__main__":
    main()
