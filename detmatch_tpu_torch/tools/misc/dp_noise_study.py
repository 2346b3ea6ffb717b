"""Data-parallel gradient noise study with a float64 ground truth
(counterpart of ``tools/misc/dp_noise_study.py``).

Three computations of PV-RCNN's training loss and its gradients on one
global batch, from one seeded initialisation (the model's own
initialisers):

1. ``g1``: one process, float32;
2. ``gN``: N processes over gloo (``parallel``), each holding its rows of
   the same global batch (``parallel.local_shard``), the gradients summed
   by ``parallel.all_reduce_grads``;
3. ``g64``: one process with the parameters and the batch in float64, on
   the plain paths (``ops.cuda.PLAIN``): the CUDA kernels take float32
   only, so this run selects the twins explicitly, and says so. The
   model casts to float32 where the JAX package does (``.float()``
   before its convs and linear layers, for bf16 ``compute_dtype``);
   :func:`float64_mode` keeps float64 tensors float64 there, and skips
   K2's packed table, which the twins do not read. Masks, anchors and
   voxel-centre coordinates still enter as float32 values, as they do
   in JAX's float64 run.

It prints the losses, whether each integer or boolean output of the
forward is equal between g1 and gN, and the 8 worst gradient leaves of g1
against gN and of g1 against g64 (relative error: the largest absolute
difference over the leaf's largest magnitude; the absolute error; the
magnitude; the L2 difference over the leaf's norm; the name), as JAX's
study prints them. The float64 run is the ground truth: where g1 against
g64 is far above g1 against gN, the N processes add nothing to float32's
own error.

Setup: ``utils/tiny.TINY_PV_CFG`` on ``tiny_view(rng, b=8, p=128,
with_gt=True)`` (seed 0) by default; with ``--config`` the config's
``model.detector_3d`` and voxelizer on ``--frames`` synthetic HDL-64
scans of ``--points`` points with the JAX benchmark's GT draw
(``utils/synth_kitti``). Run:

    python -m detmatch_tpu_torch.tools.misc.dp_noise_study
        [--config CFG] [--frames B] [--points P] [--processes N]
        [--device cuda|cpu] [--out JSON]

The models live on ``--device`` (the card unless ``cpu`` is asked for);
the N processes share it (gloo stages the all-reduce through the host).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
SEED = 0
RNG_SEED = 1  # the forward's sampling generator (JAX: PRNGKey(1))
BATCH_KEYS = ("points", "points_valid", "voxel_features", "voxel_keys",
              "gt_boxes")
WORST = 8
# JAX's stated tolerance of g1 against gN: |g1 - gN| <= ATOL + RTOL *
# max|leaf| (tests/test_multichip.py)
ATOL, RTOL = 1e-3, 1e-2


def setup(config=None, frames=8, points=128):
    """(the PV-RCNN's keyword config, the voxelizer spec's keywords, the
    global batch as numpy arrays: points, points_valid, gt_boxes)."""
    if config is None:
        from ...utils import tiny
        view = tiny.tiny_view(np.random.RandomState(SEED), b=frames,
                              p=points, with_gt=True)
        return (dict(tiny.TINY_PV_CFG), dict(tiny.TINY_SPEC),
                {k: view[k] for k in ("points", "points_valid",
                                      "gt_boxes")})
    from ...config import Config
    from ...utils.synth_kitti import gt_boxes, lidar_batch
    cfg = Config.fromfile(config)
    det = dict(cfg["model"].get("detector_3d", {}))
    if det.pop("type", "PVRCNN") != "PVRCNN":
        raise ValueError(f"{config}: the study runs a PV-RCNN")
    v = cfg["voxelizer"]
    spec = dict(point_cloud_range=tuple(v["point_cloud_range"]),
                voxel_size=tuple(v["voxel_size"]),
                max_voxels=v.get("max_voxels", 16000),
                max_points=v.get("max_points", 5))
    rng = np.random.RandomState(SEED)
    pts, valid = lidar_batch(rng, frames, points, spec["point_cloud_range"])
    return det, spec, dict(points=pts, points_valid=valid,
                           gt_boxes=gt_boxes(rng, frames))


@contextlib.contextmanager
def float64_mode():
    """Run the PV-RCNN in float64: ``Tensor.float`` leaves float64 tensors
    as they are; the VSA's and the RoI head's ``pack_table`` (K2's
    packed table, which the plain twins do not read) and
    ``pointnet.take_rows``'s float32 accumulation are skipped for
    float64 tables. Undone on exit."""
    from ...models.pvrcnn import roi_head, vsa
    from ...ops import pointnet

    to_float = torch.Tensor.float

    def keep_float64(self, *args, **kwargs):
        if self.dtype == torch.float64:
            return self
        return to_float(self, *args, **kwargs)

    saved = [(torch.Tensor, "float", to_float),
             (pointnet, "take_rows", pointnet.take_rows)]
    saved += [(mod, "pack_table", mod.pack_table) for mod in (vsa, roi_head)]

    def pack_table(pack):
        return lambda xyz, *a: (None if xyz.dtype == torch.float64
                                else pack(xyz, *a))

    take = pointnet.take_rows
    torch.Tensor.float = keep_float64
    pointnet.take_rows = lambda table, idx: (
        table[idx] if table.dtype == torch.float64 else take(table, idx))
    for mod in (vsa, roi_head):
        mod.pack_table = pack_table(mod.pack_table)
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def make_model(det_cfg, device, dtype=torch.float32):
    """The PV-RCNN with its own initialisers seeded from SEED, train
    mode; in float64 on the plain paths where ``dtype`` asks for it."""
    from ...models.pvrcnn.pvrcnn import PVRCNN
    from ...ops.cuda import PLAIN
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = PVRCNN(**det_cfg)
    model = model.to(device).train()
    if dtype == torch.float64:
        model = model.double()
        model.ops = PLAIN
    return model


def device_batch(batch_np, spec, device, dtype=torch.float32):
    """The numpy batch on ``device``, voxelized in float32 (the
    voxelizer's own precision), its floating tensors then cast to
    ``dtype``."""
    from ...ops.voxelize import VoxelizerSpec, voxelize_mean
    b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in batch_np.items()}
    vox = voxelize_mean(b["points"], b["points_valid"], VoxelizerSpec(**spec))
    b.update(voxel_features=vox["features"], voxel_keys=vox["keys"])
    return {k: (b[k].to(dtype) if b[k].is_floating_point() else b[k])
            for k in BATCH_KEYS}


def discrete(out, prefix=""):
    """The forward's integer and boolean tensors, nested dicts flattened
    to dotted names."""
    res = {}
    for k, v in out.items():
        if isinstance(v, dict):
            res.update(discrete(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor) and not v.is_floating_point():
            res[prefix + k] = v.detach().cpu()
    return res


def loss_and_grads(model, batch):
    """(the global batch's loss, {name: gradient on the CPU}, the forward's
    discrete outputs) of one train-mode forward and backward; under
    several processes the loss is summed over them
    (``parallel.reduce_logs``) and the gradients all-reduced."""
    from ... import parallel
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(RNG_SEED)
    model.zero_grad(set_to_none=True)
    out = model(batch, train=True, generator=gen)
    losses = model.loss(out, batch)
    losses["loss"].backward()
    parallel.all_reduce_grads(model.parameters())
    loss = float(parallel.reduce_logs(
        {"loss": losses["loss"].detach()})["loss"])
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    return loss, grads, discrete(out)


def leaf_errs(a, b):
    """Per common leaf: (largest |a - b| over b's largest magnitude,
    largest |a - b|, largest magnitude of a, L2 of a - b over b's norm,
    name), worst first, in float64."""
    rows = []
    for name in a:
        x, y = a[name].double(), b[name].double()
        d = float((x - y).abs().max())
        mag = float(max(x.abs().max(), 1e-12))
        ny = float(y.norm())
        l2 = float((x - y).norm()) / ny if ny else 0.0
        rows.append((d / mag, d, mag, l2, name))
    rows.sort(reverse=True)
    return rows


def within_tolerance(a, b):
    """Leaves of ``a`` against ``b`` past JAX's tolerance ``ATOL + RTOL *
    max|leaf|``: [(name, largest difference, allowed)]."""
    bad = []
    for name in a:
        x, y = a[name].double(), b[name].double()
        d = float((x - y).abs().max())
        allowed = ATOL + RTOL * float(x.abs().max())
        if d > allowed:
            bad.append((name, d, allowed))
    return bad


def rank_main(rank, world, work, device):
    """One of the N processes: joins the gloo group (a file store in
    ``work``), computes its rows' part and writes ``rank<r>.pt``."""
    from ... import parallel
    payload = torch.load(os.path.join(work, "payload.pt"),
                         weights_only=False)
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    parallel.start_group("file://" + os.path.join(work, "store"), world,
                         rank, backend="gloo")
    try:
        if torch.device(device).type == "cuda":
            device = f"cuda:{torch.cuda.current_device()}"
        model = make_model(payload["det"], device)
        batch = device_batch(parallel.local_shard(payload["batch"]),
                             payload["spec"], device)
        loss, grads, disc = loss_and_grads(model, batch)
        torch.save(dict(loss=loss, grads=grads if rank == 0 else None,
                        discrete=disc),
                   os.path.join(work, f"rank{rank}.pt"))
    finally:
        parallel.shutdown()


def run_processes(det, spec, batch_np, world, device, work, timeout=900):
    """gN: ``world`` processes of :func:`rank_main`; returns (loss,
    gradients, discrete outputs with the ranks' rows concatenated)."""
    torch.save(dict(det=det, spec=spec, batch=batch_np),
               os.path.join(work, "payload.pt"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    logs = [open(os.path.join(work, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "detmatch_tpu_torch.tools.misc.dp_noise_study",
         "--rank", str(r), "--world", str(world), "--work", work,
         "--device", device], stdout=log, stderr=subprocess.STDOUT, env=env,
        cwd=REPO) for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            raise RuntimeError(f"process {r} of {world} failed:\n"
                               f"{text[-4000:]}")
    outs = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]
    disc = {}
    for k in outs[0]["discrete"]:
        parts = [o["discrete"][k] for o in outs]
        disc[k] = torch.cat(parts) if parts[0].dim() else parts[0]
    return outs[0]["loss"], outs[0]["grads"], disc


def study(config=None, frames=8, points=128, world=8, device="cuda",
          log=print):
    """The three runs and their comparison; returns the result dict
    (losses, discrete equality, worst leaves, JAX's tolerance check, the
    seconds of each run)."""
    det, spec, batch_np = setup(config, frames, points)
    secs = {}
    t0 = time.perf_counter()
    model = make_model(det, device)
    l1, g1, d1 = loss_and_grads(model, device_batch(batch_np, spec, device))
    del model
    secs["g1"] = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # the N processes share the card
    with tempfile.TemporaryDirectory(prefix="dp_noise_") as work:
        t0 = time.perf_counter()
        ln, gn, dn = run_processes(det, spec, batch_np, world, device, work)
        secs[f"g{world}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model64 = make_model(det, device, torch.float64)
    with float64_mode():
        l64, g64, d64 = loss_and_grads(model64, device_batch(
            batch_np, spec, device, torch.float64))
    del model64
    secs["g64"] = time.perf_counter() - t0

    log(f"loss 1 process={l1:.8f} {world} processes={ln:.8f}")
    equal = {k: bool(k in dn and torch.equal(d1[k], dn[k])) for k in d1}
    for k, eq in equal.items():
        log(f"discrete[{k}]: equal={eq}")
    res = dict(config=config or "utils/tiny.TINY_PV_CFG", frames=frames,
               points=points, processes=world, device=str(device),
               loss_g1=l1, loss_gN=ln, loss_g64=l64, discrete_equal=equal,
               discrete_equal_g64={k: bool(k in d64 and torch.equal(
                   d1[k], d64[k])) for k in d1},
               seconds=secs)
    for tag, other in ((f"g1 vs g{world} (float32, 1 process vs {world} "
                        "processes)", gn),
                       ("g1 vs g64 (float32 vs the float64 ground truth, "
                        "g64 on the plain paths: the CUDA kernels take "
                        "float32 only)", g64)):
        rows = leaf_errs(g1, other)
        log(f"{tag}: worst leaves")
        for rel, d, mag, l2, name in rows[:WORST]:
            log(f"  rel={rel:.3e} abs={d:.3e} mag={mag:.3e} l2={l2:.3e} "
                f"{name}")
        key = "gN" if other is gn else "g64"
        res[f"worst_g1_{key}"] = [dict(rel=r[0], abs=r[1], mag=r[2], l2=r[3],
                                       name=r[4]) for r in rows[:WORST]]
        res[f"max_l2_g1_{key}"] = max(r[3] for r in rows)
    flips = [k for k, eq in res["discrete_equal_g64"].items() if not eq]
    log(f"loss f64={l64:.8f}; discrete outputs that float64 decides "
        f"otherwise than g1: {flips or 'none'}")
    bad = within_tolerance(g1, gn)
    res["gN_within_jax_tolerance"] = not bad
    res["gN_past_tolerance"] = bad
    res["leaves"] = len(g1)
    res["g64_float64"] = all(g.dtype == torch.float64 for g in g64.values())
    log(f"g1 vs g{world}: every leaf within {ATOL:g} + {RTOL:g} * max|leaf|:"
        f" {not bad} ({len(bad)} of {len(g1)} past it)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None,
                    help="a config whose model.detector_3d is a PV-RCNN "
                         "(default: utils/tiny.TINY_PV_CFG)")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--points", type=int, default=128)
    ap.add_argument("--processes", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the models (default cuda)")
    ap.add_argument("--out", default=None, help="write the result as JSON")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        torch.set_num_threads(1)
        return rank_main(args.rank, args.world, args.work, args.device)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to run the "
                             "study on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from ...ops.cuda import build
        build.build()  # once, before N processes would race to it
    res = study(args.config, args.frames, args.points, args.processes,
                args.device)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
