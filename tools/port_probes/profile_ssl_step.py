"""Profile one full-width DetMatch SSL iteration of the PyTorch port on a
CUDA card, on the windowed sparse conv (K1) and on the key-compare one
(K5).

Run from the repository root, with one card visible:

    python3 tools/port_probes/profile_ssl_step.py [TABLES_PATH]

The SSL detector of ``chip_smoke.SSL_CONFIG`` (PV-RCNN and Faster R-CNN
R50-FPN at full width, the models' own seeded initialisers as
``chip_smoke.py`` builds them, fp32, TF32 off) trains on one synthetic
batch of 4 labeled + 4 unlabeled frames (18,000 points, 384 x 1280
images): two iterations warm up, then one runs under ``torch.profiler``
with ``record_function`` spans around the teacher phase, the student 3D
branch (forward + loss, backward, optimizer), the student 2D branch (the
same), the EMA, and inside them the proposal NMS (train 9,000 → 512 per
student frame, test 1,024 → 100 per teacher frame) and the sparse
convs' forward. The same follows with ``conv_impl="key"``. For each it
prints the wall time, the device's busy time (the union of its kernel and
copy intervals) and idle share, each span's device time and the top
device operations; the full tables go to ``TABLES_PATH`` (default
``build/profile_ssl_step.txt``).
"""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools" / "port_probes"))

import chip_smoke as cs  # noqa: E402
from detmatch_tpu_torch.apis.build import (  # noqa: E402
    build_ssl, build_voxelizer)
from detmatch_tpu_torch.config import Config  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn import pvrcnn as pvrcnn_mod  # noqa: E402
from detmatch_tpu_torch.ops.cuda import KERNELS  # noqa: E402
from detmatch_tpu_torch.train.optim import (  # noqa: E402
    detmatch_branch_optimizers)
from detmatch_tpu_torch.train.ssl_step import (  # noqa: E402
    ema_step, teacher_step, to_device_views, voxelize_views)
from profile_detect import busy_us  # noqa: E402

STAGES = ("teacher", "stu3d fwd+loss", "stu3d bwd", "stu3d opt",
          "stu2d fwd+loss", "stu2d bwd", "stu2d opt", "EMA")
INNER = ("proposal NMS", "sparse conv fwd")


def spanned(name, fn):
    def run(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return run


def iteration(m, batch, opts, gen, it):
    with record_function("teacher"):
        pseudo = teacher_step(m, batch)
    for tag, loss_fn, opt in (("stu3d", m.student_losses_3d_concat, opts[0]),
                              ("stu2d", m.student_losses_2d, opts[1])):
        opt.zero_grad()
        with record_function(f"{tag} fwd+loss"):
            total, _ = loss_fn(batch, pseudo, it, gen)
        with record_function(f"{tag} bwd"):
            total.backward()
        with record_function(f"{tag} opt"):
            opt.step()
    with record_function("EMA"):
        ema_step(m, it)


def profile_path(label, model, batch, card):
    m = copy.deepcopy(model).train()
    opts = detmatch_branch_optimizers(m, 0.04, 0.16)
    conv = ("key_conv_batched" if label == "key"
            else "window_key_conv_batched")
    m.ops = KERNELS._replace(**{conv: spanned("sparse conv fwd",
                                              getattr(KERNELS, conv))})
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    for it in range(2):
        iteration(m, batch, opts, gen, it)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iteration(m, batch, opts, gen, 2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, intervals = busy_us(prof.events())
    ranges = [e.time_range for e in prof.events()]
    window_us = max(t.end for t in ranges) - min(t.start for t in ranges)
    lines = [f"{label} path, one SSL iteration (B={cs.SSL_B}+{cs.SSL_B}) "
             f"under the profiler: wall {wall_ms:.3f} ms; device busy "
             f"{busy / 1e3:.3f} ms (union) over {len(intervals)} device "
             f"intervals; traced window {window_us / 1e3:.3f} ms; device "
             f"idle share {1 - busy / window_us:.4f} [{card}]"]
    ka = prof.key_averages()
    for e in ka:
        if e.key in STAGES + INNER and e.cpu_time_total > 0:
            lines.append(f"  span {e.key}: device "
                         f"{e.device_time_total / 1e3:.3f} ms, host "
                         f"{e.cpu_time_total / 1e3:.3f} ms, {e.count} calls")
    top = sorted((e for e in ka if e.key not in STAGES + INNER),
                 key=lambda e: -e.self_device_time_total)[:12]
    lines.append("  top device operations (self time): " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms"
        for e in top))
    by_dev = ka.table(sort_by="self_cuda_time_total", row_limit=40,
                      max_name_column_width=80)
    return "\n".join(lines), by_dev


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe runs on the card")
    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.fromfile(str(cs.SSL_CONFIG))
    spec = build_voxelizer(cfg)
    model = cs.ssl_model(cfg)
    batch = voxelize_views(to_device_views(
        cs.ssl_batch_np(cfg, np.random.RandomState(cs.SEED)), "cuda"), spec)
    cfg_key = copy.deepcopy(cfg)
    det3d = cfg_key["model"]["detector_3d"]
    det3d["backbone3d_cfg"] = dict(det3d.get("backbone3d_cfg") or {},
                                   conv_impl="key")
    key_model = build_ssl(cfg_key)
    key_model.load_state_dict(model.state_dict())
    pvrcnn_mod.proposal_layer = spanned("proposal NMS",
                                        pvrcnn_mod.proposal_layer)
    out = [card]
    for label, mdl in (("window", model), ("key", key_model)):
        summary, table = profile_path(label, mdl, batch, card)
        print(summary)
        out += [summary, table]
    path = ROOT / (sys.argv[1] if len(sys.argv) > 1
                   else "build/profile_ssl_step.txt")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n\n".join(out) + "\n")
    print(f"full tables: {path}")


if __name__ == "__main__":
    main()
