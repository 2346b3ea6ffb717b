"""Profile one B=4 ``detect`` of the PyTorch port on a CUDA card.

Run from the repository root, with one card visible:

    python3 tools/port_probes/profile_detect.py [TABLES_PATH]

The full-width PV-RCNN of ``chip_smoke.CONFIG`` with seeded random
weights runs ``detect`` on four synthetic KITTI frames (fp32, TF32 off)
twice to warm up, then once under ``torch.profiler``. It prints the wall
time, the device's busy time (the union of its kernel and copy
intervals in the trace) and idle share over that call, the top rows by
device time and by host time, and the counts of kernel launches and
stream synchronisations. The full tables go to ``TABLES_PATH``
(default ``build/profile_detect.txt``, relative to the repository root).
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from detmatch_tpu_torch.apis.build import (  # noqa: E402
    build_detector, build_voxelizer)
from detmatch_tpu_torch.apis.inference import detect  # noqa: E402
from detmatch_tpu_torch.config import Config  # noqa: E402


# device-typed rows the profiler adds for its own buffers, not work
PROFILER_ROWS = ("Buffer Flush", "Activity Buffer Request")


def busy_us(events):
    """Length of the union of the device intervals (kernels, copies,
    memsets) among ``events``."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.name not in PROFILER_ROWS)
    total, end = 0.0, float("-inf")
    for s, t in spans:
        if t > end:
            total += t - max(s, end)
            end = t
    return total, spans


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe runs on the card")
    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.fromfile(str(cs.CONFIG))
    spec = build_voxelizer(cfg)
    model = build_detector(cfg, device="cuda")
    cs.randomize_(model, cs.SEED)
    b4 = cs.make_batch(spec, 4)

    def call():
        return detect(model, b4["points"], b4["points_valid"], spec,
                      score_thresh=0.0)

    with torch.inference_mode():
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    busy, spans = busy_us(prof.events())
    ranges = [e.time_range for e in prof.events()]
    window_us = (max(t.end for t in ranges) - min(t.start for t in ranges))
    work_us = sum(t - s for s, t in spans)
    print(f"B=4 detect under the profiler: wall {wall_ms:.3f} ms; device "
          f"busy {busy / 1e3:.3f} ms (union) of {work_us / 1e3:.3f} ms "
          f"(sum) over {len(spans)} device intervals; "
          f"traced window {window_us / 1e3:.3f} ms; device idle share "
          f"{1 - busy / window_us:.4f} [{card}]")
    ka = prof.key_averages()
    counts = {name: sum(e.count for e in ka if e.key == name) for name in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaStreamSynchronize",
        "cudaDeviceSynchronize", "cudaMemcpyAsync")}
    print(f"host API call counts: {counts}")
    by_dev = ka.table(sort_by="self_cuda_time_total", row_limit=40,
                      max_name_column_width=80)
    by_host = ka.table(sort_by="self_cpu_time_total", row_limit=30,
                       max_name_column_width=80)
    print("\n".join(by_dev.splitlines()[:25]))
    out = ROOT / (sys.argv[1] if len(sys.argv) > 1
                  else "build/profile_detect.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(f"{card}\n\n{by_dev}\n\n{by_host}\n")
    print(f"full tables: {out}")


if __name__ == "__main__":
    main()
