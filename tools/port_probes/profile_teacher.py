"""Profile one B=4 DetMatch teacher phase of the PyTorch port on a CUDA
card.

Run from the repository root, with one card visible:

    python3 tools/port_probes/profile_teacher.py [TABLES_PATH]

The SSL detector of ``chip_smoke.SSL_CONFIG`` at full width (PV-RCNN and
Faster R-CNN R50-FPN, seeded random weights with randomized BN
statistics, as ``chip_smoke.py`` builds them) runs
``teacher_pseudo_labels`` on four synthetic frames of 18,000 points and
384 x 1280 images (fp32, TF32 off) twice to warm up, then once under
``torch.profiler`` with ``record_function`` spans around the 3D teacher,
the 2D teacher and its parts (backbone + FPN, RPN head, RPN proposals,
RoI head, multiclass NMS) and the fusion matching. It prints the wall
time, the device's busy time (the union of its kernel and copy
intervals) and idle share, each span's device time, the device time of
cuDNN's convolutions and the host API call counts; this summary and the
full tables by device and host time go to ``TABLES_PATH`` (default
``build/profile_teacher.txt``).
"""
from __future__ import annotations

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
from detmatch_tpu_torch.models.frcnn import faster_rcnn  # noqa: E402
from detmatch_tpu_torch.ssl import modules  # noqa: E402
from detmatch_tpu_torch.train.ssl_step import (  # noqa: E402
    to_device_views, voxelize_views)
from detmatch_tpu_torch.utils.synth_kitti import ssl_view  # noqa: E402
from profile_detect import busy_us  # noqa: E402

CONV = ("aten::cudnn_convolution",)


def spanned(name, fn):
    def run(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return run


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe runs on the card")
    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.fromfile(str(cs.SSL_CONFIG))
    spec = build_voxelizer(cfg)
    model = build_ssl(cfg, device="cuda")
    cs.randomize_(model.teacher["det3d"], cs.SEED)
    cs.randomize_(model.teacher["det2d"], cs.SEED + 1)
    canvas = tuple(cfg["model"]["detector_2d"]["canvas"])
    points = cfg["data"]["collate"]["max_points"]
    rng = np.random.RandomState(cs.SEED)
    batch = voxelize_views(to_device_views(dict(unlab=dict(
        tea=ssl_view(rng, cs.SSL_B, points, canvas),
        stu=ssl_view(rng, cs.SSL_B, points, canvas))), "cuda"), spec)

    fr = model.teacher["det2d"]
    model._det3d_teacher_boxes = spanned("3D teacher",
                                         model._det3d_teacher_boxes)
    model._det2d_teacher_boxes = spanned("2D teacher",
                                         model._det2d_teacher_boxes)
    fr.extract_feat = spanned("2D backbone+FPN", fr.extract_feat)
    fr.rpn_head.forward = spanned("2D RPN head", fr.rpn_head.forward)
    fr.roi_forward = spanned("2D RoI head", fr.roi_forward)
    faster_rcnn.rpn_proposals = spanned("2D RPN proposals",
                                        faster_rcnn.rpn_proposals)
    faster_rcnn.multiclass_nms_2d = spanned("2D multiclass NMS",
                                            faster_rcnn.multiclass_nms_2d)
    modules.fusion_hungarian_matching = spanned(
        "fusion matching", modules.fusion_hungarian_matching)
    spans = ("3D teacher", "2D teacher", "2D backbone+FPN", "2D RPN head",
             "2D RPN proposals", "2D RoI head", "2D multiclass NMS",
             "fusion matching")

    with torch.inference_mode():
        for _ in range(2):
            model.teacher_pseudo_labels(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.teacher_pseudo_labels(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    busy, intervals = busy_us(prof.events())
    ranges = [e.time_range for e in prof.events()]
    window_us = (max(t.end for t in ranges) - min(t.start for t in ranges))
    lines = [f"B={cs.SSL_B} teacher phase under the profiler: wall "
             f"{wall_ms:.3f} ms; device busy {busy / 1e3:.3f} ms (union) "
             f"over {len(intervals)} device intervals; traced window "
             f"{window_us / 1e3:.3f} ms; device idle share "
             f"{1 - busy / window_us:.4f} [{card}]"]
    ka = prof.key_averages()
    for e in ka:
        # the host-side span: its device time is that of the kernels
        # launched inside it (the device-side annotation rows, with no
        # host time, are skipped)
        if e.key in spans and e.cpu_time_total > 0:
            lines.append(f"  span {e.key}: device "
                         f"{e.device_time_total / 1e3:.3f} ms, host "
                         f"{e.cpu_time_total / 1e3:.3f} ms, {e.count} calls")
    conv = sum(e.device_time_total for e in ka if e.key in CONV)
    total = sum(e.self_device_time_total for e in ka
                if e.key not in spans)
    lines.append(f"summed device time {total / 1e3:.3f} ms; cuDNN "
                 f"convolutions {conv / 1e3:.3f} ms [{card}]")
    counts = {name: sum(e.count for e in ka if e.key == name) for name in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaStreamSynchronize",
        "cudaMemcpyAsync")}
    lines.append(f"host API call counts: {counts}")
    summary = "\n".join(lines)
    print(summary)
    by_dev = ka.table(sort_by="self_cuda_time_total", row_limit=40,
                      max_name_column_width=80)
    by_host = ka.table(sort_by="self_cpu_time_total", row_limit=30,
                       max_name_column_width=80)
    out = ROOT / (sys.argv[1] if len(sys.argv) > 1
                  else "build/profile_teacher.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(f"{card}\n\n{summary}\n\n{by_dev}\n\n{by_host}\n")
    print(f"full tables: {out}")


if __name__ == "__main__":
    main()
