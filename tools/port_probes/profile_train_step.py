"""Profile one training step of the PyTorch port on a CUDA card.

Run from the repository root, with one card visible:

    python3 tools/port_probes/profile_train_step.py [TABLES_PATH]

The full-width PV-RCNN of ``chip_smoke.CONFIG`` with its own seeded
initialisers (``chip_smoke.make_train_model``), in train mode, takes
AdamW steps (forward, loss, backward, clip,
update) on ``chip_smoke.make_train_frames`` (B=2, 18,000 points, fp32,
TF32 off): two to warm up, then one under ``torch.profiler``. It prints
the wall time, the device's busy time (the union of its kernel and copy
intervals) and idle share over that step, the device time of the dense
convolutions (the BEV backbone and the dense head, cuDNN) forward and
backward, of the phases and of the train proposal NMS (``record_function``
spans), and the top rows by device time. The full tables go to
``TABLES_PATH`` (default ``build/profile_train_step.txt``).
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools" / "port_probes"))

import chip_smoke as cs  # noqa: E402
from detmatch_tpu_torch.apis.build import build_voxelizer  # noqa: E402
from detmatch_tpu_torch.apis.train_pretrain import (  # noqa: E402
    to_device_batch)
from detmatch_tpu_torch.config import Config  # noqa: E402
from detmatch_tpu_torch.models.pvrcnn import pvrcnn  # noqa: E402
from detmatch_tpu_torch.train.optim import (  # noqa: E402
    clip_grad_norm_, make_optimizer)
from profile_detect import busy_us  # noqa: E402

# ATen ops under which the dense convolutions' device kernels run
CONV_FWD = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose")
CONV_BWD = ("aten::convolution_backward",)
SPANS = ("forward+loss", "backward", "clip+optimizer", "proposal_nms")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe runs on the card")
    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config.fromfile(str(cs.CONFIG))
    spec = build_voxelizer(cfg)
    model = cs.make_train_model(cfg)
    batch = to_device_batch(cs.make_train_frames(spec), spec, "cuda")
    params = list(model.parameters())
    opt, sched = make_optimizer(params, 0.001, 100)
    gen = torch.Generator("cuda").manual_seed(cs.SEED)
    layer = pvrcnn.proposal_layer

    def spanned_proposals(*args, **kwargs):
        with record_function("proposal_nms"):
            return layer(*args, **kwargs)

    pvrcnn.proposal_layer = spanned_proposals

    def step():
        with record_function("forward+loss"):
            losses = model.loss(model(batch, train=True, generator=gen),
                                batch)
        with record_function("backward"):
            opt.zero_grad(set_to_none=True)
            losses["loss"].backward()
        with record_function("clip+optimizer"):
            clip_grad_norm_(params)
            opt.step()
            sched.step()

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, spans = busy_us(prof.events())
    ranges = [e.time_range for e in prof.events()]
    window_us = (max(t.end for t in ranges) - min(t.start for t in ranges))
    print(f"B={cs.TRAIN_B} training step under the profiler: wall "
          f"{wall_ms:.3f} ms; device busy {busy / 1e3:.3f} ms (union) over "
          f"{len(spans)} device intervals; traced window "
          f"{window_us / 1e3:.3f} ms; device idle share "
          f"{1 - busy / window_us:.4f} [{card}]")
    ka = prof.key_averages()
    total = sum(e.self_device_time_total for e in ka if e.key not in SPANS)
    incl = {e.key: e.device_time_total for e in ka}
    fwd = sum(incl.get(k, 0.0) for k in CONV_FWD)
    bwd = sum(incl.get(k, 0.0) for k in CONV_BWD)
    print(f"summed device time {total / 1e3:.3f} ms; dense convs forward "
          f"{fwd / 1e3:.3f} ms, backward {bwd / 1e3:.3f} ms: "
          f"{(fwd + bwd) / total:.4f} of the summed device time [{card}]")
    for e in ka:
        if e.key in SPANS and e.cpu_time_total > 0:
            # the backward's kernels run on autograd's own thread, outside
            # its span: read it off the kernels' rows instead
            print(f"  span {e.key}: device {e.device_time_total / 1e3:.3f} "
                  f"ms, host {e.cpu_time_total / 1e3:.3f} ms")
    for key in ("_WindowKeyConvBackward", "aten::sort"):
        e = next((e for e in ka if e.key == key), None)
        if e is not None:
            print(f"  {key}: device {e.device_time_total / 1e3:.3f} ms, "
                  f"{e.count} calls")
    counts = {name: sum(e.count for e in ka if e.key == name) for name in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaStreamSynchronize",
        "cudaMemcpyAsync")}
    print(f"host API call counts: {counts}")
    by_dev = ka.table(sort_by="self_cuda_time_total", row_limit=40,
                      max_name_column_width=80)
    by_host = ka.table(sort_by="self_cpu_time_total", row_limit=30,
                       max_name_column_width=80)
    print("\n".join(by_dev.splitlines()[:25]))
    out = ROOT / (sys.argv[1] if len(sys.argv) > 1
                  else "build/profile_train_step.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(f"{card}\n\n{by_dev}\n\n{by_host}\n")
    print(f"full tables: {out}")


if __name__ == "__main__":
    main()
