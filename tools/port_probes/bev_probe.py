"""Probe the PyTorch port's BEV convolutions on a CUDA card.

Run from the repository root, with one card visible:

    python3 tools/port_probes/bev_probe.py

The full-width PV-RCNN of ``chip_smoke.CONFIG`` gets seeded random
weights. Everything is timed with CUDA events and printed beside the
card's ``nvidia-smi`` name and power limit:

1. ``detect`` at B=1 and B=4 with ``cudnn.benchmark`` off, on, on, off;
2. the BEV backbone alone (``model.backbone_2d``) on a random
   (B, 256, 200, 176) input, B=1 and B=4, two rounds of each variant:
   cuDNN fp32 in NCHW and NHWC, cuDNN TF32 in NCHW and NHWC, every 3x3
   conv as ``F.unfold`` plus one fp32 matmul, and ATen's own conv with
   cuDNN disabled. Each output's error is its max abs difference from
   cuDNN fp32 NCHW (TF32 off), divided by that output's max magnitude.
"""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from detmatch_tpu_torch.apis.build import (  # noqa: E402
    build_detector, build_voxelizer)
from detmatch_tpu_torch.apis.inference import detect  # noqa: E402
from detmatch_tpu_torch.config import Config  # noqa: E402


def unfold_forward(bev, x):
    """``BaseBEVBackbone.forward`` with every Conv2d as unfold + matmul
    (the deconvs stay as they are)."""
    def conv(layer, x):
        b, _, h, w = x.shape
        k, s, p = layer.kernel_size[0], layer.stride[0], layer.padding[0]
        cols = F.unfold(x, k, padding=p, stride=s)  # (B, C*k*k, L)
        out = layer.weight.reshape(layer.out_channels, -1) @ cols
        ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        return out.reshape(b, layer.out_channels, ho, wo)

    ups = []
    for block, deblock in zip(bev.blocks, bev.deblocks):
        for layer in block:
            x = conv(layer, x) if isinstance(layer, nn.Conv2d) else layer(x)
        ups.append(deblock(x))
    return torch.cat(ups, dim=1)


def bev_variants(bev, x):
    """name -> (zero-argument call, its input layout), every module and
    input converted before timing starts."""
    nhwc = copy.deepcopy(bev).to(memory_format=torch.channels_last)
    x_nhwc = x.to(memory_format=torch.channels_last)

    def cudnn(module, inp, tf32):
        def run():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
                return module(inp)
        return run

    def native():
        with torch.backends.cudnn.flags(enabled=False):
            return bev(x)

    return {
        "cuDNN fp32 NCHW": cudnn(bev, x, False),
        "cuDNN fp32 NHWC": cudnn(nhwc, x_nhwc, False),
        "cuDNN TF32 NCHW": cudnn(bev, x, True),
        "cuDNN TF32 NHWC": cudnn(nhwc, x_nhwc, True),
        "unfold+SGEMM fp32": lambda: unfold_forward(bev, x),
        "ATen native fp32 (cuDNN off)": native,
    }


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
    b1 = {k: v[:1] for k, v in b4.items()}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    with torch.inference_mode():
        for bench in (False, True, True, False):
            torch.backends.cudnn.benchmark = bench
            for b, bt in ((1, b1), (4, b4)):
                ms = cs.cuda_ms(lambda: detect(
                    model, bt["points"], bt["points_valid"], spec,
                    score_thresh=0.0), reps=5, warmup=2)
                print(f"cudnn.benchmark={bench} B={b}: detect {ms:.3f} ms "
                      f"[{card}]")
        torch.backends.cudnn.benchmark = False
        for b in (1, 4):
            x = torch.randn(b, 256, 200, 176, device="cuda", generator=g)
            ref = model.backbone_2d(x)
            variants = bev_variants(model.backbone_2d, x)
            for rnd in range(2):
                for name, fn in variants.items():
                    ms = cs.cuda_ms(fn, reps=5, warmup=2)
                    err = cs.rel_err(fn().contiguous(), ref)
                    print(f"round {rnd} BEV B={b} {name}: {ms:.3f} ms "
                          f"rel_err {err:.3e} [{card}]")


if __name__ == "__main__":
    main()
