"""Where the learning study's iteration goes, on one card: the host data
against the device, at the study's widths
(``detmatch_tpu_torch/tools/misc/learning_study.py:build_cfg``, arm B:
DetMatch SSL, B = 2 labeled + 2 x 2 unlabeled frames).

Run from the repository root, with one card visible:

    python3 tools/port_probes/profile_study.py [OUT_TXT] [ITERS]

On the study's tree (written under a temporary directory):
1. the host data alone: ms a batch that the two ``Loader``s of
   ``train_ssl`` hand over (4 threads each), over ITERS batches (default
   20) after one;
2. one collated batch of those loaders, fixed: ``chip_smoke.
   iteration_split`` (CUDA events per stage) over ITERS iterations after
   a warm-up, peak memory, with PyTorch's TF32 defaults (the study's) and
   with TF32 off in cuDNN too (``chip_smoke.py``'s);
3. ``torch.profiler`` over 3 iterations of that batch: the device's busy
   time and the top operators by device and by host time (full tables to
   OUT_TXT, default ``chiprun_out/profile_study.txt``);
4. ``train_ssl`` from the datasets, as the study runs it, for ITERS
   iterations: ms an iteration from its ``log.json``.
Prints one JSON line of the numbers and the card.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main():
    out = Path(sys.argv[1] if len(sys.argv) > 1
               else ROOT / "chiprun_out" / "profile_study.txt")
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    if not torch.cuda.is_available():
        raise SystemExit("profile_study.py runs on a CUDA card")
    import chip_smoke as cs
    from detmatch_tpu_torch.apis import build
    from detmatch_tpu_torch.data.collate import collate_ts
    from detmatch_tpu_torch.data.loader import Loader
    from detmatch_tpu_torch.tools.misc import learning_study as ls
    from detmatch_tpu_torch.train.optim import detmatch_branch_optimizers

    card = cs.card_line()
    res = dict(card=card, iters=iters,
               tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                         cudnn=torch.backends.cudnn.allow_tf32))
    with tempfile.TemporaryDirectory(prefix="profile_study_") as tmp:
        root = tmp + "/"
        paths = ls.make_data(root)
        cfg = ls.build_cfg(root, paths, 3000, 1.0,
                           os.path.join(root, "run_ssl"), seed=0)
        ck = dict(cfg["data"]["collate"])
        rng = np.random.RandomState(0)
        lab = build.build_dataset(cfg["data"]["train_lab"], rng=rng)
        unlab = build.build_dataset(cfg["data"]["train_unlab"], rng=rng)
        loaders = (Loader(lab, 2, lambda s: collate_ts(s, **ck), seed=0),
                   Loader(unlab, 4, lambda s: collate_ts(s, **ck), seed=1))
        its = [iter(x) for x in loaders]
        first = dict(lab=next(its[0]), unlab=next(its[1]))
        t0 = time.perf_counter()
        for _ in range(iters):
            next(its[0])
            next(its[1])
        res["host_ms_a_batch"] = (time.perf_counter() - t0) / iters * 1e3
        for x in loaders:
            x.stop()
        print(f"host data alone: {res['host_ms_a_batch']:.3f} ms a batch "
              f"(2 + 2 x 2 samples, 4 threads a loader)", flush=True)

        ssl, vox = ls.build_models(cfg, 0, "cuda")
        ssl.train()
        opts = detmatch_branch_optimizers(ssl, 4e-3, 1e-2, 300)
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        split = cs.iteration_split(ssl, first, vox, opts, gen, iters)
        res["fixed_batch_split_ms"] = split
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"one fixed batch: {split['iteration']:.3f} ms an iteration; "
              "split " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()
                                   if k != "iteration")
              + f" ms; peak {res['peak_gib']:.3f} GiB [{card}]", flush=True)

        # the same with TF32 off (chip_smoke.py's setting) for cuDNN too
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        off = cs.iteration_split(ssl, first, vox, opts, gen, iters)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        res["fixed_batch_split_ms_tf32_off"] = off
        print(f"the same, TF32 off in cuDNN too: {off['iteration']:.3f} ms "
              "an iteration; split " + ", ".join(
                  f"{k} {v:.3f}" for k, v in off.items() if k != "iteration")
              + f" ms [{card}]", flush=True)

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            cs.iteration_split(ssl, first, vox, opts, gen, 2)
            wall = (time.perf_counter() - t0) * 1e3
        ka = prof.key_averages()
        busy = sum(e.self_device_time_total for e in ka) / 1e3
        res["profiled_wall_ms"] = wall
        res["profiled_device_busy_ms"] = busy
        res["idle_share"] = max(0.0, 1.0 - busy / wall) if wall else None
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as f:
            f.write(f"{card}\n3 iterations (1 warm-up + 2) of one fixed "
                    f"batch: wall {wall:.3f} ms, device busy {busy:.3f} "
                    "ms\n\n")
            f.write(ka.table(sort_by="self_device_time_total",
                             row_limit=40))
            f.write("\n\n")
            f.write(ka.table(sort_by="self_cpu_time_total", row_limit=40))
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:12]
        res["top_device_ms"] = {e.key: e.self_device_time_total / 1e3
                                for e in top}
        print(f"profiled 3 iterations: wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms (idle share {res['idle_share']:.4f}) [{card}]")
        for k, v in res["top_device_ms"].items():
            print(f"  {v:10.3f} ms  {k[:100]}")
        del ssl, opts

        cfg["max_iters"] = iters
        cfg["log_interval"] = 1
        cfg["ckpt_interval"] = 10 ** 9
        t0 = time.perf_counter()
        ls.run_training(cfg, 0, "cuda")
        res["loader_fed_wall_s"] = time.perf_counter() - t0
        secs = ls.iteration_seconds(cfg["work_dir"])
        res["loader_fed_ms_median"] = float(np.median(secs)) * 1e3
        print(f"train_ssl from the datasets: {iters} iterations in "
              f"{res['loader_fed_wall_s']:.1f} s, "
              f"{res['loader_fed_ms_median']:.3f} ms an iteration (median) "
              f"[{card}]")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
