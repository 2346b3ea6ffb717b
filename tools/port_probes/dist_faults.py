"""Plant faults in the data-parallel path and show that
``chip_smoke.py``'s two-process comparison catches each, at the SSL
config's full width on one card, and measure float32's own differences
beside them.

Run from the repository root, with one card visible:

    python3 tools/port_probes/dist_faults.py [OUT_JSON] [--faults A,B]
        [--no-alternatives]

One process runs ``chip_smoke.dist_reference`` (4 + 4 frames, two SSL
iterations, the student's noise-sensitive decisions recorded as pins),
then again per entry of ALTERNATIVES (the same run; cuDNN's
deterministic algorithms; every batch norm's sums over the rows taken
in two halves), each iteration from the first run's state, compared
with the first as the two processes are. Then two processes over gloo
replay the pins on their rows, each iteration from the one process's
state (``chip_smoke.dist_spawn``): once as the port runs, and once per
fault of FAULTS, planted at run time in both processes (a module
attribute replaced before the run; no file changes). Prints each run's
verdict under the card phase's gates (``chip_smoke.dist_verdict``) and,
per iteration, kind and module, the largest and the median error, and
writes every compared value of every run to OUT_JSON (default
``chiprun_out/dist_faults.json``). The CPU tests' shrinking (``cfg``,
``prelude``) runs it on the CPU at a tiny size.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# one process's run again, each iteration from the first run's state:
# float32's own differences between two computations of the same thing
# (the same run; cuDNN's deterministic algorithms; every batch norm's sums
# over the rows taken in two halves and added, the order that two
# processes' all-reduce gives them)
ALTERNATIVES = ("the same run again", "cuDNN's deterministic algorithms",
                "batch-norm sums in two halves")


def _denominator_off(column):
    """The fault that adds one to ``column`` of ``PVRCNN.loss_grouped``'s
    global denominators."""
    return (
        "import torch\n"
        "from detmatch_tpu_torch.models.pvrcnn import pvrcnn\n"
        "_global_sum = pvrcnn.global_sum\n"
        "def _off(x):\n"
        "    y = _global_sum(x)\n"
        "    if y.dim() != 2:\n"
        "        return y\n"
        f"    return y + (torch.arange(y.shape[1], device=y.device) == "
        f"{column})\n"
        "pvrcnn.global_sum = _off")


# what each planted fault replaces, in both processes
FAULTS = {
    "as ported": "",
    "BEV batch norms local": (
        "from detmatch_tpu_torch.models import layers\n"
        "layers.process_count = lambda: 1"),
    "every batch norm's statistics local": (
        "from detmatch_tpu_torch.models import layers\n"
        "layers.global_sum_grad = lambda x: x"),
    "3D loss denominators local": (
        "from detmatch_tpu_torch.models.pvrcnn import pvrcnn\n"
        "pvrcnn.global_sum = lambda x: x.detach()"),
    "no gradient all-reduce": (
        "from detmatch_tpu_torch.train import optim\n"
        "optim.all_reduce_grads = lambda params: None"),
    "dropout drawn at the local shape": (
        "from detmatch_tpu_torch.models import layers\n"
        "layers.global_rows = lambda b, groups=1: (list(range(b)), b)"),
    "EMA teacher not updated": (
        "from detmatch_tpu_torch.train import ssl_step\n"
        "ssl_step.ema_update = lambda *a, **k: None"),
    # finer: one global denominator of PVRCNN.loss_grouped one off (its
    # (groups, terms) stack: column 0 each group's sample count, column
    # 1 its positive keypoints), in both processes alike
    "3D sample count one row off": _denominator_off(0),
    "3D positive keypoint count one off": _denominator_off(1),
}


def spread_lines(rows):
    """Per iteration and kind, the largest and the median error; per
    iteration and module, the gradients' largest and median L2
    difference and difference over their tensor's largest entry."""
    for it in sorted({r[1].split(" ", 2)[1] for r in rows}):
        parts = []
        for kind in cs.DIST_GATES:
            errs = sorted(r[3] for r in rows
                          if r[0] == kind and r[1].split(" ", 2)[1] == it)
            if errs:
                parts.append(f"{kind} {errs[-1]:.2e} / "
                             f"{errs[len(errs) // 2]:.2e}")
        print(f"  iteration {it}, largest / median error: "
              + "; ".join(parts))
        by = {}
        for kind, where, _, err, l2 in rows:
            _, i, name = where.split(" ", 2)
            if kind == "grads" and i == it:
                by.setdefault(".".join(name.split(".")[:2]), []).append(
                    (err, l2))
        print(f"  iteration {it}, gradients by module, largest / median "
              "L2, largest / median over the largest entry: " + "; ".join(
                  f"{m} {max(e for e, _ in v):.1e} / "
                  f"{sorted(e for e, _ in v)[len(v) // 2]:.1e}, "
                  f"{max(x for _, x in v):.1e} / "
                  f"{sorted(x for _, x in v)[len(v) // 2]:.1e}"
                  for m, v in sorted(by.items())))


def halves_moments(xf, dims, m=None):
    """``layers.global_moments`` in one process with every sum over the
    rows (axis 0) taken as its two halves added."""
    def total(t):
        n = t.shape[0] // 2
        return t[:n].sum(dims) + t[n:].sum(dims)

    keep = [1 if d in dims else n for d, n in enumerate(xf.shape)]
    if m is None:
        s = total(xf)
        cnt = xf.new_tensor(float(xf.numel() // xf.shape[1]))
    else:
        s, cnt = total(xf * m), m.sum()
    cnt = torch.clamp(cnt.detach(), min=1.0)
    mean = s / cnt
    dev = (xf - mean.reshape(keep)) ** 2
    var = total(dev if m is None else dev * m) / cnt
    return mean, var, var * cnt / torch.clamp(cnt - 1.0, min=1.0)


@contextlib.contextmanager
def alternative(name):
    """The run of ALTERNATIVES ``name``."""
    from detmatch_tpu_torch.models import layers
    deterministic = torch.backends.cudnn.deterministic
    moments = layers.global_moments
    if name == "cuDNN's deterministic algorithms":
        torch.backends.cudnn.deterministic = True
    if name == "batch-norm sums in two halves":
        layers.global_moments = halves_moments
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = deterministic
        layers.global_moments = moments


def main(cfg=None, out=None, faults=FAULTS, prelude="",
         alternatives=ALTERNATIVES):
    """``cfg``: the SSL config (default ``chip_smoke.SSL_CONFIG``);
    ``prelude``: Python source that every process runs before its fault
    (the CPU tests shrink the run with it); ``faults`` and
    ``alternatives``: the runs to make (default all)."""
    from detmatch_tpu_torch.config import Config
    out = Path(out or ROOT / "chiprun_out" / "dist_faults.json")
    if cs.DEVICE == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("dist_faults.py runs on a CUDA card")
        from detmatch_tpu_torch.ops.cuda import build
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build()  # once, before two processes would race to it
        card = cs.card_line()
    else:
        card = "cpu"
    print(card)
    cfg = cfg or Config.fromfile(str(cs.SSL_CONFIG))
    result = dict(card=card, runs={})
    with tempfile.TemporaryDirectory(prefix="dist_faults_") as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        ref, pins, _ = cs.dist_reference(cfg, work, card)
        print(f"one process in {time.perf_counter() - t0:.1f} s")
        result["alternatives"] = {}
        for name in alternatives:
            with cs.several_process_bn(), alternative(name):
                res = cs.dist_ssl_run(cfg, cs.dist_batches(cfg), pins,
                                      work / name.replace(" ", "_"),
                                      resume=ref["after"])[2]
            rows = cs.dist_diffs(res, ref)
            del res
            result["alternatives"][name] = rows
            print(f"== {name}, against the first")
            cs.print_verdict("one process", cs.dist_verdict(rows))
            spread_lines(rows)
        del ref
        gc.collect()
        torch.cuda.empty_cache()  # the two processes share the card
        for name, fault in faults.items():
            sub = work / name.replace(" ", "_").replace("'", "")
            sub.mkdir()
            for f in ("pins.pt", "ref.pt"):
                os.symlink(work / f, sub / f)
            t0 = time.perf_counter()
            outs = cs.dist_spawn(sub, prelude + "\n" + fault)
            rows = outs[0]["rows"]
            equal = [o["bit_equal"] for o in outs]
            result["runs"][name] = dict(rows=rows, bit_equal=equal)
            print(f"== {name} ({time.perf_counter() - t0:.1f} s; states "
                  f"bit-equal across processes {equal})")
            ok = cs.print_verdict("process 0", cs.dist_verdict(rows))
            spread_lines(rows)
            print(f"  {name}: {'PASS' if ok else 'FAIL'}")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result))
    print(f"rows written to {out}")
    return result


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--faults", default=None,
                    help="comma-separated names of FAULTS to run (default "
                         "all)")
    ap.add_argument("--no-alternatives", action="store_true",
                    help="skip the one-process runs of ALTERNATIVES")
    args = ap.parse_args()
    chosen = FAULTS if args.faults is None else {
        k: FAULTS[k] for k in args.faults.split(",")}
    main(out=args.out, faults=chosen,
         alternatives=() if args.no_alternatives else ALTERNATIVES)
