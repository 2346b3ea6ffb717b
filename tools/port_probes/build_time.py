"""Seconds the port's ``build_*`` functions take for seeded models on
the CPU.

``build_ssl`` (student and teacher) of each SSL config and
``build_detector`` of each LiDAR zoo detector at its default widths run
``--reps`` times from ``torch.manual_seed(0)``; one JSON line a model
gives the minimum and the median. TREE (default this checkout) is the
root of a checkout of the repo, so that a parent tree unpacked with
``git archive`` is timed the same way; run trees in turns (parent,
this, this, parent) to see the host's spread:

    python3 tools/port_probes/build_time.py [TREE] [--reps N]
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

SSL_CONFIGS = ("configs/tests/ssl_tiny.py",
               "configs/detmatch/001/detmatch/split_0.py")
ZOO = ("SECOND", "SECONDNetIoU", "PointPillar", "VoxelRCNN", "PartA2Net",
       "PointRCNN")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree", nargs="?",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    from detmatch_tpu_torch.apis.build import build_detector, build_ssl
    from detmatch_tpu_torch.config import Config

    def timed(build):
        secs = []
        for _ in range(args.reps):
            torch.manual_seed(0)
            t0 = time.perf_counter()
            model = build()
            secs.append(time.perf_counter() - t0)
            del model
        return dict(min_s=min(secs), median_s=statistics.median(secs))

    jobs = [(name, lambda c=str(tree / name): build_ssl(
        Config.fromfile(c), "cpu")) for name in SSL_CONFIGS]
    jobs += [(kind, lambda k=kind: build_detector(
        {"model": {"detector_3d": dict(type=k)}}, "cpu")) for kind in ZOO]
    for name, build in jobs:
        print(json.dumps(dict(tree=str(tree), model=name,
                              reps=args.reps,
                              threads=torch.get_num_threads(),
                              **timed(build))), flush=True)


if __name__ == "__main__":
    main()
