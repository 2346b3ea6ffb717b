"""Multi-process training launcher (counterpart of ``tools/dist_train.py``;
reference ``tools/dist_train.sh`` / ``tools/slurm_train.sh``).

Usage:
    python -m detmatch_tpu_torch.tools.dist_train --nproc N [--port P |
        --coordinator ADDRESS] -- CONFIG [train arguments ...]

Everything after ``--`` goes to ``python -m detmatch_tpu_torch.tools.train``.
Two launch modes:

* ``--nproc N``: spawn N processes on this machine, each with the
  ``DETMATCH_*`` environment (``parallel.init_distributed``); process r
  takes ``cuda:{r % device_count}``, over NCCL, or the CPU over gloo with
  ``--device cpu``. If one process fails, the others are stopped and the
  launcher exits with its code.
* under SLURM (``SLURM_PROCID`` set, no ``--nproc``): become the training
  process of this task, the coordinator on the first node of the job.

JAX's ``--local-devices`` (virtual CPU devices per process) has no
counterpart: a process here drives exactly one device.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

TRAIN = [sys.executable, "-m", "detmatch_tpu_torch.tools.train"]
# the directory that holds the package, for the spawned interpreters
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _env(coordinator, nproc, pid):
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH"))
                           if p)
    return dict(os.environ, PYTHONPATH=path,
                DETMATCH_COORDINATOR=coordinator,
                DETMATCH_NUM_PROCESSES=str(nproc),
                DETMATCH_PROCESS_ID=str(pid))


def _wait_all(procs, poll=0.5):
    """Wait for every process; the first to fail stops the others (they
    would wait at their next collective). Returns the first non-zero exit
    code, else 0."""
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(poll)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    fwd = []
    if "--" in argv:
        i = argv.index("--")
        argv, fwd = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        epilog="JAX's --local-devices has no counterpart: one process "
               "drives one device.")
    ap.add_argument("--nproc", type=int, default=None,
                    help="spawn N local processes, one device each")
    ap.add_argument("--port", type=int, default=29400,
                    help="the coordinator's port on localhost (or on the "
                         "first SLURM node)")
    ap.add_argument("--coordinator", default=None,
                    help="the coordinator address instead of "
                         "localhost:PORT (host:port, tcp:// or file://)")
    args = ap.parse_args(argv)

    if os.environ.get("SLURM_PROCID") is not None and args.nproc is None:
        nodes = subprocess.check_output(
            ["scontrol", "show", "hostnames",
             os.environ["SLURM_JOB_NODELIST"]], text=True).split()
        env = _env(args.coordinator or f"{nodes[0]}:{args.port}",
                   int(os.environ["SLURM_NTASKS"]),
                   int(os.environ["SLURM_PROCID"]))
        os.execve(sys.executable, TRAIN + fwd, env)
    if not args.nproc or args.nproc < 1:
        ap.error("--nproc N is needed outside SLURM")
    coordinator = args.coordinator or f"localhost:{args.port}"
    procs = [subprocess.Popen(TRAIN + fwd,
                              env=_env(coordinator, args.nproc, pid))
             for pid in range(args.nproc)]
    return _wait_all(procs)


if __name__ == "__main__":
    sys.exit(main())
