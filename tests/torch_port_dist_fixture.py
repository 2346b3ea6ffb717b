"""Multi-process harness of the port's data-parallel CPU tests
(``test_torch_port_distributed*.py``).

:func:`run_workers` writes a worker script and starts N processes of it,
each one rank of a gloo process group on a ``file://`` store under the
test's ``tmp_path`` (no port, so parallel test workers never collide),
with one PyTorch thread. A worker's body sees ``rank``, ``world``,
``out`` (a directory) and ``save(obj)``, which writes ``rank<r>.pt``
there; :func:`run_workers` returns the saved objects in rank order. A
worker that fails, or outlasts the timeout, fails the test with its
output.
"""
import os
import subprocess
import sys
import textwrap

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

PROLOGUE = """\
import os, sys
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sys.path[:0] = [{root!r}, {tests!r}]
import numpy as np
import torch
torch.set_num_threads(1)
from detmatch_tpu_torch import parallel
parallel.start_group("file://" + os.path.join(out, "store"), world, rank,
                     backend="gloo")


def save(obj):
    torch.save(obj, os.path.join(out, f"rank{{rank}}.pt"))


"""
EPILOGUE = """
parallel.shutdown()
"""


def run_workers(tmp_path, body, n=2, timeout=120, env=None):
    """Run ``body`` (Python source, dedented) in ``n`` ranks; returns
    what each saved, in rank order."""
    out = str(tmp_path)
    script = os.path.join(out, "worker.py")
    with open(script, "w") as f:
        f.write(PROLOGUE.format(root=ROOT, tests=os.path.join(ROOT, "tests"))
                + textwrap.dedent(body) + EPILOGUE)
    run_env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    logs = [open(os.path.join(out, f"rank{r}.log"), "w+") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, script, str(r), str(n), out],
                              stdout=log, stderr=subprocess.STDOUT,
                              env=run_env, cwd=ROOT)
             for r, log in enumerate(logs)]
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
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]
