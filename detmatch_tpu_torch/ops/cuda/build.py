"""Builds and binds the port's CUDA kernels.

``detmatch_tpu_torch/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``, one
process per source, all started together, and link into one shared
library with a plain C interface under ``build/kernels/`` at the
repository root, named by a hash of the sources and flags, so an
unchanged tree never rebuilds. The library is loaded with ``ctypes``:
pointers and the stream pass as ``c_void_p``, and every launch function
returns a ``cudaError_t`` that :func:`check` raises on.

Nothing here runs at import time; the first kernel call builds and loads.
A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
# C signatures of the launch functions in csrc/ (all return int).
SIGNATURES = {
    "dm_fps": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "dm_fps_active_clusters": (_I, _I, _P),
    "dm_ball_query": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _P),
    "dm_window_key_conv_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _P),
    "dm_window_key_conv_bwd": (_P, _P, _P, _P, _P, _L, _P, _P, _P, _P, _P,
                               _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "dm_hungarian_jv": (_P, _P, _P, _I, _I, _I, _P),
    "dm_key_conv_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _P),
    "dm_key_conv_bwd_scatter": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "dm_gather_conv_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _P),
    "dm_onehot_gather_conv_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _P),
    "dm_onehot_gather_direct": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "dm_onehot_take_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
    "dm_slot_keys": (_P, _P, _I, _I, _I, _I, _P),
    "dm_segment_sum_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}


class BuildResult(NamedTuple):
    path: Path
    seconds: float   # wall time of this call's compile, 0 if cached
    built: bool      # False when an identical library already existed
    log: str         # nvcc's output (ptxas resource usage)


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       f"({home}); the CUDA kernels cannot be built")


def library_path():
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdetmatch_kernels_{h.hexdigest()[:16]}.so"


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    every source in its own ``nvcc`` process, all at once, then one
    link."""
    lib = library_path()
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(lib, 0.0, False, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(CSRC_DIR))))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    tmp = lib.with_name(f"{tag}.tmp.so")
    if not failed:
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=str(CSRC_DIR))
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{logs[-1]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    log = "".join(logs)
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: concurrent builds agree on the file
    return BuildResult(lib, seconds, True, log)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build if needed, load, and declare the C signatures."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dm_error_string.argtypes = (ctypes.c_int,)
    lib.dm_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, err, name):
    """Raise if a launch function returned anything but cudaSuccess."""
    if err != 0:
        msg = lib.dm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def ptr(t: torch.Tensor | None):
    """A tensor's device pointer; None passes a null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(name, *tensors):
    """Every tensor on one CUDA device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


def require_dtype(name, t, dtype, what):
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
