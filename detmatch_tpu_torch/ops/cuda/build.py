"""Builds and binds the port's CUDA kernels.

``detmatch_tpu_torch/csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface under ``build/kernels/``
at the repository root, named by a hash of the sources and flags, so an
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the launch functions in csrc/ (all return int).
SIGNATURES = {
    "dm_fps": (_P, _P, _P, _I, _I, _I, _P),
    "dm_ball_query": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I,
                      _P),
    "dm_window_key_conv_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P),
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdetmatch_kernels_{h.hexdigest()[:16]}.so"


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    lib = library_path()
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(lib, 0.0, False, log)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC_DIR.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          cwd=str(CSRC_DIR))
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
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


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


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
