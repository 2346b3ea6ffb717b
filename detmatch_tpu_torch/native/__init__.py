"""The KITTI evaluation's matcher in C (counterpart of
``detmatch_tpu/native/``; ``kitti_eval.c`` is a copy of its source):
the devkit's sequential per-image matching, which the reference runs in
numba, without the Python interpreter in the per-image, per-threshold
sweep.

The library is built with ``cc`` at its first use, into ``build/native/``
at the repository root, named by a hash of the source, so an unchanged
source never rebuilds. :func:`get_lib` returns None when it cannot be
built or loaded, and the evaluation then takes its numpy sweep.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "kitti_eval.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ("-O3", "-shared", "-fPIC")
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CFLAGS).encode())
    return BUILD_DIR / f"libkitti_eval-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; raises with the compiler's
    output when ``cc`` fails. The output is written under a name of this
    process's own and renamed, so concurrent builds never see half a
    file."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["cc", *CFLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cc failed on {SRC}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError):
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.gather_tp_scores.restype = ctypes.c_int
    lib.gather_tp_scores.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, i32p, i32p,
        ctypes.c_float, f32p]
    lib.sweep_thresholds.restype = None
    lib.sweep_thresholds.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int, f32p,
        i32p, i32p, ctypes.c_float, f32p, ctypes.c_int, i64p, i64p, i64p]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.sweep_thresholds_aos.restype = None
    lib.sweep_thresholds_aos.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int, f32p,
        i32p, i32p, f32p, f32p, ctypes.c_float, f32p, ctypes.c_int,
        i64p, i64p, i64p, f64p]
    _lib = lib
    return lib


def _ptr(a, t):
    return a.ctypes.data_as(t)


def gather_tp_scores(overlaps, scores, gt_ignored, det_ignored,
                     min_overlap):
    lib = get_lib()
    assert lib is not None
    n_det, n_gt = overlaps.shape
    out = np.zeros((max(n_gt, 1),), np.float32)
    overlaps = np.ascontiguousarray(overlaps, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    gt_ignored = np.ascontiguousarray(gt_ignored, np.int32)
    det_ignored = np.ascontiguousarray(det_ignored, np.int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = lib.gather_tp_scores(
        _ptr(overlaps, f32p), n_det, n_gt, _ptr(scores, f32p),
        _ptr(gt_ignored, i32p), _ptr(det_ignored, i32p),
        ctypes.c_float(min_overlap), _ptr(out, f32p))
    return out[:n]


def sweep_thresholds(overlaps, dc_iof, scores, gt_ignored, det_ignored,
                     min_overlap, thresholds, tps, fps, fns):
    """Accumulate tp/fp/fn (int64 arrays, modified in place)."""
    lib = get_lib()
    assert lib is not None
    n_det, n_gt = overlaps.shape
    overlaps = np.ascontiguousarray(overlaps, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    gt_ignored = np.ascontiguousarray(gt_ignored, np.int32)
    det_ignored = np.ascontiguousarray(det_ignored, np.int32)
    thresholds = np.ascontiguousarray(thresholds, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    if dc_iof is not None and dc_iof.size:
        dc = np.ascontiguousarray(dc_iof, np.float32)
        dc_ptr, n_dc = _ptr(dc, f32p), dc.shape[1]
    else:
        dc_ptr, n_dc = f32p(), 0
    lib.sweep_thresholds(
        _ptr(overlaps, f32p), n_det, n_gt, dc_ptr, n_dc,
        _ptr(scores, f32p), _ptr(gt_ignored, i32p),
        _ptr(det_ignored, i32p), ctypes.c_float(min_overlap),
        _ptr(thresholds, f32p), len(thresholds),
        _ptr(tps, i64p), _ptr(fps, i64p), _ptr(fns, i64p))


def sweep_thresholds_aos(overlaps, dc_iof, scores, gt_ignored,
                         det_ignored, gt_alphas, dt_alphas, min_overlap,
                         thresholds, tps, fps, fns, sims):
    """Accumulate tp/fp/fn + per-threshold TP orientation similarity
    (AOS numerator, reference eval.py:250-275). Arrays modified in
    place; ``sims`` is float64 (n_thr,)."""
    lib = get_lib()
    assert lib is not None
    n_det, n_gt = overlaps.shape
    overlaps = np.ascontiguousarray(overlaps, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    gt_ignored = np.ascontiguousarray(gt_ignored, np.int32)
    det_ignored = np.ascontiguousarray(det_ignored, np.int32)
    gt_alphas = np.ascontiguousarray(gt_alphas, np.float32)
    dt_alphas = np.ascontiguousarray(dt_alphas, np.float32)
    thresholds = np.ascontiguousarray(thresholds, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    if dc_iof is not None and dc_iof.size:
        dc = np.ascontiguousarray(dc_iof, np.float32)
        dc_ptr, n_dc = _ptr(dc, f32p), dc.shape[1]
    else:
        dc_ptr, n_dc = f32p(), 0
    lib.sweep_thresholds_aos(
        _ptr(overlaps, f32p), n_det, n_gt, dc_ptr, n_dc,
        _ptr(scores, f32p), _ptr(gt_ignored, i32p),
        _ptr(det_ignored, i32p), _ptr(gt_alphas, f32p),
        _ptr(dt_alphas, f32p), ctypes.c_float(min_overlap),
        _ptr(thresholds, f32p), len(thresholds),
        _ptr(tps, i64p), _ptr(fps, i64p), _ptr(fns, i64p),
        _ptr(sims, f64p))
