"""Batched masked Jonker-Volgenant assignment: CUDA kernel
``csrc/hungarian_jv.cu`` (replacing the TPU kernel
``detmatch_tpu/ops/pallas/hungarian.py:_jv_pallas``) and its plain
PyTorch twin :func:`solve_masked_plain`, the JAX package's
``core/hungarian.py:_solve_masked`` in its exact float order.

On a CPU tensor the wrapper runs the twin; on a CUDA tensor it launches
the kernel or raises. The kernel reproduces the twin's matching exactly
for finite costs. :func:`jv_plan` picks the kernel's design from K
before the launch: one warp per problem, ``cols`` columns a lane, up to
K = 128; one block per problem above.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import build

BIG = 1e9    # cost of a padded (invalid) column
INF = 1e18   # "no path yet" (fp32)
# csrc/hungarian_jv.cu: K up to 1,024 (the block design's thread a
# column); the warp design's columns a lane (kWarpMaxCols)
MAX_K = 1024
WARP_MAX_COLS = 4


class JvPlan(NamedTuple):
    cols: int   # columns a lane of the warp design; 0 = the block design
    smem: int   # dynamic shared bytes of a block


def jv_plan(k):
    """K4's design for K columns, as ``csrc/hungarian_jv.cu`` sizes it:
    one warp a problem with ceil(K / 32) columns a lane while K <= 128
    (the valid rows' costs staged at a row stride of 32 * cols floats,
    then u, p and way by column); above, one thread a column (u, p and
    way in shared memory)."""
    if not 0 < k <= MAX_K:
        raise ValueError(f"solve_masked_batched: needs 0 < K <= {MAX_K}, "
                         f"got K={k}")
    cols = math.ceil(k / 32)
    if cols <= WARP_MAX_COLS:
        return JvPlan(cols, 4 * (k * 32 * cols + 3 * k))
    return JvPlan(0, 4 * 3 * k)


def solve_masked_plain(cost, row_valid):
    """Plain twin of the kernel: the row matched to each column (see
    :func:`_lockstep_jv`)."""
    return _lockstep_jv(cost, row_valid)[0]


def inner_steps(cost, row_valid):
    """For measurement only: the (B,) int64 count of inner steps the
    solve of each element takes (see :func:`_lockstep_jv`)."""
    return _lockstep_jv(cost, row_valid)[1]


def _lockstep_jv(cost, row_valid):
    """Insert each problem's valid rows one at a time by shortest
    augmenting paths (JAX ``_solve_masked``), the B problems in lockstep.

    Every inner step of every element runs JAX's operations in its order:
    ``cur = (cost[i0] - u[i0]) - v``, ``minv - delta``, ``u + delta``,
    ``v - delta``, a strict ``cur < minv`` and the first-occurrence argmin
    of ``where(used, INF, minv)``. An element whose path has ended takes
    no further updates while the others go on. The virtual start column
    K is stored nowhere: reading ``p`` there gives the inserted row.

    Args:
        cost: (B, K, K) float32, invalid columns padded with BIG; finite.
        row_valid: (B, K) bool, the rows to insert. Each element needs
            #valid rows <= #valid columns (the caller orients).
    Returns:
        p: (B, K) int32, the row matched to each column, -1 if none, and
        steps: (B,) int64, the inner steps each element took.
    """
    b, k, _ = cost.shape
    dev = cost.device
    cols = torch.arange(k, device=dev)
    bidx = torch.arange(b, device=dev)
    u = torch.zeros((b, k), dtype=torch.float32, device=dev)
    v = torch.zeros((b, k), dtype=torch.float32, device=dev)
    p = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    steps = torch.zeros(b, dtype=torch.int64, device=dev)
    virt = k
    rows_valid = row_valid.cpu()
    for i in range(k):
        active = rows_valid[:, i].to(dev)
        if not bool(rows_valid[:, i].any()):
            continue
        minv = torch.full((b, k), INF, dtype=torch.float32, device=dev)
        way = torch.full((b, k), virt, dtype=torch.int64, device=dev)
        used = torch.zeros((b, k), dtype=torch.bool, device=dev)
        row_used = torch.zeros((b, k), dtype=torch.bool, device=dev)
        j0 = torch.full((b,), virt, dtype=torch.int64, device=dev)
        done = ~active
        for _ in range(k + 1):  # a finite cost matrix ends well before
            if bool(done.all()):
                break
            upd = ~done
            steps += upd.to(torch.int64)
            at_j0 = p.gather(1, j0.clamp(max=k - 1)[:, None])[:, 0]
            i0 = torch.where(j0 == virt, i, at_j0).clamp(min=0)
            used |= upd[:, None] & (cols[None] == j0[:, None])
            row_used |= upd[:, None] & (cols[None] == i0[:, None])
            crow = cost[bidx, i0]
            cur = (crow - u[bidx, i0][:, None]) - v
            better = (cur < minv) & ~used & upd[:, None]
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0[:, None], way)
            masked = torch.where(used, INF, minv)
            delta = masked.min(1).values
            j1 = torch.where(masked == delta[:, None], cols[None], k
                             ).min(1).values
            u = u + torch.where(row_used & upd[:, None], delta[:, None], 0.0)
            v = v - torch.where(used & upd[:, None], delta[:, None], 0.0)
            minv = torch.where(~used & upd[:, None], minv - delta[:, None],
                               minv)
            j0 = torch.where(upd, j1, j0)
            p_j1 = p.gather(1, j1.clamp(max=k - 1)[:, None])[:, 0]
            done = done | (upd & (p_j1 == -1))
        # flip each path back: p[j0] = p[way[j0]] until the virtual column
        live = active.clone()
        for _ in range(k + 1):
            if not bool(live.any()):
                break
            jc = j0.clamp(max=k - 1)
            w = way.gather(1, jc[:, None])[:, 0]
            pw = torch.where(w == virt, i,
                             p.gather(1, w.clamp(max=k - 1)[:, None])[:, 0])
            p[bidx[live], jc[live]] = pw[live]
            j0 = torch.where(live, w, j0)
            live = live & (j0 != virt)
    return p.to(torch.int32), steps


def solve_masked_batched(cost, row_valid):
    """Batched masked rectangular JV solve (JAX
    ``ops/pallas/hungarian.solve_masked_batched``).

    Args:
        cost: (B, K, K) float32, invalid columns padded with BIG, finite;
            1 <= K <= MAX_K on the card.
        row_valid: (B, K) bool, the rows to insert; per element
            #valid rows <= #valid columns.
    Returns:
        p: (B, K) int32, the row matched to each column, -1 if none.
    """
    if cost.device.type == "cpu":
        return solve_masked_plain(cost, row_valid)
    name = "solve_masked_batched"
    build.require_cuda(name, cost, row_valid)
    build.require_dtype(name, cost, torch.float32, "cost")
    build.require_dtype(name, row_valid, torch.bool, "row_valid")
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2] or \
            row_valid.shape != cost.shape[:2]:
        raise ValueError(f"{name}: cost (B, K, K) and row_valid (B, K) "
                         f"expected, got {tuple(cost.shape)} and "
                         f"{tuple(row_valid.shape)}")
    return solve_masked_launch(cost, row_valid, jv_plan(cost.shape[-1]))


def solve_masked_launch(cost, row_valid, plan):
    """Launch K4 with ``plan`` (:func:`jv_plan`, or another design for
    measurement: ``cols`` 1-4 with 32 * cols >= K, or 0)."""
    b, k, _ = cost.shape
    out = torch.empty((b, k), dtype=torch.int32, device=cost.device)
    lib = build.load_library()
    err = lib.dm_hungarian_jv(build.ptr(cost), build.ptr(row_valid),
                              build.ptr(out), b, k, plan.cols,
                              build.stream(cost.device))
    solve_masked_batched.launches += 1
    build.check(lib, err, "solve_masked_batched")
    return out


solve_masked_batched.launches = 0
