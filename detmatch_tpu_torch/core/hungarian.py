"""Exact masked rectangular assignment (counterpart of
``detmatch_tpu/core/hungarian.py``): scipy ``linear_sum_assignment``
semantics on the valid submatrix, computed on the device by the
Jonker-Volgenant solver of ``ops/cuda/hungarian.py`` (kernel K4 on the
card, its plain twin on the CPU).

Rows are inserted only if valid and the smaller side is always the one
inserted (transposing where needed), so the BIG padding of invalid
columns is never selected and never reaches the potentials.
"""
from __future__ import annotations

import torch

from ..ops.cuda.hungarian import BIG, solve_masked_batched


def _post(cost, row_valid, col_valid, col4row):
    """Matched cost of each row (+inf if unmatched); rows whose match is
    invalid on either side become -1."""
    k = cost.shape[-1]
    safe = col4row.clamp(0, k - 1).long()
    mcost = cost.gather(-1, safe[..., None])[..., 0]
    ok = (col4row >= 0) & row_valid & col_valid.gather(-1, safe)
    return (torch.where(ok, col4row, -1),
            torch.where(ok, mcost, torch.inf))


def _cols_to_rows(p):
    """(..., K) column → row map to the (..., K) row → column map; the
    unmatched columns scatter into a K+1'th slot that is cut off."""
    k = p.shape[-1]
    idx = torch.where(p >= 0, p, k).long()
    c4r = torch.full(p.shape[:-1] + (k + 1,), -1, dtype=torch.int32,
                     device=p.device)
    cols = torch.arange(k, dtype=torch.int32, device=p.device)
    c4r.scatter_(-1, idx, cols.expand_as(p).contiguous())
    return c4r[..., :k]


def assign(cost, row_valid, col_valid):
    """Masked rectangular assignment of one (K, K) problem: a batch of
    one through :func:`assign_batched`.

    Returns (col4row (K,) int32 with -1 for unmatched or invalid rows,
    match_cost (K,) float32, +inf where unmatched)."""
    return tuple(x[0] for x in assign_batched(
        cost[None], row_valid[None], col_valid[None]))


def assign_batched(cost, row_valid, col_valid,
                   solve=solve_masked_batched):
    """Masked rectangular assignment of B problems: each element is
    oriented so that its smaller side is inserted, then ONE batched JV
    solve runs.

    Args:
        cost: (B, K, K) float32; row_valid, col_valid: (B, K) bool.
        solve: the batched solver, ``ops.solve_masked_batched`` of the
            caller's ``Ops`` (kernel K4 by default).
    Returns:
        (col4row (B, K) int32 with -1 for unmatched or invalid rows,
        matched_cost (B, K) float32, +inf where unmatched).
    """
    nr = row_valid.sum(1)
    nc = col_valid.sum(1)
    transposed = (nr > nc)[:, None]
    c_rows = torch.where(col_valid[:, None, :], cost, BIG)
    c_cols = torch.where(row_valid[:, None, :], cost.transpose(1, 2), BIG)
    c_eff = torch.where(transposed[:, :, None], c_cols, c_rows).contiguous()
    rv_eff = torch.where(transposed, col_valid, row_valid).contiguous()
    p = solve(c_eff, rv_eff)
    col4row = torch.where(transposed, p, _cols_to_rows(p))
    return _post(cost, row_valid, col_valid, col4row)
