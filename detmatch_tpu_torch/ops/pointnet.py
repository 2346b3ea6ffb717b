"""PointNet++-style set ops (counterpart of ``detmatch_tpu/ops/pointnet.py``):
row gather, the plain farthest-point sampling and ball query that the
CUDA kernels in ``ops/cuda`` are held against, and the 3-NN
interpolation of PointNet++'s feature propagation.

Squared distances are written as three products and two sums in a fixed
order, ``dx*dx + dy*dy + dz*dz``: the kernels compute the same with
round-to-nearest intrinsics (no FMA contraction), so integer outputs
(indices, counts) agree exactly even on near-ties.
"""
from __future__ import annotations

import numpy as np
import torch

BIG_DIST = 1e10


class _TakeRows(torch.autograd.Function):
    """``table[idx]`` whose backward sums each row's gradients in float32
    and casts the sum to the table's dtype once."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        acc = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        acc.index_add_(0, idx.reshape(-1),
                       g.reshape(-1, ctx.shape[-1]).float())
        return acc.to(g.dtype), None


def take_rows(table, idx):
    """Rows ``idx`` (int64, any shape) of a (N, C) table.

    A bfloat16 table's backward accumulates in float32, as the JAX
    package's ``pointnet._fenced_take_rows`` does: a row of the RoI-grid
    pool's table collects thousands of contributions, which bfloat16
    sums would round away. Float32 tables take plain indexing."""
    if table.dtype == torch.float32 or not table.requires_grad:
        return table[idx]
    return _TakeRows.apply(table, idx)


def gather_rows(x, idx):
    """(B, N, C) table, (B, ...) int row indices → (B, ..., C); a bfloat16
    table through :func:`take_rows`."""
    b = x.shape[0]
    if x.dtype != torch.float32:
        n = x.shape[1]
        base = torch.arange(b, device=idx.device).reshape(
            (b,) + (1,) * (idx.dim() - 1)) * n
        out = take_rows(x.reshape(b * n, x.shape[-1]), idx.long() + base)
        return out.reshape(idx.shape + (x.shape[-1],))
    flat = idx.reshape(b, -1).long()
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(idx.shape + (x.shape[-1],))


def sq_dist(ax, ay, az, bx, by, bz):
    """(a - b)² summed over xyz as ((dx·dx + dy·dy) + dz·dz)."""
    dx = ax - bx
    dy = ay - by
    dz = az - bz
    return dx * dx + dy * dy + dz * dz


def farthest_point_sample(xyz, valid, num_samples):
    """Plain batched greedy farthest-point sampling.

    Starts from the first valid point; argmax takes the first occurrence;
    invalid points hold distance -1 and are never chosen (an all-invalid
    row yields index 0 throughout).

    Args:
        xyz: (B, N, 3) float32; valid: (B, N) bool.
    Returns:
        (B, num_samples) int32.
    """
    b, n, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    d2 = torch.where(valid, BIG_DIST, -1.0).to(xyz.dtype)
    last = torch.argmax(valid.to(torch.int32), dim=1)
    out = torch.zeros(b, num_samples, dtype=torch.int32, device=xyz.device)
    out[:, 0] = last.to(torch.int32)
    rows = torch.arange(b, device=xyz.device)
    for i in range(1, num_samples):
        nd = sq_dist(x, y, z, x[rows, last][:, None], y[rows, last][:, None],
                     z[rows, last][:, None])
        d2 = torch.minimum(d2, torch.where(valid, nd, -1.0))
        last = torch.argmax(d2, dim=1)
        out[:, i] = last.to(torch.int32)
    return out


def ball_query(centers, centers_valid, points, points_valid, r2, nsample,
               chunk=512):
    """Plain batched ball query over a point table in scan order.

    The first ``nsample`` points (in table order) with squared distance
    ``<= r2`` are kept; unused slots repeat the first hit; an empty ball
    gives table position 0 in every slot and count 0.

    Args:
        centers: (B, M, 3); points: (B, N, 3); *_valid: bool masks;
        r2: the squared radius, a float32 value (see :func:`radius_sq`).
    Returns:
        (idx (B, M, nsample) int32 table positions, cnt (B, M) int32).
    """
    b, m, _ = centers.shape
    n = points.shape[1]
    dev = centers.device
    px, py, pz = (t[:, None, :] for t in points.unbind(-1))
    ar_n = torch.arange(n, dtype=torch.int32, device=dev).expand(b, 1, n)
    slots = torch.arange(nsample, device=dev)
    idx_out, cnt_out = [], []
    for s in range(0, m, chunk):
        c = centers[:, s:s + chunk]
        cx, cy, cz = (t[..., None] for t in c.unbind(-1))
        within = ((sq_dist(cx, cy, cz, px, py, pz) <= r2)
                  & points_valid[:, None, :]
                  & centers_valid[:, s:s + chunk, None])
        rank = torch.cumsum(within.to(torch.int32), dim=2)  # inclusive
        cnt = torch.clamp(rank[..., -1], max=nsample)
        # slot rank-1 for the first nsample hits, a trash column otherwise
        col = torch.where(within & (rank <= nsample), rank - 1, nsample)
        buf = torch.zeros(b, c.shape[1], nsample + 1, dtype=torch.int32,
                          device=dev)
        buf.scatter_(2, col.long(), ar_n.expand(-1, c.shape[1], -1))
        idx = buf[..., :nsample]
        filled = slots < torch.clamp(cnt, min=1)[..., None]
        idx_out.append(torch.where(filled, idx, idx[..., :1]))
        cnt_out.append(cnt.to(torch.int32))
    return torch.cat(idx_out, 1), torch.cat(cnt_out, 1)


def radius_sq(radius):
    """The squared radius as the JAX reference computes it: float32(r)
    squared in float32."""
    r = np.float32(radius)
    return np.float32(r * r)


def three_nn(queries, queries_valid, points, points_valid, chunk=4096):
    """The 3 nearest valid points of each query (pcdet ``three_nn``),
    batched; ties go to the lower index, as ``lax.top_k``'s.

    Args:
        queries: (B, Q, 3); points: (B, N, 3), N >= 3; *_valid: bool.
    Returns:
        (dists (B, Q, 3) nearest first, BIG_DIST for an invalid query;
        idx (B, Q, 3) int32).
    """
    px, py, pz = (t[:, None, :] for t in points.unbind(-1))
    d_out, i_out = [], []
    for s in range(0, queries.shape[1], chunk):
        qx, qy, qz = (t[..., None] for t in queries[:, s:s + chunk].unbind(-1))
        d2 = torch.where(points_valid[:, None, :],
                         sq_dist(qx, qy, qz, px, py, pz), BIG_DIST)
        picks, vals = [], []
        for _ in range(3):  # argmin takes the first minimum
            i = torch.argmin(d2, dim=-1, keepdim=True)
            vals.append(torch.gather(d2, -1, i))
            picks.append(i)
            d2 = d2.scatter(-1, i, torch.inf)
        d_out.append(torch.sqrt(torch.clamp(torch.cat(vals, -1), min=0.0)))
        i_out.append(torch.cat(picks, -1).to(torch.int32))
    dists = torch.where(queries_valid[..., None], torch.cat(d_out, 1),
                        BIG_DIST)
    return dists, torch.cat(i_out, 1)


def three_interpolate(feats, idx, dists, eps=1e-8):
    """Inverse-squared-distance weighted sum over the 3 neighbours
    (pcdet ``three_interpolate``): feats (B, N, C), idx (B, Q, 3),
    dists (B, Q, 3) → (B, Q, C)."""
    w = 1.0 / torch.clamp(dists * dists, min=eps)
    w = w / w.sum(-1, keepdim=True)
    return (gather_rows(feats, idx) * w[..., None]).sum(2)
