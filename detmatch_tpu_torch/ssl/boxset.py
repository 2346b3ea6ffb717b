"""BoxSet: the fixed-shape currency of the SSL pipeline (counterpart of
``detmatch_tpu/ssl/boxset.py``).

A BoxSet is a dict of fixed-capacity tensors:

    boxes:  (B, K, D)   D = 7 (3D) or 4 (2D xyxy)
    scores: (B, K, C)   per-class sigmoid scores, background not stored
    valid:  (B, K) bool

Filtering never changes shapes, it clears validity bits; gathering
(matching) produces index maps and validity.
"""
from __future__ import annotations

import torch

from ..parallel import global_count


def make(boxes, scores, valid):
    return dict(boxes=boxes, scores=scores, valid=valid)


def detach(bs):
    """DetachBboxes."""
    return {k: v.detach() for k, v in bs.items()}


def max_score_filter(bs, score_thr):
    """MaxScoreFilter: keep boxes whose highest class score exceeds the
    threshold."""
    return dict(boxes=bs["boxes"], scores=bs["scores"],
                valid=bs["valid"] & (bs["scores"].amax(-1) > score_thr))


def gather(bs, idx, valid):
    """Select slots by per-frame index maps idx (B, K') and validity
    (B, K'); invalid slots come out zero."""
    idx = idx.long()
    taken = bs["valid"].gather(1, idx) & valid
    boxes = bs["boxes"].gather(1, idx[..., None].expand(
        *idx.shape, bs["boxes"].shape[-1]))
    scores = bs["scores"].gather(1, idx[..., None].expand(
        *idx.shape, bs["scores"].shape[-1]))
    return dict(boxes=torch.where(taken[..., None], boxes, 0.0),
                scores=torch.where(taken[..., None], scores, 0.0),
                valid=taken)


def average(bs1, bs2):
    """AverageBboxes_2D: the element-wise mean of two slot-aligned sets."""
    valid = bs1["valid"] & bs2["valid"]
    return dict(
        boxes=torch.where(valid[..., None],
                          (bs1["boxes"] + bs2["boxes"]) / 2.0, 0.0),
        scores=torch.where(valid[..., None],
                           (bs1["scores"] + bs2["scores"]) / 2.0, 0.0),
        valid=valid)


def num_valid(bs):
    """NumPreds: the mean number of valid boxes per frame of the global
    batch (this process's share: its frames' sum over the global frame
    count)."""
    v = bs["valid"].to(torch.float32)
    return v.sum(-1).sum() / global_count(v.shape[0])


def topk(bs, k):
    """Compact to the k highest-scoring valid slots (ties to the lower
    slot, as ``jax.lax.top_k``); a pure re-indexing when <= k are
    valid."""
    score = torch.where(bs["valid"], bs["scores"].amax(-1), -1e30)
    idx = torch.sort(score, dim=1, descending=True, stable=True).indices
    idx = idx[:, :k]
    return gather(bs, idx, bs["valid"].gather(1, idx))
