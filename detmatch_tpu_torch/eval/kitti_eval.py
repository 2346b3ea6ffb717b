"""KITTI AP evaluation (AP_R40), devkit semantics (counterpart of
``detmatch_tpu/eval/kitti_eval.py``, equal to it AP for AP).

Reimplements the reference's numba evaluation
(``mmdet3d/core/evaluation/kitti_utils/eval.py``: clean_data:28,
get_thresholds:578, compute_statistics_jit:161, eval_class:450,
get_mAP_R40) in plain numpy, the C matcher of ``native/`` and the
port's torch rotated IoU (``core/iou.py``) on a device the caller names,
operating
directly on internal-convention LiDAR boxes (the camera-frame detour of the
reference is unnecessary — IoU is frame-invariant).

Conventions mirrored:
* classes Car/Pedestrian/Cyclist with neighbor-class ignores
  (Van→Car, Person_sitting→Pedestrian);
* difficulty gating by bbox height / occlusion / truncation;
* det ignore by projected-2D height < min height of the difficulty;
* DontCare regions absorb otherwise-FP detections (bbox metric, IoF);
* 41-point threshold sweep from TP scores; AP_R40 averages precision at
  recall points 1..40 (×100).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..core import geometry, iou as iou_mod

CLASSES = ("Pedestrian", "Cyclist", "Car")
# neighbor classes whose gts are ignored (not penalized) per class
SIMILAR = {"Car": ("Van",), "Pedestrian": ("Person_sitting",),
           "Cyclist": ()}
MIN_HEIGHT = (40.0, 25.0, 25.0)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)
# strict min overlaps (reference overlap_0_7): Car 0.7, Ped/Cyc 0.5 for all
# of bbox/bev/3d
MIN_OVERLAP = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
N_SAMPLE_PTS = 41


def clean_gt(gt, cls, difficulty):
    """→ ignored flags per gt: 0 count, 1 ignore, -1 exclude; plus dontcare
    bboxes (reference clean_data, eval.py:28)."""
    names = gt["name"]
    n = len(names)
    ignored = np.full((n,), -1, np.int32)
    heights = gt["bbox"][:, 3] - gt["bbox"][:, 1]
    for i in range(n):
        name = names[i]
        if name == cls:
            valid = 0
        elif name in SIMILAR[cls]:
            valid = 1
        elif cls == "Pedestrian" and name == "Person_sitting":
            valid = 1
        else:
            continue
        too_hard = (
            gt["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt["truncated"][i] > MAX_TRUNCATION[difficulty]
            or heights[i] <= MIN_HEIGHT[difficulty]
        )
        if valid == 0 and not too_hard:
            ignored[i] = 0
        else:
            ignored[i] = 1
    dc = gt["bbox"][names == "DontCare"]
    return ignored, dc


def clean_det(det, cls, difficulty):
    """→ det flags: 0 count, 1 ignore (too small), -1 exclude (other
    class)."""
    n = len(det["labels"])
    ignored = np.full((n,), -1, np.int32)
    cls_id = CLASSES.index(cls)
    heights = det["bbox"][:, 3] - det["bbox"][:, 1]
    same = det["labels"] == cls_id
    ignored[same & (heights >= MIN_HEIGHT[difficulty])] = 0
    ignored[same & (heights < MIN_HEIGHT[difficulty])] = 1
    return ignored


def get_thresholds(scores, num_gt):
    """Reference eval.py get_thresholds: recall-spaced score thresholds."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (N_SAMPLE_PTS - 1)
    return np.array(thresholds, np.float32)


def _statistics(overlaps, dc_iof, scores, gt_ignored, det_ignored,
                min_overlap, thresh, compute_fp,
                gt_alphas=None, dt_alphas=None):
    """Devkit per-image matching (reference compute_statistics_jit,
    eval.py:161). overlaps: (n_det, n_gt). When alphas are given, also
    accumulates TP orientation similarity (1+cos(gt_a - dt_a))/2 — the
    AOS numerator (eval.py:240-276; FPs contribute 0)."""
    n_gt = len(gt_ignored)
    n_det = len(det_ignored)
    ignored_threshold = np.zeros(n_det, bool)
    if compute_fp:
        ignored_threshold = scores < thresh
    assigned = np.zeros(n_det, bool)
    tp = fp = fn = 0
    sim = 0.0
    tp_scores = []
    for i in range(n_gt):
        if gt_ignored[i] == -1:
            continue
        det_idx = -1
        valid_det = -10e9
        max_overlap = 0.0
        assigned_ignored = False
        for j in range(n_det):
            if (det_ignored[j] == -1 or assigned[j]
                    or ignored_threshold[j]):
                continue
            ov = overlaps[j, i]
            if not compute_fp:
                if ov > min_overlap and scores[j] > valid_det:
                    det_idx = j
                    valid_det = scores[j]
            else:
                if (ov > min_overlap
                        and (ov > max_overlap or assigned_ignored)
                        and det_ignored[j] == 0):
                    max_overlap = ov
                    det_idx = j
                    valid_det = 1
                    assigned_ignored = False
                elif (ov > min_overlap and valid_det == -10e9
                        and det_ignored[j] == 1):
                    det_idx = j
                    valid_det = 1
                    assigned_ignored = True
        if valid_det == -10e9 and gt_ignored[i] == 0:
            fn += 1
        elif valid_det != -10e9 and (gt_ignored[i] == 1
                                     or det_ignored[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_det != -10e9:
            tp += 1
            tp_scores.append(scores[det_idx])
            if gt_alphas is not None and dt_alphas is not None:
                sim += (1.0 + np.cos(float(gt_alphas[i])
                                     - float(dt_alphas[det_idx]))) / 2.0
            assigned[det_idx] = True
    if compute_fp:
        for j in range(n_det):
            if not (assigned[j] or det_ignored[j] == -1
                    or det_ignored[j] == 1 or ignored_threshold[j]):
                fp += 1
        # DontCare absorption (bbox metric): unassigned dets overlapping a
        # dc region by IoF > min_overlap are not FPs
        nstuff = 0
        if dc_iof is not None and dc_iof.size:
            for j in range(n_det):
                if (assigned[j] or det_ignored[j] == -1
                        or ignored_threshold[j]):
                    continue
                if np.any(dc_iof[j] > min_overlap):
                    nstuff += 1
                    assigned[j] = True
        fp -= nstuff
    return tp, fp, fn, sim, tp_scores


def _iou2d_np(a, b, iof=False):
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
    area_b = ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :]
    denom = area_a if iof else area_a + area_b - inter
    return inter / np.maximum(denom, 1e-6)


def _overlap_fn(metric):
    """The (n_det, n_gt) overlap of one image's boxes, batched over
    images with ``torch.vmap``."""
    if metric == "bev":
        def one(d, g):
            return iou_mod.rotated_iou_bev(geometry.boxes_to_bev(d),
                                           geometry.boxes_to_bev(g))
    else:
        def one(d, g):
            return iou_mod.iou3d(d, g)
    return torch.vmap(one)


def _overlap_matrix(det, gt, metric, device="cuda"):
    """(n_det, n_gt) overlaps of one image for the chosen metric."""
    if metric == "bbox":
        return _iou2d_np(det["bbox"], gt["bbox"])
    return precompute_overlaps([gt], [det], metric, device=device)[0]


def precompute_overlaps(gt_annos, det_annos, metric, chunk=512,
                        device="cuda"):
    """All per-image (n_det, n_gt) overlap matrices: the boxes padded to
    one shape (multiples of 8, at least 8) and stacked, then one batched
    IoU call on ``device`` per ``chunk`` images, as the JAX package's
    jitted program runs them (the reference's fused partwise design,
    ``eval.py:341``).

    The overlap matrix depends only on the metric — NOT on class or
    difficulty — so :func:`kitti_eval` computes it once per metric and
    reuses it across all 9 (class, difficulty) sweeps.
    """
    n_img = len(gt_annos)
    if metric == "bbox":
        return [_iou2d_np(det["bbox"], gt["bbox"])
                for gt, det in zip(gt_annos, det_annos)]
    n_det = [len(d["boxes3d"]) for d in det_annos]
    n_gt = [len(g["boxes3d"]) for g in gt_annos]
    dmax = max(8, -(-max(n_det, default=1) // 8) * 8)
    gmax = max(8, -(-max(n_gt, default=1) // 8) * 8)

    def pad(boxes, n):
        out = np.zeros((n, 7), np.float32)
        out[: len(boxes)] = boxes
        return out

    dets = np.stack([pad(d["boxes3d"], dmax) for d in det_annos])
    gts = np.stack([pad(g["boxes3d"], gmax) for g in gt_annos])
    batched = _overlap_fn(metric)
    with torch.no_grad():
        ov = np.concatenate([
            batched(torch.from_numpy(dets[s:s + chunk]).to(device),
                    torch.from_numpy(gts[s:s + chunk]).to(device)).cpu()
            .numpy() for s in range(0, n_img, chunk)], axis=0)
    return [ov[i, : n_det[i], : n_gt[i]] for i in range(n_img)]


def eval_class(gt_annos, det_annos, cls, difficulty, metric,
               overlaps=None, min_overlap=None, compute_aos=False,
               device="cuda"):
    """AP_R40 for one (class, difficulty, metric). Annos are per-image:

    gt: dict(name, bbox (N,4), occluded, truncated, boxes3d (N,7) internal)
    det: dict(labels (M,), scores, bbox (M,4), boxes3d (M,7))
    overlaps: optional precomputed per-image matrices
        (:func:`precompute_overlaps`) — reuse across class/difficulty.
    min_overlap: TP IoU threshold; defaults to the official KITTI
        per-class value (``MIN_OVERLAP``). Explicit values drive the
        coco-style IoU sweep (:func:`kitti_eval_coco_style`).
    compute_aos: also compute average orientation similarity (bbox
        metric only; reference ``eval.py:250-275`` — per-threshold TP
        similarity / (tp+fp), right-max smoothed, R40-averaged).
        Requires ``alpha`` in both anno dicts. Returns ``(ap, aos)``.
    device: where the overlaps are computed when ``overlaps`` is None.
    """
    lib = native.get_lib()
    if min_overlap is None:
        min_overlap = MIN_OVERLAP[cls]

    if compute_aos:
        assert metric == "bbox", "AOS is defined on the bbox metric"

    n_img = len(gt_annos)
    per_img = []
    total_gt = 0
    all_tp_scores = []
    for i, (gt, det) in enumerate(zip(gt_annos, det_annos)):
        gt_ign, dc = clean_gt(gt, cls, difficulty)
        det_ign = clean_det(det, cls, difficulty)
        ov = (overlaps[i] if overlaps is not None
              else _overlap_matrix(det, gt, metric, device))
        dc_iof = _iou2d_np(det["bbox"], dc, iof=True) if metric == "bbox" \
            else (_iou2d_np(det["bbox"], dc, iof=True) if len(dc) else None)
        alphas = ((np.asarray(gt["alpha"], np.float32),
                   np.asarray(det["alpha"], np.float32))
                  if compute_aos else (None, None))
        per_img.append((ov, dc_iof, det["scores"], gt_ign, det_ign,
                        alphas))
        total_gt += int((gt_ign == 0).sum())
        if lib is not None:
            all_tp_scores.extend(native.gather_tp_scores(
                ov, det["scores"], gt_ign, det_ign, min_overlap))
        else:
            _, _, _, _, tps = _statistics(ov, None, det["scores"],
                                          gt_ign, det_ign, min_overlap,
                                          0.0, False)
            all_tp_scores.extend(tps)
    if total_gt == 0:
        return (0.0, 0.0) if compute_aos else 0.0
    thresholds = get_thresholds(np.array(all_tp_scores), total_gt)
    if len(thresholds) == 0:
        return (0.0, 0.0) if compute_aos else 0.0
    precision = np.zeros(N_SAMPLE_PTS, np.float64)
    tps = np.zeros(len(thresholds), np.int64)
    fps = np.zeros(len(thresholds), np.int64)
    fns = np.zeros(len(thresholds), np.int64)
    sims = np.zeros(len(thresholds), np.float64)
    thr32 = np.asarray(thresholds, np.float32)
    for (ov, dc_iof, scores, gt_ign, det_ign, alphas) in per_img:
        dc = dc_iof if metric == "bbox" else None
        if lib is not None and compute_aos:
            native.sweep_thresholds_aos(
                ov, dc, scores, gt_ign, det_ign, alphas[0], alphas[1],
                min_overlap, thr32, tps, fps, fns, sims)
            continue
        if lib is not None:
            native.sweep_thresholds(ov, dc, scores, gt_ign, det_ign,
                                    min_overlap, thr32, tps, fps, fns)
            continue
        for t, thr in enumerate(thresholds):
            tp, fp, fn, sim, _ = _statistics(
                ov, dc, scores, gt_ign, det_ign, min_overlap, thr, True,
                gt_alphas=alphas[0], dt_alphas=alphas[1])
            tps[t] += tp
            fps[t] += fp
            fns[t] += fn
            sims[t] += sim
    denom = np.maximum(tps + fps, 1.0)
    prec = tps / denom
    aos_curve = sims / denom
    # right-max smoothing
    for i in range(len(thresholds)):
        prec[i] = prec[i:].max()
        aos_curve[i] = aos_curve[i:].max()
    precision[:len(thresholds)] = prec
    # AP_R40: skip the first point, average 40
    ap = float(np.sum(precision[1:]) / 40.0 * 100.0)
    if not compute_aos:
        return ap
    aos_full = np.zeros(N_SAMPLE_PTS, np.float64)
    aos_full[:len(thresholds)] = aos_curve
    return ap, float(np.sum(aos_full[1:]) / 40.0 * 100.0)


def kitti_eval(gt_annos, det_annos, classes=CLASSES,
               metrics=("bbox", "bev", "3d"),
               difficulties=(0, 1, 2), compute_aos=False, device="cuda"):
    """Full sweep → {'<cls>_<metric>_<difficulty>': AP40} + mAPs
    (reference kitti_eval, eval.py:650-783; DetMatch headline =
    moderate difficulty). With ``compute_aos`` (and ``bbox`` among the
    metrics) additionally emits ``<cls>_aos_<difficulty>`` and
    ``mAP_aos_<difficulty>`` — requires ``alpha`` in both anno sets
    (reference do_eval eval.py:597-649). The rotated overlaps of the
    bev and 3d metrics are computed on ``device``."""
    out = {}
    diff_names = ("easy", "moderate", "hard")
    for metric in metrics:
        ov = precompute_overlaps(gt_annos, det_annos, metric, device=device)
        aos_here = compute_aos and metric == "bbox"
        for cls in classes:
            for d in difficulties:
                r = eval_class(gt_annos, det_annos, cls, d, metric,
                               overlaps=ov, compute_aos=aos_here)
                if aos_here:
                    r, aos = r
                    out[f"{cls}_aos_{diff_names[d]}"] = aos
                out[f"{cls}_{metric}_{diff_names[d]}"] = r
        for d in difficulties:
            vals = [out[f"{c}_{metric}_{diff_names[d]}"] for c in classes]
            out[f"mAP_{metric}_{diff_names[d]}"] = float(np.mean(vals))
        if aos_here:
            for d in difficulties:
                vals = [out[f"{c}_aos_{diff_names[d]}"] for c in classes]
                out[f"mAP_aos_{diff_names[d]}"] = float(np.mean(vals))
    return out


# coco-style IoU sweep ranges (start, stop, n): Car-like classes sweep
# 0.5:0.95, small classes 0.25:0.70 (reference kitti_eval_coco_style,
# eval.py:784-812 class_to_range).
COCO_RANGE = {"Car": (0.5, 0.95, 10),
              "Pedestrian": (0.25, 0.70, 10),
              "Cyclist": (0.25, 0.70, 10)}


def kitti_eval_coco_style(gt_annos, det_annos, classes=CLASSES,
                          metrics=("bbox", "bev", "3d"),
                          difficulties=(0, 1, 2), device="cuda"):
    """COCO-style KITTI AP: average AP over a per-class IoU-threshold
    linspace instead of the single official threshold (reference
    ``kitti_eval_coco_style`` + ``do_coco_style_eval``, eval.py:784).

    Returns {'<cls>_<metric>_<difficulty>': mean-over-IoU AP} plus
    'mAP_<metric>_<difficulty>' aggregates — same key scheme as
    :func:`kitti_eval` so both plug into the same reporting.
    """
    out = {}
    diff_names = ("easy", "moderate", "hard")
    for metric in metrics:
        ov = precompute_overlaps(gt_annos, det_annos, metric, device=device)
        for cls in classes:
            lo, hi, n = COCO_RANGE[cls]
            thr_sweep = np.linspace(lo, hi, n)
            for d in difficulties:
                aps = [eval_class(gt_annos, det_annos, cls, d, metric,
                                  overlaps=ov, min_overlap=float(t))
                       for t in thr_sweep]
                out[f"{cls}_{metric}_{diff_names[d]}"] = float(
                    np.mean(aps))
        for d in difficulties:
            vals = [out[f"{c}_{metric}_{diff_names[d]}"] for c in classes]
            out[f"mAP_{metric}_{diff_names[d]}"] = float(np.mean(vals))
    return out
