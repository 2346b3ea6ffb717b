/* KITTI eval inner loop — native C replacement for the reference's numba
 * kernels (mmdet3d/core/evaluation/kitti_utils/eval.py:161
 * compute_statistics_jit / :291 fused_compute_statistics).
 *
 * The devkit matching is inherently sequential per image (greedy gt→det
 * assignment with mutable det state), so it stays on the host; this C
 * version removes the Python interpreter from the per-image × per-threshold
 * sweep. Called through ctypes with raw numpy buffers.
 *
 * Build: cc -O3 -shared -fPIC -o libkitti_eval.so kitti_eval.c
 */
#include <stdint.h>
#include <string.h>

#define NO_DETECTION -1e10f

/* One (image, threshold) statistics pass.
 * overlaps: (n_det, n_gt) row-major; dc_iof: (n_det, n_dc) or NULL.
 * Returns via tp/fp/fn pointers; when tp_scores != NULL (threshold-0
 * score-gathering pass), appends matched det scores and returns count. */
static int statistics_one(
    const float *overlaps, int n_det, int n_gt,
    const float *dc_iof, int n_dc,
    const float *scores,
    const int32_t *gt_ignored, const int32_t *det_ignored,
    float min_overlap, float thresh, int compute_fp,
    int32_t *tp, int32_t *fp, int32_t *fn,
    float *tp_scores,
    /* AOS (reference eval.py:240-276): when gt_alphas/dt_alphas are
     * non-NULL, *similarity accumulates (1+cos(gt_a - dt_a))/2 over TPs
     * (FPs contribute 0; the reference's -1 "no dets" sentinel is
     * filtered by the caller anyway, fused_compute_statistics:334). */
    const float *gt_alphas, const float *dt_alphas, double *similarity)
{
    unsigned char assigned[4096];
    unsigned char ignored_thresh[4096];
    int n_scores = 0;
    if (n_det > 4096) n_det = 4096;
    memset(assigned, 0, (size_t)n_det);
    for (int j = 0; j < n_det; ++j)
        ignored_thresh[j] = compute_fp && (scores[j] < thresh);

    int tp_ = 0, fp_ = 0, fn_ = 0;
    for (int i = 0; i < n_gt; ++i) {
        if (gt_ignored[i] == -1) continue;
        int det_idx = -1;
        float valid_det = NO_DETECTION;
        float max_overlap = 0.f;
        int assigned_ignored = 0;
        for (int j = 0; j < n_det; ++j) {
            if (det_ignored[j] == -1 || assigned[j] || ignored_thresh[j])
                continue;
            float ov = overlaps[(size_t)j * n_gt + i];
            if (!compute_fp) {
                if (ov > min_overlap && scores[j] > valid_det) {
                    det_idx = j;
                    valid_det = scores[j];
                }
            } else {
                if (ov > min_overlap
                    && (ov > max_overlap || assigned_ignored)
                    && det_ignored[j] == 0) {
                    max_overlap = ov;
                    det_idx = j;
                    valid_det = 1.f;
                    assigned_ignored = 0;
                } else if (ov > min_overlap && valid_det == NO_DETECTION
                           && det_ignored[j] == 1) {
                    det_idx = j;
                    valid_det = 1.f;
                    assigned_ignored = 1;
                }
            }
        }
        if (valid_det == NO_DETECTION && gt_ignored[i] == 0) {
            fn_++;
        } else if (valid_det != NO_DETECTION
                   && (gt_ignored[i] == 1 || det_ignored[det_idx] == 1)) {
            assigned[det_idx] = 1;
        } else if (valid_det != NO_DETECTION) {
            tp_++;
            if (tp_scores) tp_scores[n_scores++] = scores[det_idx];
            if (similarity && gt_alphas && dt_alphas)
                *similarity += (1.0 + __builtin_cos(
                    (double)gt_alphas[i] - (double)dt_alphas[det_idx]
                )) / 2.0;
            assigned[det_idx] = 1;
        }
    }
    if (compute_fp) {
        for (int j = 0; j < n_det; ++j)
            if (!(assigned[j] || det_ignored[j] == -1
                  || det_ignored[j] == 1 || ignored_thresh[j]))
                fp_++;
        if (dc_iof && n_dc > 0) {
            int nstuff = 0;
            for (int j = 0; j < n_det; ++j) {
                if (assigned[j] || det_ignored[j] == -1
                    || ignored_thresh[j])
                    continue;
                for (int d = 0; d < n_dc; ++d) {
                    if (dc_iof[(size_t)j * n_dc + d] > min_overlap) {
                        nstuff++;
                        assigned[j] = 1;
                        break;
                    }
                }
            }
            fp_ -= nstuff;
        }
    }
    *tp = tp_; *fp = fp_; *fn = fn_;
    return n_scores;
}

/* Gather matched-det scores at threshold 0 (for get_thresholds). */
int gather_tp_scores(
    const float *overlaps, int n_det, int n_gt,
    const float *scores, const int32_t *gt_ignored,
    const int32_t *det_ignored, float min_overlap, float *tp_scores)
{
    int32_t tp, fp, fn;
    return statistics_one(overlaps, n_det, n_gt, NULL, 0, scores,
                          gt_ignored, det_ignored, min_overlap, 0.f, 0,
                          &tp, &fp, &fn, tp_scores, NULL, NULL, NULL);
}

/* Threshold sweep for one image: accumulates into tps/fps/fns (n_thr,). */
void sweep_thresholds(
    const float *overlaps, int n_det, int n_gt,
    const float *dc_iof, int n_dc,
    const float *scores, const int32_t *gt_ignored,
    const int32_t *det_ignored, float min_overlap,
    const float *thresholds, int n_thr,
    int64_t *tps, int64_t *fps, int64_t *fns)
{
    for (int t = 0; t < n_thr; ++t) {
        int32_t tp, fp, fn;
        statistics_one(overlaps, n_det, n_gt, dc_iof, n_dc, scores,
                       gt_ignored, det_ignored, min_overlap,
                       thresholds[t], 1, &tp, &fp, &fn, NULL,
                       NULL, NULL, NULL);
        tps[t] += tp; fps[t] += fp; fns[t] += fn;
    }
}

/* Threshold sweep with orientation similarity (AOS, bbox metric):
 * additionally accumulates per-threshold TP orientation similarity
 * into sims (n_thr doubles). */
void sweep_thresholds_aos(
    const float *overlaps, int n_det, int n_gt,
    const float *dc_iof, int n_dc,
    const float *scores, const int32_t *gt_ignored,
    const int32_t *det_ignored,
    const float *gt_alphas, const float *dt_alphas,
    float min_overlap,
    const float *thresholds, int n_thr,
    int64_t *tps, int64_t *fps, int64_t *fns, double *sims)
{
    for (int t = 0; t < n_thr; ++t) {
        int32_t tp, fp, fn;
        double sim = 0.0;
        statistics_one(overlaps, n_det, n_gt, dc_iof, n_dc, scores,
                       gt_ignored, det_ignored, min_overlap,
                       thresholds[t], 1, &tp, &fp, &fn, NULL,
                       gt_alphas, dt_alphas, &sim);
        tps[t] += tp; fps[t] += fp; fns[t] += fn; sims[t] += sim;
    }
}
