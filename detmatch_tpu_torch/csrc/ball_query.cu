// Ball query over a y-sorted point table, one thread per center.
//
// Replaces the TPU kernel detmatch_tpu/ops/pallas/ball_query.py:
// _ball_query_pallas (_bqw_kernel), which sorts centers by y, bounds each
// 256-center tile to a y-band of the sorted table and DMAs just those
// chunks, turning first-k selection into cumsum-rank matmuls on the MXU.
//
// What bounds it on the H100: the distance tests. At the VSA shapes
// (2,048 centers over 16,384 points, radii 0.4-4.8 m) and the RoI-grid
// shapes (21,600 centers over 2,048 keypoints) a full scan would be
// 34M-44M tests per sample; the table itself is at most 200 KB per
// sample and stays in L2.
//
// Design: a neighbour lies within r of its center in y, so each thread
// binary-searches the start of the y-window in the sorted table and scans
// forward only until y leaves the window or nsample hits are found. The
// window is widened by 0.1% of r (plus a few ulps of y): a point outside
// it has |dy| > r * 1.0005 and cannot pass d2 <= r2, while every point
// inside is tested with the exact predicate, so the hits, in table order,
// are the same as a full scan's. Unused slots repeat the first hit; an
// empty ball (or an invalid center) yields table position 0. Positions
// map through `perm` to the caller's point indices.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float y_key(const float* pts, const uint8_t* valid,
                                       int i) {
  return valid[i] ? pts[3 * i + 1] : INFINITY;
}

__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ centers,
                      const uint8_t* __restrict__ centers_valid,
                      const float* __restrict__ points,
                      const uint8_t* __restrict__ points_valid,
                      const int32_t* __restrict__ perm,
                      int32_t* __restrict__ idx, int32_t* __restrict__ cnt,
                      int b, int m, int n, float radius, float r2,
                      int nsample) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= static_cast<int64_t>(b) * m) return;
  const int bi = static_cast<int>(g / m);
  const float* pts = points + static_cast<size_t>(bi) * n * 3;
  const uint8_t* pv = points_valid + static_cast<size_t>(bi) * n;
  const int32_t* pm = perm + static_cast<size_t>(bi) * n;
  int32_t* out = idx + g * nsample;

  int found = 0;
  int first = 0;
  if (centers_valid[g]) {
    const float cx = centers[3 * g];
    const float cy = centers[3 * g + 1];
    const float cz = centers[3 * g + 2];
    const double slack = 1e-3 * radius + 1e-6 * (fabs(static_cast<double>(cy)) + 1.0);
    const double lo = static_cast<double>(cy) - radius - slack;
    const double hi = static_cast<double>(cy) + radius + slack;
    int a = 0;
    int z = n;
    while (a < z) {  // first position with y >= lo
      const int mid = (a + z) >> 1;
      if (static_cast<double>(y_key(pts, pv, mid)) < lo) {
        a = mid + 1;
      } else {
        z = mid;
      }
    }
    for (int i = a; i < n && found < nsample; ++i) {
      if (static_cast<double>(y_key(pts, pv, i)) > hi) break;
      if (dm::sq_dist(cx, cy, cz, pts[3 * i], pts[3 * i + 1],
                      pts[3 * i + 2]) <= r2) {
        if (found == 0) first = i;
        out[found++] = pm[i];
      }
    }
  }
  const int32_t fill = pm[first];
  for (int s = found; s < nsample; ++s) out[s] = fill;
  cnt[g] = found;
}

}  // namespace

// centers (b, m, 3) f32 + valid bytes; points (b, n, 3) f32 y-sorted with
// invalid rows last + valid bytes; perm (b, n) int32 → idx (b, m, nsample)
// int32 original point indices, cnt (b, m) int32.
DM_EXPORT int dm_ball_query(const float* centers, const uint8_t* centers_valid,
                            const float* points, const uint8_t* points_valid,
                            const int32_t* perm, int32_t* idx, int32_t* cnt,
                            int b, int m, int n, float radius, float r2,
                            int nsample, cudaStream_t stream) {
  if (b < 0 || m < 0 || n <= 0 || nsample <= 0 || !(radius > 0.f)) {
    return cudaErrorInvalidValue;
  }
  const int64_t total = static_cast<int64_t>(b) * m;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  ball_query_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      centers, centers_valid, points, points_valid, perm, idx, cnt, b, m, n,
      radius, r2, nsample);
  return cudaGetLastError();
}
