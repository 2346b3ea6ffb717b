// Ball query over a y-sorted point table: G lanes per center, a ballot
// scan.
//
// Replaces the TPU kernel detmatch_tpu/ops/pallas/ball_query.py:
// _ball_query_pallas (_bqw_kernel), which sorts centers by y, bounds each
// 256-center tile to a y-band of the sorted table and DMAs just those
// chunks, turning first-k selection into cumsum-rank matmuls on the MXU.
//
// What bounds it on the H100: latency, not bytes or arithmetic. The table
// is at most 384 KB a sample and stays in L2; the distance tests a call
// needs are a few million. One thread per center scanning its own
// y-window serially ran as long as the warp's longest window, on dependent
// loads, with too few warps on the VSA calls (B x 2,048 centers) to hide
// them. Staging a block's y-band in shared memory, the TPU kernel's
// scheme, was tried on the RoI grid, whose neighbouring centers share
// their windows, and lost on every call: L2 traffic does not set the
// time there either.
//
// Design: a group of G lanes (a power of two up to 32; the wrapper's
// plan) serves one center. A G-ary search with one ballot a level finds
// the first table position whose y reaches the window; the group then
// reads G consecutive positions a step, one 16-byte record (x, y, z,
// perm) each.
// Hits come out of a ballot, each hit's slot is the hits found so far
// plus the hits on lower lanes (the popc of the ballot below the lane:
// the TPU kernel's cumsum rank), and the lanes whose slot is below
// nsample store their point. The scan stops once nsample hits are in, or
// when a lane's position leaves the window or the table. The window is
// widened by 0.1% of r (plus a few ulps of y), in double: a point outside
// it has |dy| > r * 1.0005 and cannot pass d2 <= r2, while every point
// inside is tested with the exact predicate in table order, so the hits
// are the same as a full scan's. Invalid rows sit last with y = +inf in
// the packed table, so the window test masks them, and positions past n
// are masked explicitly. Unused slots repeat the first hit; an empty ball
// (or an invalid center) yields table position 0. Positions map through
// the records' perm to the caller's point indices.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The warp's groups run in lockstep: every ballot is taken by all 32
// lanes (a group that is done adds no bits), and a loop runs until every
// group of the warp is done. Groups that synchronised apart, each on its
// own mask, ran one after another.
template <int G>
__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ centers,
                      const uint8_t* __restrict__ centers_valid,
                      const float4* __restrict__ table,
                      int32_t* __restrict__ idx, int32_t* __restrict__ cnt,
                      int b, int m, int n, float radius, float r2,
                      int nsample) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);      // lane within the group
  const int g0 = lane & ~(G - 1);     // the group's first lane
  const unsigned low = G == 32 ? kFull : (1u << G) - 1u;
  const int64_t total = static_cast<int64_t>(b) * m;
  const int64_t c = (static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x) / G;
  const bool live = c < total;  // whole groups; the warp stays whole
  const int64_t cc = live ? c : total - 1;
  const float4* tab = table + static_cast<size_t>(cc / m) * n;
  const float* ys = reinterpret_cast<const float*>(tab) + 1;
  int32_t* out = idx + cc * nsample;

  const bool valid = live && centers_valid[cc];
  float cx = 0.f, cy = 0.f, cz = 0.f;
  double lo = 0.0, hi = 0.0;
  if (valid) {
    cx = centers[3 * cc];
    cy = centers[3 * cc + 1];
    cz = centers[3 * cc + 2];
    const double slack = 1e-3 * radius + 1e-6 * (fabs(static_cast<double>(cy)) + 1.0);
    lo = static_cast<double>(cy) - radius - slack;
    hi = static_cast<double>(cy) + radius + slack;
  }
  // first position with y >= lo: each level probes G positions that cut
  // [a, z) into G + 1 parts; y is sorted, so the group's ballot bits are
  // a run at the top and the lowest one bounds the answer
  int a = 0;
  int z = valid ? n : 0;
  while (__any_sync(kFull, a < z)) {
    const bool searching = a < z;
    const int64_t len = z - a;
    const int q = a + static_cast<int>((gl + 1) * len / (G + 1));
    const bool ge =
        searching && static_cast<double>(__ldg(ys + 4 * q)) >= lo;
    const unsigned pass = (__ballot_sync(kFull, ge) >> g0) & low;
    if (searching) {
      if (pass == 0) {
        a += static_cast<int>(G * len / (G + 1)) + 1;
      } else {
        const int j = __ffs(pass) - 1;
        z = a + static_cast<int>((j + 1) * len / (G + 1));
        if (j > 0) a += static_cast<int>(j * len / (G + 1)) + 1;
      }
    }
  }
  const unsigned below = (1u << gl) - 1u;
  int found = 0;
  bool done = !valid;
  for (int i = a + gl; __any_sync(kFull, !done); i += G) {
    float4 p = make_float4(0.f, INFINITY, 0.f, 0.f);
    if (!done && i < n) p = __ldg(tab + i);
    const bool inside = !done && i < n && static_cast<double>(p.y) <= hi;
    const bool hit = inside && dm::sq_dist(cx, cy, cz, p.x, p.y, p.z) <= r2;
    const unsigned hits = (__ballot_sync(kFull, hit) >> g0) & low;
    const unsigned out_of_window =
        (__ballot_sync(kFull, !done && !inside) >> g0) & low;
    if (hit) {
      const int slot = found + __popc(hits & below);
      if (slot < nsample) out[slot] = __float_as_int(p.w);
    }
    if (!done) {
      found += __popc(hits);
      done = found >= nsample || out_of_window != 0;
    }
  }
  __syncwarp();  // slot 0, the first hit, is visible to the whole group
  if (!live) return;
  // unused slots repeat the first hit, or table position 0's point
  const int first = found ? out[0] : __float_as_int(__ldg(tab).w);
  found = min(found, nsample);
  for (int s = found + gl; s < nsample; s += G) out[s] = first;
  if (gl == 0) cnt[cc] = found;
}

template <int G>
cudaError_t launch(const float* centers, const uint8_t* centers_valid,
                   const float4* table, int32_t* idx, int32_t* cnt, int b,
                   int m, int n, float radius, float r2, int nsample,
                   cudaStream_t stream) {
  const int64_t lanes = static_cast<int64_t>(b) * m * G;
  const int64_t blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  ball_query_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(centers, centers_valid, table, idx, cnt,
                                   b, m, n, radius, r2, nsample);
  return cudaGetLastError();
}

}  // namespace

// centers (b, m, 3) f32 + valid bytes; table (b, n, 4) f32 records
// (x, y, z, perm as int32 bits), y-sorted with invalid rows last and y =
// +inf there; group = lanes per center → idx (b, m, nsample) int32
// original point indices, cnt (b, m) int32.
DM_EXPORT int dm_ball_query(const float* centers, const uint8_t* centers_valid,
                            const float* table, int32_t* idx, int32_t* cnt,
                            int b, int m, int n, float radius, float r2,
                            int nsample, int group, cudaStream_t stream) {
  if (b < 0 || m < 0 || n <= 0 || nsample <= 0 || !(radius > 0.f)) {
    return cudaErrorInvalidValue;
  }
  if (static_cast<int64_t>(b) * m == 0) return cudaSuccess;
  const float4* tab = reinterpret_cast<const float4*>(table);
  switch (group) {
    case 1:
      return launch<1>(centers, centers_valid, tab, idx, cnt, b, m, n,
                       radius, r2, nsample, stream);
    case 2:
      return launch<2>(centers, centers_valid, tab, idx, cnt, b, m, n,
                       radius, r2, nsample, stream);
    case 4:
      return launch<4>(centers, centers_valid, tab, idx, cnt, b, m, n,
                       radius, r2, nsample, stream);
    case 8:
      return launch<8>(centers, centers_valid, tab, idx, cnt, b, m, n,
                       radius, r2, nsample, stream);
    case 16:
      return launch<16>(centers, centers_valid, tab, idx, cnt, b, m, n,
                        radius, r2, nsample, stream);
    case 32:
      return launch<32>(centers, centers_valid, tab, idx, cnt, b, m, n,
                        radius, r2, nsample, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
