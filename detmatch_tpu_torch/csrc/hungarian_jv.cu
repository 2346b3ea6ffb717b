// Batched masked Jonker-Volgenant min-cost assignment, one block per
// problem.
//
// Replaces the TPU kernel detmatch_tpu/ops/pallas/hungarian.py:_jv_pallas
// (_jv_kernel), which keeps the (B, K, K) costs and all solver state in
// VMEM and advances the B problems in lockstep, one masked (B, K) vector
// op per inner step.
//
// What it computes, bit for bit: core/hungarian.py:_solve_masked of the
// JAX package (ops/cuda/hungarian.solve_masked_plain here). Valid rows are
// inserted one at a time by Dijkstra-style shortest augmenting paths over
// column potentials v and row potentials u, starting from a virtual column
// K whose matched row is the row being inserted. Per inner step:
//   cur[j]  = (cost[i0, j] - u[i0]) - v[j]
//   minv[j] = cur[j], way[j] = j0          where cur < minv and j unused
//   delta, j1 = first-occurrence argmin of (used ? INF : minv)
//   u[p[j]] += delta, v[j] -= delta        for used j (row i via column K)
//   minv[j] -= delta                       for unused j
// until column j1 is free; then the path is flipped back along way[].
//
// What bounds it on the H100: the inner steps are strictly sequential
// (about the sum of the augmenting-path lengths, a few hundred to a few
// thousand per problem at K = 128) and each one reads one cost row
// (K floats, L2-resident) and ends in a block-wide argmin. Latency per
// step, not bytes or FLOPs, is the limit; the problems of a batch run in
// parallel, one per SM.
//
// Design: one thread per column (K rounded up to a warp, at most 1,024);
// v, minv, way and used live in that thread's registers, u (by row) and
// p (by column) in shared memory. The argmin is a warp shuffle over
// (value, column) with ties to the lower column, then every warp reduces
// the per-warp winners itself (no second barrier). Each used column's
// thread updates the potential of its own matched row, and thread 0 that
// of the inserted row, so no two threads write one address: no atomics.
// All arithmetic is single IEEE-754 fp32 adds and subtracts with
// round-to-nearest intrinsics (no contraction, no fast math), in the JAX
// order. Threads past column K hold +inf so they never win. The inner
// loop is capped at K + 1 steps, a bound a finite cost matrix never
// reaches, so a non-finite input cannot hang the card.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxK = 1024;
constexpr float kInf = 1e18f;  // core/hungarian.py INF as fp32

__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmin(float& d, int& j) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oj = __shfl_xor_sync(0xffffffffu, j, off);
    if (before(od, oj, d, j)) {
      d = od;
      j = oj;
    }
  }
}

__global__ void __launch_bounds__(kMaxK)
    jv_kernel(const float* __restrict__ cost,
              const uint8_t* __restrict__ row_valid,
              int32_t* __restrict__ out, int k) {
  extern __shared__ int smem[];
  float* u = reinterpret_cast<float*>(smem);  // [k] row potentials
  int* p = smem + k;                          // [k] row matched to column
  int* way_s = smem + 2 * k;                  // [k] way[] for backtracking
  __shared__ float red_d[32];
  __shared__ int red_j[32];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool col = t < k;
  const float* c = cost + static_cast<size_t>(blockIdx.x) * k * k;
  const uint8_t* rv = row_valid + static_cast<size_t>(blockIdx.x) * k;

  if (col) {
    u[t] = 0.f;
    p[t] = -1;
  }
  float v = 0.f;
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    if (!rv[i]) continue;  // uniform across the block
    float minv = kInf;
    int way = k;
    bool used = false;
    int j0 = k;  // the virtual column, matched to row i
    int i0 = i;
    for (int step = 0; step <= k; ++step) {
      if (t == j0) used = true;
      const float ui0 = u[i0];
      float masked = INFINITY;  // threads past column k never win
      if (col) {
        const float cur = __fsub_rn(__fsub_rn(c[i0 * k + t], ui0), v);
        if (!used && cur < minv) {
          minv = cur;
          way = j0;
        }
        masked = used ? kInf : minv;
      }
      float d = masked;
      int j = col ? t : INT_MAX;
      warp_argmin(d, j);
      if (lane == 0) {
        red_d[warp] = d;
        red_j[warp] = j;
      }
      __syncthreads();
      d = lane < nwarps ? red_d[lane] : INFINITY;
      j = lane < nwarps ? red_j[lane] : INT_MAX;
      warp_argmin(d, j);
      const float delta = d;
      const int j1 = j;
      if (col) {
        if (used) {
          u[p[t]] = __fadd_rn(u[p[t]], delta);
          v = __fsub_rn(v, delta);
        } else {
          minv = __fsub_rn(minv, delta);
        }
      }
      if (t == 0) u[i] = __fadd_rn(u[i], delta);  // the virtual column's row
      const int pj1 = p[j1];
      __syncthreads();  // u settled and red_* read before the next step
      j0 = j1;
      if (pj1 == -1) break;
      i0 = pj1;
    }
    if (col) way_s[t] = way;
    __syncthreads();
    if (t == 0) {  // flip the path: p[j0] = p[way[j0]] back to column k
      while (j0 != k) {
        const int w = way_s[j0];
        p[j0] = w == k ? i : p[w];
        j0 = w;
      }
    }
    __syncthreads();
  }
  if (col) out[static_cast<size_t>(blockIdx.x) * k + t] = p[t];
}

}  // namespace

// cost (b, k, k) f32, row_valid (b, k) bool as bytes → out (b, k) int32:
// the row matched to each column, -1 if none.
DM_EXPORT int dm_hungarian_jv(const float* cost, const uint8_t* row_valid,
                              int32_t* out, int b, int k,
                              cudaStream_t stream) {
  if (b < 0 || k <= 0 || k > kMaxK) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const int threads = (k + 31) / 32 * 32;
  const int smem = 3 * k * static_cast<int>(sizeof(int));
  jv_kernel<<<b, threads, smem, stream>>>(cost, row_valid, out, k);
  return cudaGetLastError();
}
