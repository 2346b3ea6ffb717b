// Batched masked Jonker-Volgenant min-cost assignment (K4): one warp per
// problem for K <= 128, one block per problem above.
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
// All arithmetic is single IEEE-754 fp32 adds and subtracts with
// round-to-nearest intrinsics (no contraction, no fast math), in the JAX
// order. The inner loop is capped at K + 1 steps, a bound a finite cost
// matrix never reaches, so a non-finite input cannot hang the card.
//
// What bounds it on the H100: the inner steps are strictly sequential
// (about the sum of the augmenting-path lengths: 391-936 per problem in
// the teacher phase at K = 128) and each one ends in an argmin over the
// K columns; the bytes (64 KB of costs a problem) are nothing. The
// latency of one step's dependent chain is the limit.
//
// Warp design (K <= 128, jv_warp_kernel<cols>), which shortens that chain:
// - One warp per problem, no block barrier. Lane l owns the `cols`
//   (= ceil(K / 32), 1-4) contiguous columns l * cols .. + cols - 1 and
//   keeps v, minv, way, used, and p and u of each column's matched row in
//   registers ("u travels with the column": a row's potential is changed
//   only while its column is in the tree, by the column's lane).
// - The valid rows' costs are staged once into shared memory (cp.async;
//   a row stride of 32 * cols floats, so a lane reads its columns with one
//   LDS.128 at K = 128). Only valid rows are ever read (i0 is the inserted
//   row or a matched one), so only they are copied; a problem with no
//   valid row copies nothing and writes its -1s.
// - The argmin is one redux.sync and one ballot: the minimum of an
//   order-preserving uint32 key of each lane's best value (-0.0
//   canonicalised to +0.0, since IEEE compares them equal and the first
//   column must win), then the lowest lane holding that key, whose first
//   such column is the first overall (lanes own ascending columns).
//   Used columns hold kInf = 1e18 and columns past K +inf, which sort
//   after every finite value in that order; within a lane a strict <
//   keeps the first. The per-column work is selects, not branches.
// - j1, its row and the row's potential come from that lane by three
//   shuffles. The step loop reads shared memory (the costs, written
//   once before it) and writes none, so it needs no __syncwarp; the
//   inserted row's potential is a warp-uniform register.
// - The flip: the lanes publish u and way of their columns, one
//   __syncwarp, lane 0 walks the path in shared memory (p[j0] = p[way[j0]],
//   the potential with it), one __syncwarp, the lanes reload p and u.
// Block design (K up to 1,024, jv_block_kernel): one thread per column,
// v, minv, way and used in its registers, u (by row) and p in shared
// memory, a two-level shuffle argmin with two block barriers a step.
// One warp on an SM's shared memory would serve more problems a block,
// but the main path solves 4 problems a call, so each gets its own block.
// On an H100 (tools/port_probes/k4k5_plans.py) a step of the warp design
// takes 0.17-0.24 us at K = 128, the block design's 0.51-0.65 us; a first
// warp version with branches per column and a second redux.sync for the
// column took 0.28 us.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxK = 1024;
constexpr int kWarpMaxCols = 4;  // columns a lane; 32 * 4 = K of 128
constexpr float kInf = 1e18f;  // core/hungarian.py INF as fp32
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared bytes of the warp design (mirrored by
// ops/cuda/hungarian.jv_plan): k cost rows of 32 * cols floats, then u,
// p and way by column.
int warp_smem_bytes(int k, int cols) { return 4 * (k * 32 * cols + 3 * k); }

// float order as unsigned order; -0.0 ties +0.0
__device__ __forceinline__ unsigned order_key(float x) {
  unsigned b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

template <int kCols>
__device__ __forceinline__ void load_cols(const float* src,
                                          float (&dst)[kCols]) {
  if constexpr (kCols == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
    dst[2] = t.z;
    dst[3] = t.w;
  } else if constexpr (kCols == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < kCols; ++q) dst[q] = src[q];
  }
}

// x[q] for the q = sel of every lane, by selects (no local memory)
template <int kCols, typename T>
__device__ __forceinline__ T pick(const T (&x)[kCols], int sel) {
  T r = x[0];
#pragma unroll
  for (int q = 1; q < kCols; ++q) r = sel == q ? x[q] : r;
  return r;
}

template <int kCols>
__global__ void __launch_bounds__(32)
    jv_warp_kernel(const float* __restrict__ cost,
                   const uint8_t* __restrict__ row_valid,
                   int32_t* __restrict__ out, int k) {
  constexpr int kStride = 32 * kCols;
  extern __shared__ __align__(16) float smem[];
  float* s_cost = smem;                          // [k][kStride]
  float* s_u = s_cost + k * kStride;             // [k] u of p[j]
  int* s_p = reinterpret_cast<int*>(s_u + k);    // [k] row matched to j
  int* s_way = s_p + k;                          // [k]

  const int lane = threadIdx.x;
  const float* c = cost + static_cast<size_t>(blockIdx.x) * k * k;
  const uint8_t* rv = row_valid + static_cast<size_t>(blockIdx.x) * k;
  int32_t* o = out + static_cast<size_t>(blockIdx.x) * k;

  // 1. the valid rows, a bit each, in every lane
  unsigned valid[kCols];
  bool any = false;
#pragma unroll
  for (int w = 0; w < kCols; ++w) {
    const int r = w * 32 + lane;
    valid[w] = __ballot_sync(kFull, r < k && rv[r] != 0);
    any |= valid[w] != 0u;
  }
  if (!any) {
    for (int j = lane; j < k; j += 32) o[j] = -1;
    return;
  }

  // 2. stage the valid rows' costs
  const bool vec = k % 4 == 0 && (reinterpret_cast<uintptr_t>(c) & 15) == 0;
#pragma unroll
  for (int w = 0; w < kCols; ++w) {
    for (unsigned bits = valid[w]; bits != 0u; bits &= bits - 1u) {
      const int i = w * 32 + __ffs(static_cast<int>(bits)) - 1;
      float* dst = s_cost + i * kStride;
      const float* src = c + static_cast<size_t>(i) * k;
      if (vec) {
        for (int q = lane; q < k / 4; q += 32) {
          dm::cp_async16(dst + 4 * q, src + 4 * q);
        }
      } else {
        for (int q = lane; q < k; q += 32) dm::cp_async4(dst + q, src + q);
      }
    }
  }
  dm::cp_async_commit();

  float v[kCols], uc[kCols];
  int pc[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    v[q] = 0.f;
    uc[q] = 0.f;
    pc[q] = -1;
  }
  const int col0 = lane * kCols;
  dm::cp_async_wait<0>();
  __syncwarp();

  // 3. insert the valid rows in ascending order
#pragma unroll 1
  for (int w = 0; w < kCols; ++w) {
#pragma unroll 1
    for (unsigned bits = pick<kCols>(valid, w); bits != 0u;
         bits &= bits - 1u) {
      const int i = w * 32 + __ffs(static_cast<int>(bits)) - 1;
      float minv[kCols];
      int way[kCols];
      bool used[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        minv[q] = kInf;
        way[q] = k;
        used[q] = false;
      }
      float ui = 0.f;  // u[i]: a row is touched first when inserted
      int j0 = k;      // the virtual column, matched to row i
      int i0 = i;
      float ui0 = 0.f;
#pragma unroll 1
      for (int step = 0; step <= k; ++step) {
        float cv[kCols];
        load_cols<kCols>(s_cost + i0 * kStride + col0, cv);
        float best = INFINITY;  // columns past k never win
        int bq = 0;             // the lane's first column holding best
#pragma unroll
        for (int q = 0; q < kCols; ++q) {  // selects, no branch
          used[q] |= col0 + q == j0;
          const float cur = __fsub_rn(__fsub_rn(cv[q], ui0), v[q]);
          const bool take = !used[q] && cur < minv[q];
          minv[q] = take ? cur : minv[q];
          way[q] = take ? j0 : way[q];
          const float masked =
              col0 + q < k ? (used[q] ? kInf : minv[q]) : INFINITY;
          const bool better = masked < best;
          best = better ? masked : best;
          bq = better ? q : bq;
        }
        // the least key; among its lanes the lowest holds the first column
        const unsigned key = order_key(best);
        const unsigned kmin = __reduce_min_sync(kFull, key);
        const int src =
            __ffs(static_cast<int>(__ballot_sync(kFull, key == kmin))) - 1;
        const int j1 = min(__shfl_sync(kFull, col0 + bq, src), k - 1);
        const int pj1 = __shfl_sync(kFull, pick<kCols>(pc, bq), src);
        const float delta = key_value(kmin);
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const float uu = __fadd_rn(uc[q], delta);
          const float vv = __fsub_rn(v[q], delta);
          const float mm = __fsub_rn(minv[q], delta);
          uc[q] = used[q] ? uu : uc[q];
          v[q] = used[q] ? vv : v[q];
          minv[q] = used[q] ? minv[q] : mm;
        }
        ui = __fadd_rn(ui, delta);  // the virtual column's row
        // column j1 is unused, so its row's potential did not move
        ui0 = __shfl_sync(kFull, pick<kCols>(uc, bq), src);
        j0 = j1;
        if (pj1 == -1) break;
        i0 = pj1;
      }
      // flip the path: p[j0] = p[way[j0]] back to the virtual column,
      // each row's potential with it
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int j = col0 + q;
        if (j < k) {
          s_u[j] = uc[q];
          s_p[j] = pc[q];
          s_way[j] = way[q];
        }
      }
      __syncwarp();
      if (lane == 0) {
        for (int n = 0; j0 != k && n <= k; ++n) {
          const int wj = s_way[j0];
          s_p[j0] = wj == k ? i : s_p[wj];
          s_u[j0] = wj == k ? ui : s_u[wj];
          j0 = wj;
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int j = col0 + q;
        if (j < k) {
          pc[q] = s_p[j];
          uc[q] = s_u[j];
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    if (col0 + q < k) o[col0 + q] = pc[q];
  }
}

__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmin(float& d, int& j) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, d, off);
    const int oj = __shfl_xor_sync(kFull, j, off);
    if (before(od, oj, d, j)) {
      d = od;
      j = oj;
    }
  }
}

__global__ void __launch_bounds__(kMaxK)
    jv_block_kernel(const float* __restrict__ cost,
                    const uint8_t* __restrict__ row_valid,
                    int32_t* __restrict__ out, int k) {
  extern __shared__ int smem_i[];
  float* u = reinterpret_cast<float*>(smem_i);  // [k] row potentials
  int* p = smem_i + k;                          // [k] row matched to column
  int* way_s = smem_i + 2 * k;                  // [k] way[] for backtracking
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

template <int kCols>
cudaError_t launch_warp(const float* cost, const uint8_t* row_valid,
                        int32_t* out, int b, int k, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        jv_warp_kernel<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        warp_smem_bytes(32 * kCols, kCols));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  jv_warp_kernel<kCols><<<b, 32, warp_smem_bytes(k, kCols), stream>>>(
      cost, row_valid, out, k);
  return cudaGetLastError();
}

}  // namespace

// cost (b, k, k) f32, row_valid (b, k) bool as bytes → out (b, k) int32:
// the row matched to each column, -1 if none. cols: columns a lane of the
// warp design (1-4, with 32 * cols >= k), or 0 for the block design
// (ops/cuda/hungarian.jv_plan picks it).
DM_EXPORT int dm_hungarian_jv(const float* cost, const uint8_t* row_valid,
                              int32_t* out, int b, int k, int cols,
                              cudaStream_t stream) {
  if (b < 0 || k <= 0 || k > kMaxK || cols < 0 || cols > kWarpMaxCols ||
      (cols > 0 && 32 * cols < k)) {
    return cudaErrorInvalidValue;
  }
  if (b == 0) return cudaSuccess;
  switch (cols) {
    case 1:
      return launch_warp<1>(cost, row_valid, out, b, k, stream);
    case 2:
      return launch_warp<2>(cost, row_valid, out, b, k, stream);
    case 3:
      return launch_warp<3>(cost, row_valid, out, b, k, stream);
    case 4:
      return launch_warp<4>(cost, row_valid, out, b, k, stream);
    default:
      break;
  }
  const int threads = (k + 31) / 32 * 32;
  const int smem = 3 * k * static_cast<int>(sizeof(int));
  jv_block_kernel<<<b, threads, smem, stream>>>(cost, row_valid, out, k);
  return cudaGetLastError();
}
