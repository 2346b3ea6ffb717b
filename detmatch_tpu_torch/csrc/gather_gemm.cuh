// The sparse-conv gather-GEMM tile shared by K1's forward
// (csrc/window_key_conv.cu), its input gradient
// (csrc/window_key_conv_bwd.cu), K5's forward (csrc/key_conv.cu, on
// bf16-rounded operands) and K7 (csrc/gather_conv.cu, the rulebook
// conv):
//   Y[b, r] = sum_k X[b, src(b, r, k)] . W_k        (W_k is Cx x Cy)
// over the taps k whose source row exists. kSearch = true resolves
// src(b, r, k) by binary search of the neighbour key idx[b, r, k] in
// sample b's sorted key table (K1 and K5); kSearch = false reads it from
// the map idx[b, r, k] (-1 or any entry outside [0, n_src) = none): K7's
// rulebook, and K1 backward's inverse rulebook.
//
// Order of the sums, per output element: one fp32 accumulator from +0,
// fmaf over the taps ascending, then over the Cx input channels
// ascending. A tap without a source row is skipped, which leaves the
// same bits as adding (+0) * w: K1's forward in search mode and K7 in
// map mode on the same rulebook give the same bits, and so did the
// earlier K7 kernel, which walked every tap in this order.
//
// Design (what bounds it is the fp32 FMA rate on matched pairs only):
// - A block owns `rows` (32-128) consecutive output rows. It resolves
//   their rows x K sources into shared memory, then builds, per tap, the
//   list of its rows that have a source (ballots, ascending) and the list
//   of taps with a nonempty list. A tile of pad rows does no arithmetic.
// - The accumulators live in shared memory, (rows, Cy) fp32. Per tap a
//   thread owns 4 listed rows x 4 output channels: it loads their 16
//   accumulators, runs the Cx loop on float4 reads (one shared load per
//   4 FMAs) and stores them back.
// - Two stages of cp.async: the listed rows of the next nonempty tap and
//   its W_k are copied while the current tap computes. W_k is read once
//   per block and tap. Dynamic shared memory, up to 227 KB.
// Needs Cx % 4 == 0, Cy % 4 == 0 and 16-byte aligned X and W (16-byte
// copies); the callers check it. Y's rows may be narrower than Cy
// (y_ld < Cy: K5 and K7 pad Co up to 4 with zero weights and store Co).
// pad_operands_kernel copies X and W into such widths, zeros in the pads,
// and for K5 rounds them to bf16 on the way. A zero pad changes no bit
// of the sums: an accumulator that starts at +0 is never -0, so fmaf(0,
// 0, a) == a.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace dm {
namespace gemm {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 27;
constexpr int kMaxRows = 128;  // list entries are uint8 row offsets
constexpr int kMaxSmem = 232448;

// Bytes of dynamic shared memory of one block (mirrored by
// ops/cuda/window_key_conv.tile_smem_bytes).
inline int64_t tile_smem_bytes(int rows, int k, int cx, int cy) {
  const int64_t floats = static_cast<int64_t>(rows) * cy +
                         2 * (static_cast<int64_t>(rows) * cx +
                              static_cast<int64_t>(cx) * cy);
  const int64_t ints = static_cast<int64_t>(rows) * k + 2 * 32;
  const int64_t list = (static_cast<int64_t>(k) * rows + 15) / 16 * 16;
  return 4 * floats + 4 * ints + list;
}

inline bool tile_ok(int rows, int k, int cx, int cy) {
  return rows > 0 && rows % 32 == 0 && rows <= kMaxRows && k > 0 &&
         k <= kMaxTaps && cx > 0 && cx % 4 == 0 && cy > 0 && cy % 4 == 0 &&
         tile_smem_bytes(rows, k, cx, cy) <= kMaxSmem;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

using dm::cp_async16;
using dm::cp_async_commit;
using dm::cp_async_wait;

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// acc[j] (4 channels) += x[j] . w over one input channel: fmaf in
// channel order x, y, z, w of the float4.
__device__ __forceinline__ void fma4(float4& acc, float x, const float4& w) {
  acc.x = fmaf(x, w.x, acc.x);
  acc.y = fmaf(x, w.y, acc.y);
  acc.z = fmaf(x, w.z, acc.z);
  acc.w = fmaf(x, w.w, acc.w);
}

// X (b * n_src, cx); idx (b, m_dst, k); keys (b, n_src) if kSearch;
// W (k, cx, cy); Y (b * m_dst, y_ld), y_ld <= cy; rb_out (b, m_dst, k) or
// nullptr: the resolved per-sample source rows (-1 = none), written if
// given.
template <bool kSearch>
__global__ void __launch_bounds__(kThreads)
    gather_gemm_kernel(const float* __restrict__ x,
                       const int32_t* __restrict__ keys,
                       const int32_t* __restrict__ idx,
                       const float* __restrict__ w, float* __restrict__ y,
                       int32_t* __restrict__ rb_out, int b, int n_src,
                       int m_dst, int k, int cx, int cy, int y_ld,
                       int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_acc = reinterpret_cast<float*>(smem);
  float* s_x[2];
  float* s_w[2];
  s_x[0] = s_acc + rows * cy;
  s_w[0] = s_x[0] + rows * cx;
  s_x[1] = s_w[0] + cx * cy;
  s_w[1] = s_x[1] + rows * cx;
  int* s_src = reinterpret_cast<int*>(s_w[1] + cx * cy);  // (rows, k)
  int* s_cnt = s_src + rows * k;                           // [32]
  int* s_taps = s_cnt + 32;                                // [32]
  unsigned char* s_list = reinterpret_cast<unsigned char*>(s_taps + 32);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t total = static_cast<int64_t>(b) * m_dst;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows;

  // 1. sources of the tile's (row, tap) pairs, as global rows of X
  for (int p = t; p < rows * k; p += kThreads) {
    const int r = p / k;
    const int tap = p - r * k;
    const int64_t row = row0 + r;
    int src = -1;
    if (row < total) {
      const int bi = static_cast<int>(row / m_dst);
      const int32_t q = idx[row * k + tap];
      int pos = -1;
      if (kSearch) {
        if (q != kInvalidKey) {
          const int32_t* tbl = keys + static_cast<size_t>(bi) * n_src;
          const int at = lower_bound(tbl, n_src, q);
          if (at < n_src && tbl[at] == q) pos = at;
        }
      } else if (q >= 0 && q < n_src) {
        pos = q;
      }
      if (rb_out != nullptr) rb_out[row * k + tap] = pos;
      if (pos >= 0) src = bi * n_src + pos;
    }
    s_src[p] = src;
  }
  for (int e = t; e < rows * cy; e += kThreads) s_acc[e] = 0.f;
  __syncthreads();

  // 2. per tap, its rows with a source, ascending (warp w: taps w, w+8..)
  for (int tap = warp; tap < k; tap += kThreads / 32) {
    int base = 0;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const bool has = s_src[(r0 + lane) * k + tap] >= 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, has);
      if (has) {
        const int at = base + __popc(ballot & ((1u << lane) - 1u));
        s_list[tap * rows + at] = static_cast<unsigned char>(r0 + lane);
      }
      base += __popc(ballot);
    }
    if (lane == 0) s_cnt[tap] = base;
  }
  __syncthreads();
  if (t == 0) {
    int nt = 0;
    for (int tap = 0; tap < k; ++tap) {
      if (s_cnt[tap] > 0) s_taps[nt++] = tap;
    }
    s_taps[31] = nt;
  }
  __syncthreads();
  const int n_taps = s_taps[31];

  // 3. taps in ascending order, the next one's copies in flight
  const int cx4 = cx / 4;
  const int cy4 = cy / 4;
  auto issue = [&](int stage, int tap) {
    const int n = s_cnt[tap];
    const unsigned char* list = s_list + tap * rows;
    float* dx = s_x[stage];
    for (int e = t; e < n * cx4; e += kThreads) {
      const int j = e / cx4;
      const int q = e - j * cx4;
      const int src = s_src[list[j] * k + tap];
      cp_async16(dx + j * cx + q * 4,
                 x + static_cast<size_t>(src) * cx + q * 4);
    }
    const float* wk = w + static_cast<size_t>(tap) * cx * cy;
    float* dw = s_w[stage];
    for (int e = t; e < cx * cy4; e += kThreads) {
      cp_async16(dw + e * 4, wk + e * 4);
    }
  };
  if (n_taps > 0) issue(0, s_taps[0]);
  cp_async_commit();
  for (int i = 0; i < n_taps; ++i) {
    if (i + 1 < n_taps) issue((i + 1) & 1, s_taps[i + 1]);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int tap = s_taps[i];
    const int n = s_cnt[tap];
    const unsigned char* list = s_list + tap * rows;
    const float* sx = s_x[i & 1];
    const float* sw = s_w[i & 1];
    const int units = (n + 3) / 4 * cy4;
    for (int u = t; u < units; u += kThreads) {
      const int rg = u / cy4;
      const int c0 = (u - rg * cy4) * 4;
      int jr[4];
      float4 a[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        jr[jj] = min(rg * 4 + jj, n - 1);
        a[jj] = *reinterpret_cast<const float4*>(s_acc + list[jr[jj]] * cy +
                                                 c0);
      }
      for (int ci = 0; ci < cx; ci += 4) {
        float4 f[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          f[jj] = *reinterpret_cast<const float4*>(sx + jr[jj] * cx + ci);
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 wv =
              *reinterpret_cast<const float4*>(sw + (ci + cc) * cy + c0);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) fma4(a[jj], comp(f[jj], cc), wv);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (rg * 4 + jj < n) {
          *reinterpret_cast<float4*>(s_acc + list[jr[jj]] * cy + c0) = a[jj];
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // 4. the tile's rows, zeros included
  if (y_ld == cy) {
    for (int e = t; e < rows * cy4; e += kThreads) {
      const int r = e / cy4;
      const int64_t row = row0 + r;
      if (row < total) {
        reinterpret_cast<float4*>(y + row * cy)[e - r * cy4] =
            reinterpret_cast<const float4*>(s_acc)[e];
      }
    }
  } else {
    for (int e = t; e < rows * y_ld; e += kThreads) {
      const int r = e / y_ld;
      const int64_t row = row0 + r;
      if (row < total) {
        y[row * y_ld + e - r * y_ld] = s_acc[r * cy + e - r * y_ld];
      }
    }
  }
}

// Launches gather_gemm_kernel<kSearch> over b * m_dst output rows; Y's
// rows hold y_ld floats (0: cy).
template <bool kSearch>
cudaError_t launch_gather_gemm(const float* x, const int32_t* keys,
                               const int32_t* idx, const float* w, float* y,
                               int32_t* rb_out, int b, int n_src, int m_dst,
                               int k, int cx, int cy, int rows,
                               cudaStream_t stream, int y_ld = 0) {
  y_ld = y_ld > 0 ? y_ld : cy;
  if (b < 0 || n_src <= 0 || m_dst < 0 || !tile_ok(rows, k, cx, cy) ||
      y_ld > cy ||
      static_cast<int64_t>(b) * n_src > 0x7fffffff ||
      static_cast<int64_t>(b) * m_dst > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  const int64_t total = static_cast<int64_t>(b) * m_dst;
  if (total == 0) return cudaSuccess;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_gemm_kernel<kSearch>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const unsigned blocks = static_cast<unsigned>((total + rows - 1) / rows);
  gather_gemm_kernel<kSearch>
      <<<blocks, kThreads, static_cast<size_t>(tile_smem_bytes(rows, k, cx,
                                                               cy)),
         stream>>>(x, keys, idx, w, y, rb_out, b, n_src, m_dst, k, cx, cy,
                   y_ld, rows);
  return cudaGetLastError();
}

// x (rows, cx) → xp (rows, cx4) and w (k, cx, cy) → wp (k, cx4, cy4),
// fp32, zeros in the pads; kRoundBf16 rounds every value to bf16. One
// grid-stride loop, the feature entries first.
template <bool kRoundBf16>
__global__ void __launch_bounds__(kThreads)
    pad_operands_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ xp,
                        float* __restrict__ wp, int64_t rows, int k, int cx,
                        int cy, int cx4, int cy4) {
  const int64_t nx = rows * cx4;
  const int64_t total = nx + static_cast<int64_t>(k) * cx4 * cy4;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    float v = 0.f;
    if (e < nx) {
      const int64_t r = e / cx4;
      const int ci = static_cast<int>(e - r * cx4);
      if (ci < cx) v = x[r * cx + ci];
      xp[e] = kRoundBf16 ? bf16_round(v) : v;
    } else {
      const int64_t f = e - nx;
      const int o = static_cast<int>(f % cy4);
      const int64_t tc = f / cy4;  // tap * cx4 + ci
      const int ci = static_cast<int>(tc % cx4);
      const int64_t tap = tc / cx4;
      if (ci < cx && o < cy) v = w[(tap * cx + ci) * cy + o];
      wp[f] = kRoundBf16 ? bf16_round(v) : v;
    }
  }
}

// Launches pad_operands_kernel<kRoundBf16> over x's rows and w's taps.
template <bool kRoundBf16>
cudaError_t launch_pad_operands(const float* x, const float* w, float* xp,
                                float* wp, int64_t rows, int k, int cx,
                                int cy, int cx4, int cy4,
                                cudaStream_t stream) {
  const int64_t total = rows * cx4 + static_cast<int64_t>(k) * cx4 * cy4;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  pad_operands_kernel<kRoundBf16>
      <<<static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16),
         kThreads, 0, stream>>>(x, w, xp, wp, rows, k, cx, cy, cx4, cy4);
  return cudaGetLastError();
}

}  // namespace gemm
}  // namespace dm
