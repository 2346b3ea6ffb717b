// Row gather with bf16 rounding (K8's forward):
//   out[b, q] = bf16(x[b, idx[b, q]])   (0 where idx is outside [0, N): -1,
//               or padding)
// Its transpose, the scatter-add dx[b, n] = sum_q 1[idx[b, q] == n] *
// bf16(dout[b, q]), is the chunked segment sum of csrc/segment_sum.cu.
//
// Replaces the TPU kernels of detmatch_tpu/ops/pallas/onehot_rows.py:
// _gather_fwd (pallas_call at :62) and its batched form
// _gather_fwd_batched (:162). They form the gather as a one-hot matmul
// over the whole table (O(Q * N * C) MACs on the TPU's matrix unit); the
// one match of each row gives bf16(x[idx]) exactly, so the gather here
// reads the row by index.
//
// What bounds it on the H100: bytes. The gather reads the B * Q indices
// and the table rows they reach and writes B * Q * C floats (~3.5 M rows
// at the RoI-grid shape).
//
// Design: rows move as 16-byte vectors. A warp step covers 32 / L rows, L
// = min(C / 4, 32) lanes a row, each lane a float4 of it (and every
// 32nd one after it where C > 128); a warp keeps kUnroll steps' loads in
// flight before it stores. Each row's index is read once, by one lane,
// and shuffled to the row's lanes. The grid's y is the sample, so every
// address inside a sample is 32-bit arithmetic, with no division by C
// per element. Values are rounded to bf16 in registers and stored with
// streaming stores (__stcs): nothing reads them again here. Where C is
// not a multiple of 4, or x does not start on 16 bytes, the same kernel
// moves one float a lane: the same bits.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // warp steps in flight
constexpr int kMaxBlocks = 132 * 16;

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float4 round(float4 v) {
    return make_float4(bf16(v.x), bf16(v.y), bf16(v.z), bf16(v.w));
  }
  static __device__ __forceinline__ void store(float* p, float4 v) {
    __stcs(reinterpret_cast<float4*>(p), v);
  }
  static __device__ __forceinline__ float bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(float* p, float v) {
    __stcs(p, v);
  }
};

// out[b, r] = bf16(x[b, idx[b, r]]) or zeros, V floats a lane; block
// (x, y) = (a share of the rows, sample y).
template <int V>
__global__ void __launch_bounds__(kThreads)
    take_rows_kernel(const float* __restrict__ x,
                     const int32_t* __restrict__ idx,
                     float* __restrict__ out, int n, int q, int c) {
  using T = typename Vec<V>::T;
  const int bi = blockIdx.y;
  const float* xb = x + static_cast<int64_t>(bi) * n * c;
  float* ob = out + static_cast<int64_t>(bi) * q * c;
  const int32_t* ib = idx + static_cast<int64_t>(bi) * q;
  const int cv = c / V;                  // vectors a row
  const int lpr = cv < 32 ? cv : 32;     // lanes a row
  const int rpw = 32 / lpr;              // rows a warp step
  const int lane = threadIdx.x & 31;
  const int grp = lane / lpr;            // the lane's row in a step
  const int sub = lane - grp * lpr;      // its first vector of the row
  const bool active = grp < rpw;
  const int warps = gridDim.x * (kThreads / 32);
  const int step = rpw * kUnroll;        // rows a warp takes at a time
  for (int r0 = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * step;
       r0 < q; r0 += warps * step) {
    int src[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r0 + u * rpw + lane;
      const int32_t i = lane < rpw && rr < q ? ib[rr] : -1;
      src[u] = __shfl_sync(0xffffffffu, i, active ? grp : 0);
    }
    for (int j = sub; j < cv; j += lpr) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = active && src[u] >= 0 && src[u] < n &&
                        r0 + u * rpw + grp < q;
        v[u] = ok ? Vec<V>::load(xb + src[u] * c + j * V) : Vec<V>::zero();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = r0 + u * rpw + grp;
        if (active && row < q) {
          Vec<V>::store(ob + row * c + j * V, Vec<V>::round(v[u]));
        }
      }
    }
  }
}

}  // namespace

// x (b, n, c) f32, idx (b, q) int32 → out (b, q, c) f32. n * c and q * c
// below 2^31, b at most 65,535 (the grid's y).
DM_EXPORT int dm_onehot_take_rows(const float* x, const int32_t* idx,
                                  float* out, int b, int n, int q, int c,
                                  cudaStream_t stream) {
  if (b < 0 || b > 65535 || n <= 0 || q < 0 || c <= 0 ||
      static_cast<int64_t>(n) * c > 0x7fffffff ||
      static_cast<int64_t>(q) * c > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  if (static_cast<int64_t>(b) * q == 0) return cudaSuccess;
  const bool vec4 = c % 4 == 0 && dm::aligned16(x) && dm::aligned16(out);
  const int cv = vec4 ? c / 4 : c;
  const int rows_per_block = 32 / (cv < 32 ? cv : 32) * kUnroll *
                             (kThreads / 32);
  const int want = (q + rows_per_block - 1) / rows_per_block;
  const int cap = (kMaxBlocks + b - 1) / b;
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap),
                  static_cast<unsigned>(b));
  if (vec4) {
    take_rows_kernel<4><<<grid, kThreads, 0, stream>>>(x, idx, out, n, q, c);
  } else {
    take_rows_kernel<1><<<grid, kThreads, 0, stream>>>(x, idx, out, n, q, c);
  }
  return cudaGetLastError();
}
