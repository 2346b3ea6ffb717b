// Key-compare sparse 3D convolution with bf16 operands and fp32 sums,
// forward and the backward's scatter:
//   out[b, m]       = sum_k bf16(F[b, row(b,m,k)]) . bf16(W_k)
//   S[k, b*n + row] = bf16(dout[b, m])   for each (b, m, k) with a row
// where row(b,m,k) is the row of nkeys[b,m,k] in sample b's own sorted key
// table (none if absent or INVALID_KEY), and S is zero elsewhere.
//
// Replaces the TPU kernels detmatch_tpu/ops/pallas/onehot_key_conv.py:
// _key_conv_fwd (pallas_call at :97) and _key_scatter_all_taps (:163).
// Those compare every (row, tap) neighbour key against the whole flattened
// key table and feed the 0/1 match matrix to the MXU in bf16, which costs
// O(M * N * K) compares and answers the TPU's slow row gathers. Gathers are
// cheap here, so neither kernel compares tables: each (row, tap) key is
// found by binary search in its own sample's sorted segment (the TPU
// wrapper's flattened table is not sorted across samples), and the one
// matching row is gathered or scattered.
//
// The function is the TPU kernel's to the last bit but for the order of
// the fp32 sums: keys are unique within a sample, so a tap matches at most
// one row; a product of two bf16 numbers is exact in fp32; the forward
// therefore sums the same exact products, and S holds bf16(dout) at the
// one match and zero elsewhere, with no sum at all. For any conv geometry
// (submanifold, strided, z-compressing) an input row and a tap fix at most
// one output row, so each S slot is written at most once: a plain store,
// no atomics.
//
// What bounds it on the H100: at the backbone's shapes (up to 8 x 24,000
// output rows, 27 taps, 4-128 channels) the forward is at most ~2e10
// multiply-adds on a few MB of features, and the backward's S is written
// once (up to 27 x 8 x 16,000 rows x 32 floats, ~440 MB at the widest
// level). Memory latency of the gathers bounds the forward, and the
// bytes of S (zero fill, then the scattered rows) bound the scatter.
//
// Design, simple first. Forward: one block per 32 output rows; the block
// resolves its 32 x K (row, tap) pairs into shared memory, then per tap
// stages bf16-rounded W_k and the 32 gathered bf16-rounded input rows in
// shared memory (as fp32 values) and accumulates fp32 FMAs in registers,
// up to 16 outputs a thread. The tensor cores are not used: an mma over
// 32-row tiles would sum the same exact products, and the kernel waits on
// gathers, not on arithmetic. Backward: a grid-stride zero fill of S, then
// one block per 32 output rows resolves its pairs and copies each matched
// bf16-rounded dout row into S, channels across threads.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kRows = 32;                          // output rows per block
constexpr int kThreads = 256;
constexpr int kMaxTaps = 27;
constexpr int kMaxCin = 64;
constexpr int kMaxCout = 128;
constexpr int kMaxW = 8192;                        // C * Co floats per tap
constexpr int kAcc = kRows * kMaxCout / kThreads;  // outputs per thread

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Resolve the block's 32 x k (row, tap) pairs into s_src: the global input
// row b*n + pos, or -1.
__device__ __forceinline__ void resolve(const int32_t* __restrict__ keys,
                                        const int32_t* __restrict__ nkeys,
                                        int (*s_src)[kMaxTaps], int64_t row0,
                                        int64_t rows, int n, int m, int k) {
  for (int p = threadIdx.x; p < kRows * k; p += kThreads) {
    const int r = p / k;
    const int tap = p - r * k;
    const int64_t row = row0 + r;
    int src = -1;
    if (row < rows) {
      const int32_t q = nkeys[row * k + tap];
      if (q != dm::kInvalidKey) {
        const int bi = static_cast<int>(row / m);
        const int32_t* tbl = keys + static_cast<size_t>(bi) * n;
        const int pos = dm::lower_bound(tbl, n, q);
        if (pos < n && tbl[pos] == q) src = bi * n + pos;
      }
    }
    s_src[r][tap] = src;
  }
}

__global__ void __launch_bounds__(kThreads)
    key_conv_fwd_kernel(const float* __restrict__ feats,
                        const int32_t* __restrict__ keys,
                        const int32_t* __restrict__ nkeys,
                        const float* __restrict__ weights,
                        float* __restrict__ out, int b, int n, int m, int k,
                        int c, int co) {
  __shared__ int s_src[kRows][kMaxTaps];
  __shared__ float s_w[kMaxW];
  __shared__ float s_f[kRows * kMaxCin];

  const int t = threadIdx.x;
  const int64_t rows = static_cast<int64_t>(b) * m;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  resolve(keys, nkeys, s_src, row0, rows, n, m, k);

  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  const int cw = c * co;
  for (int tap = 0; tap < k; ++tap) {
    __syncthreads();  // s_src ready / previous tap's tiles consumed
    const float* wk = weights + static_cast<size_t>(tap) * cw;
    for (int e = t; e < cw; e += kThreads) s_w[e] = bf16_round(wk[e]);
    for (int e = t; e < kRows * c; e += kThreads) {
      const int r = e / c;
      const int ci = e - r * c;
      const int src = s_src[r][tap];
      s_f[e] = src >= 0 ? bf16_round(feats[static_cast<size_t>(src) * c + ci])
                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int o = t + j * kThreads;
      if (o < kRows * co) {
        const int r = o / co;
        const int oc = o - r * co;
        const float* f = s_f + r * c;
        float a = acc[j];
        for (int ci = 0; ci < c; ++ci) a = fmaf(f[ci], s_w[ci * co + oc], a);
        acc[j] = a;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int o = t + j * kThreads;
    if (o < kRows * co) {
      const int r = o / co;
      const int oc = o - r * co;
      const int64_t row = row0 + r;
      if (row < rows) out[row * co + oc] = acc[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    zero_kernel(float4* __restrict__ s, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += stride) {
    s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
    key_scatter_kernel(const float* __restrict__ dout,
                       const int32_t* __restrict__ keys,
                       const int32_t* __restrict__ nkeys,
                       float* __restrict__ s, int b, int n, int m, int k,
                       int co) {
  __shared__ int s_src[kRows][kMaxTaps];
  const int64_t rows = static_cast<int64_t>(b) * m;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  resolve(keys, nkeys, s_src, row0, rows, n, m, k);
  __syncthreads();
  const int64_t slab = static_cast<int64_t>(b) * n * co;  // one tap of S
  for (int e = threadIdx.x; e < kRows * k * co; e += kThreads) {
    const int pair = e / co;
    const int oc = e - pair * co;
    const int r = pair / k;
    const int tap = pair - r * k;
    const int src = s_src[r][tap];
    if (src >= 0) {
      s[tap * slab + static_cast<int64_t>(src) * co + oc] =
          bf16_round(dout[(row0 + r) * co + oc]);
    }
  }
}

bool bad_args(int b, int n, int m, int k, int c, int co) {
  return b < 0 || n <= 0 || m < 0 || k <= 0 || k > kMaxTaps || c <= 0 ||
         c > kMaxCin || co <= 0 || co > kMaxCout || c * co > kMaxW ||
         static_cast<int64_t>(b) * n > 0x7fffffff ||
         (static_cast<int64_t>(b) * m + kRows - 1) / kRows > 0x7fffffff;
}

}  // namespace

// feats (b, n, c) f32; keys (b, n) int32 sorted per sample, INVALID_KEY
// padded; nkeys (b, m, k) int32; weights (k, c, co) f32 → out (b, m, co).
DM_EXPORT int dm_key_conv_fwd(const float* feats, const int32_t* keys,
                              const int32_t* nkeys, const float* weights,
                              float* out, int b, int n, int m, int k, int c,
                              int co, cudaStream_t stream) {
  if (bad_args(b, n, m, k, c, co)) return cudaErrorInvalidValue;
  const int64_t rows = static_cast<int64_t>(b) * m;
  if (rows == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
  key_conv_fwd_kernel<<<blocks, kThreads, 0, stream>>>(
      feats, keys, nkeys, weights, out, b, n, m, k, c, co);
  return cudaGetLastError();
}

// dout (b, m, co) f32 → s (k, b * n, co) f32; co must be a multiple of 4
// (the zero fill writes float4).
DM_EXPORT int dm_key_conv_bwd_scatter(const float* dout, const int32_t* keys,
                                      const int32_t* nkeys, float* s, int b,
                                      int n, int m, int k, int co,
                                      cudaStream_t stream) {
  if (bad_args(b, n, m, k, 1, co) || co % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t n4 = static_cast<int64_t>(k) * b * n * co / 4;
  if (n4 == 0) return cudaSuccess;
  const int64_t zb = (n4 + kThreads - 1) / kThreads;
  zero_kernel<<<static_cast<unsigned>(zb < 132 * 16 ? zb : 132 * 16),
                kThreads, 0, stream>>>(reinterpret_cast<float4*>(s), n4);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(b) * m;
  if (rows == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
  key_scatter_kernel<<<blocks, kThreads, 0, stream>>>(dout, keys, nkeys, s,
                                                      b, n, m, k, co);
  return cudaGetLastError();
}
