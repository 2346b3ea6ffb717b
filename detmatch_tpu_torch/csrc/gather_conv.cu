// Rulebook gather-GEMM sparse 3D convolution, forward:
//   out[b, m] = sum_k op(F[b, rb[b, m, k]]) . op(W_k)
// over the taps whose rulebook entry is a row of sample b (rb in [0, n));
// -1 (no input) contributes nothing. op is the identity, or, with the
// template flag kRoundBf16, rounding to bf16; the sums are fp32 either way.
//
// Replaces two TPU kernels:
// - kRoundBf16 = false: detmatch_tpu/ops/pallas/spconv_kernel.py:
//   pallas_gather_conv (pallas_call at :59), the fp32 gather-GEMM that
//   gathers inside the kernel; the function of spconv.gather_conv_batched,
//   the rulebook path's conv (JAX's conv_impl="xla").
// - kRoundBf16 = true: detmatch_tpu/ops/pallas/onehot_gather.py:
//   _onehot_gather_conv_fwd (pallas_call at :81). That kernel forms each
//   tap's gather as a one-hot matmul over the whole feature table in bf16,
//   O(M * N * K * C) compares and MACs, because TPU row gathers are slow.
//   A rulebook entry matches one row, so the one-hot product is exactly
//   bf16(F[rb]) (or 0), and the tap product sums exact bf16 products in
//   fp32: this kernel gathers that row by index instead.
// Kernel and plain twins differ only in the order of the fp32 sums.
//
// What bounds it on the H100: at the backbone's shapes (up to 8 x 24,000
// output rows, 27 taps, 4-128 channels) a conv is at most ~2e10
// multiply-adds on a few MB of features and a few MB of rulebook; the
// gathers' memory latency bounds this simple design, not the arithmetic.
//
// Design, simple first (the same tiles as csrc/key_conv.cu, with the
// rulebook read instead of a key search): one block per 32 output rows;
// the block loads its 32 x K rulebook entries into shared memory as
// global input rows (b * n + rb), then per tap stages op(W_k) and the 32
// gathered op(F) rows in shared memory and accumulates fp32 FMAs in
// registers, up to 16 outputs a thread. No tensor cores, TMA or wgmma yet.
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

template <bool kRoundBf16>
__device__ __forceinline__ float operand(float x) {
  return kRoundBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <bool kRoundBf16>
__global__ void __launch_bounds__(kThreads)
    gather_conv_kernel(const float* __restrict__ feats,
                       const int32_t* __restrict__ rb,
                       const float* __restrict__ weights,
                       float* __restrict__ out, int b, int n, int m, int k,
                       int c, int co) {
  __shared__ int s_src[kRows][kMaxTaps];
  __shared__ float s_w[kMaxW];
  __shared__ float s_f[kRows * kMaxCin];

  const int t = threadIdx.x;
  const int64_t rows = static_cast<int64_t>(b) * m;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  for (int p = t; p < kRows * k; p += kThreads) {
    const int r = p / k;
    const int tap = p - r * k;
    const int64_t row = row0 + r;
    int src = -1;
    if (row < rows) {
      const int32_t i = rb[row * k + tap];
      if (i >= 0 && i < n) src = static_cast<int>(row / m) * n + i;
    }
    s_src[r][tap] = src;
  }

  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  const int cw = c * co;
  for (int tap = 0; tap < k; ++tap) {
    __syncthreads();  // s_src ready / previous tap's tiles consumed
    const float* wk = weights + static_cast<size_t>(tap) * cw;
    for (int e = t; e < cw; e += kThreads) s_w[e] = operand<kRoundBf16>(wk[e]);
    for (int e = t; e < kRows * c; e += kThreads) {
      const int r = e / c;
      const int ci = e - r * c;
      const int src = s_src[r][tap];
      s_f[e] = src >= 0 ? operand<kRoundBf16>(
                              feats[static_cast<size_t>(src) * c + ci])
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

}  // namespace

// feats (b, n, c) f32; rb (b, m, k) int32 rows of the same sample, -1 for
// none; weights (k, c, co) f32 → out (b, m, co) f32. round_bf16 != 0
// rounds every gathered row and weight to bf16 (K6's forward).
DM_EXPORT int dm_gather_conv_fwd(const float* feats, const int32_t* rb,
                                 const float* weights, float* out, int b,
                                 int n, int m, int k, int c, int co,
                                 int round_bf16, cudaStream_t stream) {
  if (b < 0 || n <= 0 || m < 0 || k <= 0 || k > kMaxTaps || c <= 0 ||
      c > kMaxCin || co <= 0 || co > kMaxCout || c * co > kMaxW ||
      static_cast<int64_t>(b) * n > 0x7fffffff ||
      (static_cast<int64_t>(b) * m + kRows - 1) / kRows > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  const int64_t rows = static_cast<int64_t>(b) * m;
  if (rows == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
  if (round_bf16) {
    gather_conv_kernel<true><<<blocks, kThreads, 0, stream>>>(
        feats, rb, weights, out, b, n, m, k, c, co);
  } else {
    gather_conv_kernel<false><<<blocks, kThreads, 0, stream>>>(
        feats, rb, weights, out, b, n, m, k, c, co);
  }
  return cudaGetLastError();
}
