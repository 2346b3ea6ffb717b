// Sparse 3D convolution forward over sorted int32 voxel keys:
//   out[b, m] = sum_k F[b, row(nkeys[b, m, k])] . W_k
// where row(q) is the row of key q in sample b's own sorted key table
// (no row if q is absent or INVALID_KEY).
//
// Replaces the TPU kernel detmatch_tpu/ops/pallas/window_key_conv.py:_fwd
// (_fwd_kernel), which avoids gathers, slow on the TPU, by comparing each
// 512-row output tile's neighbour keys against a window of the flattened
// key table and contracting one-hot matches on the MXU in bf16. Gathers
// are cheap here, so this kernel does not copy the key-window compare. It
// also searches each sample's own segment: the TPU wrapper's flattened
// table keeps INVALID_KEY pads between samples, which breaks the sorted
// order its window search relies on.
//
// What bounds it on the H100: at the backbone shapes (up to 4 x 24,000
// output rows, 27 taps, 16-128 channels) the work is at most ~10 GFLOP
// and the features are a few MB, so it is bound by memory latency of the
// row gathers and the per-tap weight reloads, not by arithmetic.
//
// Design, simple first: one block per 32 output rows. The block resolves
// its 32 x K (row, tap) pairs by binary search in the sample's key table
// into shared memory, then for each tap stages W_k (C x Co, <= 32 KB) and
// the 32 gathered input rows in shared memory and accumulates in fp32
// registers, up to 16 outputs a thread. fp32 throughout, like the XLA
// rulebook path (spconv.gather_conv_batched) that the JAX reference runs
// off the TPU; the TPU kernel's bf16 rounding is not reproduced.
#include "common.cuh"

namespace {

constexpr int kRows = 32;                          // output rows per block
constexpr int kThreads = 256;
constexpr int kMaxTaps = 27;
constexpr int kMaxCin = 64;
constexpr int kMaxCout = 128;
constexpr int kMaxW = 8192;                        // C * Co floats per tap
constexpr int kAcc = kRows * kMaxCout / kThreads;  // outputs per thread

__device__ __forceinline__ int lower_bound(const int32_t* keys, int n,
                                           int32_t q) {
  int a = 0;
  int z = n;
  while (a < z) {
    const int mid = (a + z) >> 1;
    if (keys[mid] < q) {
      a = mid + 1;
    } else {
      z = mid;
    }
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
    window_key_conv_fwd_kernel(const float* __restrict__ feats,
                               const int32_t* __restrict__ keys,
                               const int32_t* __restrict__ nkeys,
                               const float* __restrict__ weights,
                               float* __restrict__ out, int b, int n, int m,
                               int k, int c, int co) {
  __shared__ int s_src[kRows][kMaxTaps];  // global input row, -1 = none
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
      const int32_t q = nkeys[row * k + tap];
      if (q != dm::kInvalidKey) {
        const int bi = static_cast<int>(row / m);
        const int32_t* tbl = keys + static_cast<size_t>(bi) * n;
        const int pos = lower_bound(tbl, n, q);
        if (pos < n && tbl[pos] == q) src = bi * n + pos;
      }
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
    for (int e = t; e < cw; e += kThreads) s_w[e] = wk[e];
    for (int e = t; e < kRows * c; e += kThreads) {
      const int r = e / c;
      const int ci = e - r * c;
      const int src = s_src[r][tap];
      s_f[e] = src >= 0 ? feats[static_cast<size_t>(src) * c + ci] : 0.f;
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

// feats (b, n, c) f32; keys (b, n) int32 sorted per sample, INVALID_KEY
// padded; nkeys (b, m, k) int32; weights (k, c, co) f32 → out (b, m, co).
DM_EXPORT int dm_window_key_conv_fwd(const float* feats, const int32_t* keys,
                                     const int32_t* nkeys,
                                     const float* weights, float* out, int b,
                                     int n, int m, int k, int c, int co,
                                     cudaStream_t stream) {
  if (b < 0 || n <= 0 || m < 0 || k <= 0 || k > kMaxTaps || c <= 0 ||
      c > kMaxCin || co <= 0 || co > kMaxCout || c * co > kMaxW) {
    return cudaErrorInvalidValue;
  }
  const int64_t rows = static_cast<int64_t>(b) * m;
  if (rows == 0) return cudaSuccess;
  const int64_t blocks = (rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffff || static_cast<int64_t>(b) * n > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  window_key_conv_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(feats, keys, nkeys, weights, out, b,
                                         n, m, k, c, co);
  return cudaGetLastError();
}
