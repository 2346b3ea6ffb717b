// Rulebook sparse 3D convolution with bf16 operands and fp32 sums,
// forward (K6's forward):
//   out[m] = sum_k bf16(F[rb[m, k]]) . bf16(W_k)
// over the taps whose rulebook entry is a row (rb in [0, n)); -1 (no
// input) contributes nothing. The file also holds the entry point of K7,
// the fp32 rulebook conv, which runs the gather-GEMM tile
// (csrc/gather_gemm.cuh) in map mode; see dm_gather_conv_fwd below.
//
// Replaces the TPU kernel detmatch_tpu/ops/pallas/onehot_gather.py:
// _onehot_gather_conv_fwd (pallas_call at :81). That kernel forms each
// tap's gather as a one-hot matmul over the whole feature table in bf16,
// O(M * N * K * C) compares and MACs, because TPU row gathers are slow. A
// rulebook entry matches one row, so the one-hot product is exactly
// bf16(F[rb]) (or 0), and the tap product sums exact bf16 products in
// fp32: this kernel gathers that row by index instead. Kernel and plain
// twin differ only in the order of the fp32 sums.
//
// What bounds it on the H100: at the backbone's shapes (up to 8 x 24,000
// output rows, 27 taps, 4-128 channels) a conv is at most ~2e10
// multiply-adds on a few MB of features and a few MB of rulebook; the
// gathers' memory latency bounds this simple design, not the arithmetic.
//
// Design, simple first: one block per 32 output rows; the block loads
// its 32 x K rulebook entries into shared memory, then per tap stages
// bf16(W_k) and the 32 gathered bf16(F) rows in shared memory and
// accumulates fp32 FMAs in registers, up to 16 outputs a thread, over
// every tap of every row (a tap without a row adds zeros). No tensor
// cores, cp.async or register tiles yet.
#include "gather_gemm.cuh"

namespace {

using dm::gemm::bf16_round;

constexpr int kRows = 32;                          // output rows per block
constexpr int kThreads = 256;
constexpr int kMaxTaps = 27;
constexpr int kMaxCin = 64;
constexpr int kMaxCout = 128;
constexpr int kMaxW = 8192;                        // C * Co floats per tap
constexpr int kAcc = kRows * kMaxCout / kThreads;  // outputs per thread

__global__ void __launch_bounds__(kThreads)
    gather_conv_kernel(const float* __restrict__ feats,
                       const int32_t* __restrict__ rb,
                       const float* __restrict__ weights,
                       float* __restrict__ out, int n, int m, int k, int c,
                       int co) {
  __shared__ int s_src[kRows][kMaxTaps];
  __shared__ float s_w[kMaxW];
  __shared__ float s_f[kRows * kMaxCin];

  const int t = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  for (int p = t; p < kRows * k; p += kThreads) {
    const int r = p / k;
    const int tap = p - r * k;
    const int64_t row = row0 + r;
    int src = -1;
    if (row < m) {
      const int32_t i = rb[row * k + tap];
      if (i >= 0 && i < n) src = i;
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
    for (int e = t; e < cw; e += kThreads) s_w[e] = bf16_round(wk[e]);
    for (int e = t; e < kRows * c; e += kThreads) {
      const int r = e / c;
      const int ci = e - r * c;
      const int src = s_src[r][tap];
      s_f[e] = src >= 0
                   ? bf16_round(feats[static_cast<size_t>(src) * c + ci])
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
      if (row < m) out[row * co + oc] = acc[j];
    }
  }
}

bool bad_args(int b, int n, int m, int k, int c, int co) {
  return b < 0 || n <= 0 || m < 0 || k <= 0 || k > kMaxTaps || c <= 0 ||
         c > kMaxCin || co <= 0 || co > kMaxCout || c * co > kMaxW ||
         static_cast<int64_t>(b) * n > 0x7fffffff ||
         static_cast<int64_t>(b) * m > 0x7fffffff;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// K6's forward: feats (n, c) f32; rb (m, k) int32 rows, -1 (or any entry
// outside [0, n)) for none; weights (k, c, co) f32 → out (m, co) f32.
DM_EXPORT int dm_onehot_gather_conv_fwd(const float* feats,
                                        const int32_t* rb,
                                        const float* weights, float* out,
                                        int n, int m, int k, int c, int co,
                                        cudaStream_t stream) {
  if (bad_args(1, n, m, k, c, co)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((m + kRows - 1) / kRows);
  gather_conv_kernel<<<blocks, kThreads, 0, stream>>>(feats, rb, weights,
                                                      out, n, m, k, c, co);
  return cudaGetLastError();
}

// K7, replacing the TPU kernel detmatch_tpu/ops/pallas/spconv_kernel.py:
// pallas_gather_conv (pallas_call at :59), the fp32 gather-GEMM of
// spconv.gather_conv_batched, the rulebook path's conv (JAX's
// conv_impl="xla"):
//   out[b, m] = sum_k F[b, rb[b, m, k]] . W_k
// over the taps whose entry is a row of sample b (rb in [0, n)).
// What bounds it on the H100: the fp32 FMAs of the matched (row, tap)
// pairs, 5-21% of the rows x 27 taps at the backbone's shapes.
// Design: the gather-GEMM tile (csrc/gather_gemm.cuh) in map mode on the
// rulebook: only matched pairs are gathered (cp.async, two stages) and
// multiplied, by 4 x 4 register micro-tiles, fmaf from +0 over the taps
// ascending, then the channels; the same bits as K1's forward on the same
// rulebook. The tile copies 16-byte vectors: where C or Co is not a
// multiple of 4, or feats or weights does not start on 16 bytes, a
// prologue copies them into fp (b * n, C4) and wp (k, C4, Co4) with zero
// pads (C, Co up to multiples of 4; zero pads change no bit), and the
// tile stores Co of its Co4 columns.
// feats (b, n, c) f32; rb (b, m, k) int32 per-sample rows, -1 (or any
// entry outside [0, n)) for none; weights (k, c, co) f32 → out (b, m, co)
// f32. fp, wp: that scratch, or both nullptr where no pad is needed
// (ops/cuda/gather_conv.needs_pad); rows: output rows per block
// (ops/cuda/gather_conv.k7_tile_rows).
DM_EXPORT int dm_gather_conv_fwd(const float* feats, const int32_t* rb,
                                 const float* weights, float* fp, float* wp,
                                 float* out, int b, int n, int m, int k,
                                 int c, int co, int rows,
                                 cudaStream_t stream) {
  if (bad_args(b, n, m, k, c, co) || (fp == nullptr) != (wp == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (static_cast<int64_t>(b) * m == 0) return cudaSuccess;
  const int c4 = (c + 3) / 4 * 4;
  const int co4 = (co + 3) / 4 * 4;
  if (fp != nullptr) {
    const cudaError_t err = dm::gemm::launch_pad_operands<false>(
        feats, weights, fp, wp, static_cast<int64_t>(b) * n, k, c, co, c4,
        co4, stream);
    if (err != cudaSuccess) return err;
    feats = fp;
    weights = wp;
  } else if (c != c4 || co != co4 || !aligned16(feats) ||
             !aligned16(weights)) {
    return cudaErrorInvalidValue;
  }
  return dm::gemm::launch_gather_gemm<false>(feats, nullptr, rb, weights, out,
                                             nullptr, b, n, m, k, c4, co4,
                                             rows, stream, co);
}
