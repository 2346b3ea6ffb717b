// Key-compare sparse 3D convolution with bf16 operands and fp32 sums,
// forward (K5) and the backward's scatter:
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
// The function is the TPU kernel's but for the order of the fp32 sums:
// keys are unique within a sample, so a tap matches at most one row; a
// product of two bf16 numbers is exact in fp32; the forward therefore
// sums the same exact products, and S holds bf16(dout) at the one match
// and zero elsewhere, with no sum at all. For any conv geometry
// (submanifold, strided, z-compressing) an input row and a tap fix at most
// one output row, so each S slot is written at most once: a plain store,
// no atomics.
//
// What bounds the forward on the H100: the products of the matched
// (row, tap) pairs only, 5-21% of rows x 27 taps at the backbone's shapes
// (up to 8 x 24,000 output rows, 4-128 channels), against the bytes of
// the features, key tables and outputs, a few MB a call: bytes, by the
// bound's count; in practice the gathers' latency and the fp32 FMA
// rate. The backward's S is written once (up to 27 x 8 x 16,000 rows x
// 32 floats, ~440 MB at the widest level): its bytes bound the scatter.
//
// Forward: a prologue rounds F and W once per call to bf16 values kept in
// fp32 scratch that the wrapper allocates ((B * N, C4) and (K, C4, Co4):
// C and Co up to multiples of 4, zeros in the pads, so every row is 16
// bytes aligned); then K1's gather-GEMM tile (csrc/gather_gemm.cuh) runs
// on them in search mode: per block of output rows the (row, tap) keys
// are searched once, per tap only the rows with a source are gathered
// (cp.async, two stages) and multiplied into fp32 accumulators by fmaf,
// taps ascending, then channels. That is the order of the twin's fp32
// matmul over the (tap, channel) rows, and a zero pad adds nothing, so
// the forward equals the twin bit for bit on the card (and every launch
// gives the same bits). Rounding F once costs one pass over it; rounding
// in the tile would repeat it for every tap that gathers a row.
// Why not the tensor cores: bf16 mma.sync on this tile (zero-padded
// m16n8k16 fragments) took the 12 key-path student convs at B=8 to 2.65
// ms on an H100 (this design: 4.02 ms; the earlier per-block kernel:
// 24.07 ms), within 7.7e-7 of the twin's largest magnitude. But an MMA
// sums its products in its own order and rounding, and on the key path
// each conv's output is rounded to bf16 again at the next conv's input,
// where a one-ulp difference flips a rounding: the SSL iteration's
// losses moved by up to 2.5e-3 against the twin's, past the 1e-4 the key
// path is held to, whether the accumulators were the MMA's C operand or
// zeroed fragments were added to them by IEEE adds. Only the twin's
// sequential fp32 sums keep the key path's losses.
//
// Backward: a grid-stride zero fill of S, then one block per 32 output
// rows resolves its pairs and copies each matched bf16-rounded dout row
// into S, channels across threads.
#include <cuda_bf16.h>

#include "gather_gemm.cuh"

namespace {

constexpr int kRows = 32;                          // output rows per block
constexpr int kThreads = 256;
constexpr int kMaxTaps = 27;
constexpr int kMaxCin = 64;
constexpr int kMaxCout = 128;
constexpr int kMaxW = 8192;                        // C * Co floats per tap

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

// bf16(feats) (rows, c) → fr (rows, c4) and bf16(W) (k, c, co) → wr
// (k, c4, co4), both fp32 with zero pads: the feature entries first, then
// the weights', one grid-stride loop.
__global__ void __launch_bounds__(kThreads)
    round_operands_kernel(const float* __restrict__ feats,
                          const float* __restrict__ w, float* __restrict__ fr,
                          float* __restrict__ wr, int64_t rows, int k, int c,
                          int co, int c4, int co4) {
  const int64_t nf = rows * c4;
  const int64_t total = nf + static_cast<int64_t>(k) * c4 * co4;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    if (e < nf) {
      const int64_t r = e / c4;
      const int ci = static_cast<int>(e - r * c4);
      fr[e] = ci < c ? bf16_round(feats[r * c + ci]) : 0.f;
    } else {
      const int64_t f = e - nf;
      const int n = static_cast<int>(f % co4);
      const int64_t tc = f / co4;  // tap * c4 + ci
      const int ci = static_cast<int>(tc % c4);
      const int64_t tap = tc / c4;
      wr[f] = ci < c && n < co ? bf16_round(w[(tap * c + ci) * co + n]) : 0.f;
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
// fr, wr: scratch for the rounded operands, b * n * C4 and k * C4 * Co4
// floats (C, Co up to multiples of 4; ops/cuda/key_conv.rounded_shapes);
// rows: output rows per block (ops/cuda/window_key_conv.tile_rows(k, C4,
// Co4)).
DM_EXPORT int dm_key_conv_fwd(const float* feats, const int32_t* keys,
                              const int32_t* nkeys, const float* weights,
                              float* fr, float* wr, float* out, int b, int n,
                              int m, int k, int c, int co, int rows,
                              cudaStream_t stream) {
  if (bad_args(b, n, m, k, c, co)) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(b) * m == 0) return cudaSuccess;
  const int c4 = (c + 3) / 4 * 4;
  const int co4 = (co + 3) / 4 * 4;
  const int64_t total = static_cast<int64_t>(b) * n * c4 +
                        static_cast<int64_t>(k) * c4 * co4;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  round_operands_kernel<<<static_cast<unsigned>(blocks < 132 * 16
                                                    ? blocks
                                                    : 132 * 16),
                          kThreads, 0, stream>>>(
      feats, weights, fr, wr, static_cast<int64_t>(b) * n, k, c, co, c4,
      co4);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dm::gemm::launch_gather_gemm<true>(fr, keys, nkeys, wr, out,
                                            nullptr, b, n, m, k, c4, co4,
                                            rows, stream, co);
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
