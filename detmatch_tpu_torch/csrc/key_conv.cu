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
// cheap here, so nothing compares tables: the forward finds each
// (row, tap) key by binary search in its own sample's sorted segment (the
// TPU wrapper's flattened table is not sorted across samples), gathers
// the one matching row and writes the rulebook of what it found; the
// backward scatters by that rulebook.
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
// rate. The backward's S is written once (up to 27 x 8 x 24,000 rows x
// 64 floats, ~1.3 GB at x_conv3's strided conv): its bytes bound it.
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
// Backward: S is written once, from the rulebook that the forward's tile
// resolved and wrote (rb_out), so nothing is searched again. An inverse
// map inv[k, b * n + row] (the output row b * m + m' whose tap k reads
// input row `row`, -1 = none; 1/Co of S's bytes) is filled with -1 and
// written from the rulebook, one writer a slot (the property above; an
// integer atomicMax where a malformed rulebook repeats one), one thread
// an output row over its taps; then one streaming pass writes
// every row of S, bf16(dout[inv]) or zeros, 16 bytes a thread, rows
// consecutive across a block (coalesced stores, no separate zero fill,
// no matched row written twice). No float atomics: deterministic.
#include "gather_gemm.cuh"

namespace {

using dm::gemm::bf16_round;

constexpr int kThreads = 256;
constexpr int kMaxTaps = 27;
constexpr int kMaxCin = 64;
constexpr int kMaxCout = 128;
constexpr int kMaxW = 8192;   // C * Co floats per tap
constexpr int kUnroll = 4;    // S rows a thread has in flight

// inv[tap * b * n + bi * n + rb[row, tap]] = row for each output row
// (one thread a row) and tap with an input row; the caller fills inv
// with -1 first. Every conv gives a slot one writer; atomicMax keeps a
// rulebook that repeats one deterministic (the largest row wins).
__global__ void __launch_bounds__(kThreads)
    invert_rulebook_kernel(const int32_t* __restrict__ rb,
                           int32_t* __restrict__ inv, int b, int n, int m,
                           int k) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (row >= static_cast<int64_t>(b) * m) return;
  const int64_t base = row / m * n;  // bi * n
  const int64_t slab = static_cast<int64_t>(b) * n;
  for (int tap = 0; tap < k; ++tap) {
    const int32_t v = rb[row * k + tap];
    if (v >= 0 && v < n) {
      atomicMax(inv + tap * slab + base + v, static_cast<int32_t>(row));
    }
  }
}

// S row `slot` (co4 float4s) = bf16(dout[inv[slot]]) or zeros. A block
// step covers kThreads / co4 consecutive rows, a thread one float4 of a
// row, kUnroll block steps at a time.
__global__ void __launch_bounds__(kThreads)
    write_s_kernel(const float4* __restrict__ dout,
                   const int32_t* __restrict__ inv, float4* __restrict__ s,
                   int64_t slots, int co4) {
  const int per_step = kThreads / co4;  // rows a block step
  const int r = threadIdx.x / co4;
  const int q = threadIdx.x - r * co4;
  if (r >= per_step) return;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * per_step;
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * per_step + r;
       first < slots; first += kUnroll * stride) {
    int src[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t slot = first + u * stride;
      src[u] = slot < slots ? inv[slot] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t slot = first + u * stride;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src[u] >= 0) {
        v = dout[static_cast<int64_t>(src[u]) * co4 + q];
        v = make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                        bf16_round(v.w));
      }
      if (slot < slots) __stcs(s + slot * co4 + q, v);
    }
  }
}

bool bad_args(int b, int n, int m, int k, int c, int co) {
  return b < 0 || n <= 0 || m < 0 || k <= 0 || k > kMaxTaps || c <= 0 ||
         c > kMaxCin || co <= 0 || co > kMaxCout || c * co > kMaxW ||
         static_cast<int64_t>(b) * n > 0x7fffffff ||
         static_cast<int64_t>(b) * m > 0x7fffffff;
}

}  // namespace

// feats (b, n, c) f32; keys (b, n) int32 sorted per sample, INVALID_KEY
// padded; nkeys (b, m, k) int32; weights (k, c, co) f32 → out (b, m, co);
// rb (b, m, k) int32 per-sample input rows, -1 = none (nullptr = not
// wanted): the rulebook the backward reads. fr, wr: scratch for the
// rounded operands, b * n * C4 and k * C4 * Co4 floats (C, Co up to
// multiples of 4; ops/cuda/key_conv.rounded_shapes); rows: output rows
// per block (ops/cuda/window_key_conv.tile_rows(k, C4, Co4)).
DM_EXPORT int dm_key_conv_fwd(const float* feats, const int32_t* keys,
                              const int32_t* nkeys, const float* weights,
                              float* fr, float* wr, float* out, int32_t* rb,
                              int b, int n, int m, int k, int c, int co,
                              int rows, cudaStream_t stream) {
  if (bad_args(b, n, m, k, c, co)) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(b) * m == 0) return cudaSuccess;
  const int c4 = (c + 3) / 4 * 4;
  const int co4 = (co + 3) / 4 * 4;
  const cudaError_t err = dm::gemm::launch_pad_operands<true>(
      feats, weights, fr, wr, static_cast<int64_t>(b) * n, k, c, co, c4,
      co4, stream);
  if (err != cudaSuccess) return err;
  return dm::gemm::launch_gather_gemm<true>(fr, keys, nkeys, wr, out, rb, b,
                                            n, m, k, c4, co4, rows, stream,
                                            co);
}

// dout (b, m, co) f32 and rb (b, m, k) int32, the forward's rulebook →
// s (k, b * n, co) f32; inv: scratch of k * b * n int32. co must be a
// multiple of 4 (S is written as float4).
DM_EXPORT int dm_key_conv_bwd_scatter(const float* dout, const int32_t* rb,
                                      int32_t* inv, float* s, int b, int n,
                                      int m, int k, int co,
                                      cudaStream_t stream) {
  if (bad_args(b, n, m, k, 1, co) || co % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t slots = static_cast<int64_t>(k) * b * n;
  if (slots == 0) return cudaSuccess;
  cudaError_t err = cudaMemsetAsync(
      inv, 0xff, static_cast<size_t>(slots) * sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(b) * m;
  if (rows > 0) {
    invert_rulebook_kernel<<<static_cast<unsigned>(
                                 (rows + kThreads - 1) / kThreads),
                             kThreads, 0, stream>>>(rb, inv, b, n, m, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int co4 = co / 4;
  const int per_step = kThreads / co4;
  const int64_t steps = (slots + per_step - 1) / per_step;
  const int64_t blocks = (steps + kUnroll - 1) / kUnroll;
  write_s_kernel<<<static_cast<unsigned>(blocks < 132 * 64 ? blocks
                                                             : 132 * 64),
                   kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(dout), inv,
      reinterpret_cast<float4*>(s), slots, co4);
  return cudaGetLastError();
}
