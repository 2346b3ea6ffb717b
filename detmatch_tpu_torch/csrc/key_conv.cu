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
// The forward is the TPU kernel's function but for the order of the fp32
// sums: keys are unique within a sample, so a tap matches at most one
// row; a product of two bf16 numbers is exact in fp32; the forward
// therefore sums the same exact products. S is the one-hot sum of the TPU
// kernel in a stated order: S[k, b * n + row] is the fp32 sum, from +0,
// of bf16(dout[b, m]) over every output row b * m' + m whose tap k reads
// `row`, in ascending b * m' + m. For any conv geometry (submanifold,
// strided, z-compressing) an input row and a tap fix at most one output
// row, so on every conv each S row has at most one writer; a rulebook
// that repeats one (the public op's input may) gets every writer summed.
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
// resolved and wrote (rb_out), so nothing is searched again, in three
// launches with no host synchronisation:
// 1. claim: an inverse map inv[k, b * n + row] (1/Co of S's bytes),
//    filled with kUnclaimed, takes for each slot the smallest output row
//    b * m + m' whose tap k reads it (integer atomicMin, one thread an
//    output row over its taps); a claim that finds the slot already
//    taken sets the repeat flag behind the map (a second writer);
// 2. write: one streaming pass writes every row of S, 0 + bf16(dout[inv])
//    or zeros, 16 bytes a thread where Co and dout allow (else 4), rows
//    consecutive across a block (coalesced stores, no separate zero
//    fill): S for every slot with one writer, and each repeated slot's
//    first term;
// 3. repeats: always launched, it returns at once unless the flag is
//    set (every model call: no conv repeats a slot). Then one warp a
//    (sample, tap) column walks the rulebook's rows ascending and adds
//    each later writer's bf16(dout) row to its slot, in that order.
// No float atomics, every order fixed: deterministic on any rulebook.
#include "gather_gemm.cuh"

namespace {

using dm::gemm::bf16_round;

constexpr int kThreads = 256;
constexpr int kMaxTaps = 27;
constexpr int kMaxCin = 128;
constexpr int kMaxCout = 128;
constexpr int kMaxW = 16384;  // C * Co floats per tap
constexpr int kUnroll = 4;    // S rows a thread has in flight
// the inverse map's fill (every byte 0x7f): no writer yet; above any
// output row the wrapper admits. The repeat flag behind the map starts
// so too and is kRepeat once a slot has a second writer.
constexpr int32_t kUnclaimed = 0x7f7f7f7f;
constexpr int32_t kRepeat = 1;

// inv[tap * b * n + bi * n + rb[row, tap]] = the smallest output row
// whose tap reads that input row (one thread an output row, over its
// taps); a claim that finds the slot taken sets *flag.
__global__ void __launch_bounds__(kThreads)
    invert_rulebook_kernel(const int32_t* __restrict__ rb,
                           int32_t* __restrict__ inv,
                           int32_t* __restrict__ flag, int b, int n, int m,
                           int k) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (row >= static_cast<int64_t>(b) * m) return;
  const int64_t base = row / m * n;  // bi * n
  const int64_t slab = static_cast<int64_t>(b) * n;
  for (int tap = 0; tap < k; ++tap) {
    const int32_t v = rb[row * k + tap];
    if (v >= 0 && v < n &&
        atomicMin(inv + tap * slab + base + v, static_cast<int32_t>(row)) !=
            kUnclaimed) {
      *flag = kRepeat;
    }
  }
}

// V consecutive floats of dout rounded to bf16 and added to +0, or zeros.
template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load_round(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else {
    r.v[0] = __ldg(p);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) r.v[i] = __fadd_rn(0.f, bf16_round(r.v[i]));
  return r;
}

// S row `slot` (co floats, groups = co / V pieces) = 0 + bf16(dout[inv])
// or zeros. A block step covers kThreads / groups consecutive rows, a
// thread one piece of a row, kUnroll block steps at a time.
template <int V>
__global__ void __launch_bounds__(kThreads)
    write_s_kernel(const float* __restrict__ dout,
                   const int32_t* __restrict__ inv, float* __restrict__ s,
                   int64_t slots, int co) {
  const int groups = co / V;
  const int per_step = kThreads / groups;  // rows a block step
  const int r = threadIdx.x / groups;
  const int q = (threadIdx.x - r * groups) * V;
  if (r >= per_step) return;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * per_step;
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * per_step + r;
       first < slots; first += kUnroll * stride) {
    int32_t src[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t slot = first + u * stride;
      src[u] = slot < slots ? inv[slot] : kUnclaimed;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t slot = first + u * stride;
      Vec<V> v;
      if (src[u] != kUnclaimed) {
        v = load_round<V>(dout + static_cast<int64_t>(src[u]) * co + q);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v.v[i] = 0.f;
      }
      if (slot < slots) {
        float* dst = s + slot * co + q;
        if constexpr (V == 4) {
          __stcs(reinterpret_cast<float4*>(dst),
                 make_float4(v.v[0], v.v[1], v.v[2], v.v[3]));
        } else {
          __stcs(dst, v.v[0]);
        }
      }
    }
  }
}

// Returns unless *flag is kRepeat. Warp w walks column (bi, tap) = (w / k,
// w % k) of the rulebook, 32 output rows a step, ascending; an entry
// whose slot another (smaller) row claimed is a later writer, and the
// warp adds its bf16(dout) row to that slot's S row, lanes over the
// channels, in ascending row order (each channel stays with one lane, so
// the adds to a slot run in program order).
__global__ void __launch_bounds__(kThreads)
    repeat_sums_kernel(const float* __restrict__ dout,
                       const int32_t* __restrict__ rb,
                       const int32_t* __restrict__ inv,
                       const int32_t* __restrict__ flag,
                       float* __restrict__ s, int b, int n, int m, int k,
                       int co) {
  if (*flag != kRepeat) return;
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                    (threadIdx.x >> 5);
  if (w >= static_cast<int64_t>(b) * k) return;
  const int bi = static_cast<int>(w / k);
  const int tap = static_cast<int>(w - static_cast<int64_t>(bi) * k);
  const int64_t slab = static_cast<int64_t>(b) * n;
  for (int m0 = 0; m0 < m; m0 += 32) {
    const int mm = m0 + lane;
    const int64_t row = static_cast<int64_t>(bi) * m + mm;
    int64_t slot = 0;
    bool later = false;
    if (mm < m) {
      const int32_t v = rb[row * k + tap];
      if (v >= 0 && v < n) {
        slot = tap * slab + static_cast<int64_t>(bi) * n + v;
        later = inv[slot] != static_cast<int32_t>(row);
      }
    }
    unsigned ballot = __ballot_sync(0xffffffffu, later);
    while (ballot != 0u) {
      const int j = __ffs(ballot) - 1;
      ballot &= ballot - 1u;
      const int64_t src = __shfl_sync(0xffffffffu, row, j);
      const int64_t dst = __shfl_sync(0xffffffffu, slot, j);
      for (int c = lane; c < co; c += 32) {
        s[dst * co + c] += bf16_round(dout[src * co + c]);
      }
    }
  }
}

bool bad_args(int b, int n, int m, int k, int c, int co) {
  return b < 0 || n <= 0 || m < 0 || k <= 0 || k > kMaxTaps || c <= 0 ||
         c > kMaxCin || co <= 0 || co > kMaxCout || c * co > kMaxW ||
         static_cast<int64_t>(b) * n > 0x7fffffff ||
         static_cast<int64_t>(b) * m >= kUnclaimed;
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
// s (k, b * n, co) f32; inv: scratch of k * b * n + 1 int32 (the map,
// then the repeat flag). Any co up to kMaxCout: 16-byte pieces where co
// is a multiple of 4 and dout starts on 16 bytes, 4-byte ones else.
DM_EXPORT int dm_key_conv_bwd_scatter(const float* dout, const int32_t* rb,
                                      int32_t* inv, float* s, int b, int n,
                                      int m, int k, int co,
                                      cudaStream_t stream) {
  if (bad_args(b, n, m, k, 1, co)) return cudaErrorInvalidValue;
  const int64_t slots = static_cast<int64_t>(k) * b * n;
  if (slots == 0) return cudaSuccess;
  int32_t* flag = inv + slots;
  cudaError_t err = cudaMemsetAsync(
      inv, 0x7f, static_cast<size_t>(slots + 1) * sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(b) * m;
  if (rows > 0) {
    invert_rulebook_kernel<<<static_cast<unsigned>(
                                 (rows + kThreads - 1) / kThreads),
                             kThreads, 0, stream>>>(rb, inv, flag, b, n, m,
                                                    k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const bool vec4 = co % 4 == 0 && reinterpret_cast<uintptr_t>(dout) % 16 == 0
                    && reinterpret_cast<uintptr_t>(s) % 16 == 0;
  const int per_step = kThreads / (vec4 ? co / 4 : co);
  const int64_t steps = (slots + per_step - 1) / per_step;
  const int64_t want = (steps + kUnroll - 1) / kUnroll;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 64 ? want
                                                                : 132 * 64);
  if (vec4) {
    write_s_kernel<4><<<blocks, kThreads, 0, stream>>>(dout, inv, s, slots,
                                                       co);
  } else {
    write_s_kernel<1><<<blocks, kThreads, 0, stream>>>(dout, inv, s, slots,
                                                       co);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || rows == 0) return err;
  const int64_t warps = static_cast<int64_t>(b) * k;
  repeat_sums_kernel<<<static_cast<unsigned>(
                           (warps + kThreads / 32 - 1) / (kThreads / 32)),
                       kThreads, 0, stream>>>(dout, rb, inv, flag, s, b, n,
                                              m, k, co);
  return cudaGetLastError();
}
