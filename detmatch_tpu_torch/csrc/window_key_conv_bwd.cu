// Sparse 3D convolution backward over sorted int32 voxel keys (K1 bwd):
// the gradients of csrc/window_key_conv.cu's
// out[b, m] = sum_k F[b, rb(b,m,k)] . W_k,
//   dW_k     = sum_{b,m} F[b, rb(b,m,k)]^T . dout[b, m]
//   dF[b, n] = sum_k dout[b, inv(b,n,k)] . W_k^T
// where rb is the rulebook that the forward resolved and wrote (per-sample
// input rows, -1 = none) and inv(b,n,k) is the output row whose tap k
// reads input row n.
//
// Replaces the TPU kernel detmatch_tpu/ops/pallas/window_key_conv.py:
// _bwd_fused (_bwd_kernel, pallas_call at :334). That kernel builds, per
// 512-row key tile, the transposed one-hot match S_k of every output row
// in a window against the tile's keys, on the VPU, keeps it in VMEM
// scratch and contracts dF = sum_k S_k W_k^T and dW_k += F^T S_k on the MXU
// in bf16. Gathers are cheap on this card, so nothing of that is kept:
// both gradients are gathers plus fp32 products over the forward's
// rulebook, with no key search.
//
// What bounds it on the H100: the fp32 FMAs of the matched pairs, one
// per (pair, C, Co) for dW and again for dF. No pass does arithmetic on a
// row or a tap without a matched pair.
//
// Any C and Co: where C or Co is not a multiple of 4, or feats or dout
// does not start on 16 bytes, the wrapper passes scratch that a prologue
// fills with zero-padded copies (fp (b * n, C4), dp (b * m, Co4); K7's
// pad_operands_kernel); dW is summed at C4 x Co4 and its C x Co corner
// written, dF's tile stores C of its C4 columns. Zero pads change no bit.
//
// Passes, all fp32, none with float atomics, every result written once
// (the repeat pass aside, which rewrites its rows in a fixed order), so
// every result is deterministic:
// 1. pair_count: one thread per output row, over the taps. Claims
//    inv[b, rb, k] for the smallest output row m whose tap k reads input
//    row rb (integer atomicMin on a map the caller fills with
//    kUnclaimed; a claim that finds the slot taken sets the repeat flag:
//    a second writer, which no conv has, as an input row and a tap fix at
//    most one output row) and writes each 256-row chunk's pair count per
//    tap.
// 2. pair_scan: one block, exclusive prefix sums of the counts, tap-major,
//    and each tap's first pair.
// 3. pair_fill: the per-tap lists of matched pairs as output rows, in
//    ascending (sample, output row) order (ballots within a chunk);
//    repeats included, so dW sums every writer.
// 4. dW: block (j, k, g) takes pairs [j * kPairChunk, (j + 1) *
//    kPairChunk) of tap k's list and output columns [gw g, gw (g + 1)),
//    gw = Co4, or 16 where K x chunks is too few blocks to fill the card
//    (the 3-tap conv), or at most 8192 / C4 (C4 * gw / 16 micro-tiles, two
//    a thread), the last group ragged; stages 32 pairs at a time
//    (F rows and dout row pieces, cp.async, two stages) and sums
//    F^T . dout from 0 by 4 x 4 register micro-tiles over (ci, oc), pairs
//    ascending. Where the block's C4 * gw / 16 micro-tiles are fewer than
//    its threads, S = 256 / tiles slices take every S-th pair and their
//    sums are added slice 0 first. One partial per chunk; a second pass
//    adds the chunks of a tap from 0, ascending.
// 5. dF: the forward's gather-GEMM tile (csrc/gather_gemm.cuh) in map
//    mode on inv, with W_k^T staged as (Co4, C4): per element, fmaf from
//    +0 over the taps ascending, then the output channels ascending.
// 6. repeats: always launched, it returns at once unless the flag is set
//    (every model call). Then one block a sample marks the input rows
//    with a repeated (row, tap) slot and recomputes their dF rows in the
//    tile's order extended to every writer: fmaf from +0 over the taps
//    ascending, within a tap over its writers by ascending output row
//    (the pair lists' order), then the output channels ascending.
#include "gather_gemm.cuh"

namespace {

using dm::gemm::cp_async16;
using dm::gemm::cp_async_commit;
using dm::gemm::cp_async_wait;

constexpr int kThreads = 256;     // also the rows of a counting chunk
constexpr int kPairChunk = 2048;  // ops/cuda/window_key_conv.PAIR_CHUNK
constexpr int kTilePairs = 32;    // pairs per staged dW tile
constexpr int kFewDwBlocks = 528;  // 4 blocks for each of the 132 SMs
constexpr int kMaxTaps = 27;
constexpr int kMaxCin = 128;
constexpr int kMaxCout = 128;
constexpr int kMaxW = 16384;  // C * Co floats per tap
constexpr int kMaxDwFloats = 8192;  // C4 * gw: two micro-tiles a thread
// the inverse map's fill (every byte 0x7f): no writer yet, and no output
// row (the wrapper keeps M below it); the repeat flag behind the map
// starts so too and is kRepeat once a slot has a second writer
constexpr int32_t kUnclaimed = 0x7f7f7f7f;
constexpr int32_t kRepeat = 1;

__global__ void __launch_bounds__(kThreads)
    pair_count_kernel(const int32_t* __restrict__ rb,
                      int32_t* __restrict__ inv,
                      int32_t* __restrict__ flag,
                      int32_t* __restrict__ counts, int b, int n, int m,
                      int k, int n_rc) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool valid = row < static_cast<int64_t>(b) * m;
  const int bi = valid ? static_cast<int>(row / m) : 0;
  const int mm = valid ? static_cast<int>(row - static_cast<int64_t>(bi) * m)
                       : 0;
  for (int tap = 0; tap < k; ++tap) {
    const int v = valid ? rb[row * k + tap] : -1;
    const bool has = v >= 0 && v < n;
    if (has && inv != nullptr &&
        atomicMin(inv + (static_cast<int64_t>(bi) * n + v) * k + tap, mm) !=
            kUnclaimed) {
      *flag = kRepeat;
    }
    const int cnt = __syncthreads_count(has);
    if (threadIdx.x == 0) counts[tap * n_rc + blockIdx.x] = cnt;
  }
}

// One block of 1,024 threads: offsets = exclusive scan of counts (k *
// n_rc, tap-major); tap_start[tap] = first pair of the tap, [k] = total.
__global__ void __launch_bounds__(1024)
    pair_scan_kernel(const int32_t* __restrict__ counts,
                     int32_t* __restrict__ offsets,
                     int32_t* __restrict__ tap_start, int k, int n_rc) {
  __shared__ int s_sum[1024];
  const int t = threadIdx.x;
  const int total = k * n_rc;
  const int per = (total + 1023) / 1024;
  const int lo = min(t * per, total);
  const int hi = min(lo + per, total);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += counts[i];
  s_sum[t] = local;
  __syncthreads();
  for (int d = 1; d < 1024; d <<= 1) {  // inclusive Hillis-Steele scan
    const int add = t >= d ? s_sum[t - d] : 0;
    __syncthreads();
    s_sum[t] += add;
    __syncthreads();
  }
  int run = s_sum[t] - local;
  for (int i = lo; i < hi; ++i) {
    offsets[i] = run;
    if (i % n_rc == 0) tap_start[i / n_rc] = run;
    run += counts[i];
  }
  if (t == 1023) tap_start[k] = s_sum[1023];
}

__global__ void __launch_bounds__(kThreads)
    pair_fill_kernel(const int32_t* __restrict__ rb,
                     const int32_t* __restrict__ offsets,
                     int32_t* __restrict__ pairs, int b, int n, int m, int k,
                     int n_rc) {
  __shared__ int s_warp[kThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + t;
  const bool valid = row < static_cast<int64_t>(b) * m;
  for (int tap = 0; tap < k; ++tap) {
    const int v = valid ? rb[row * k + tap] : -1;
    const bool has = v >= 0 && v < n;
    const unsigned ballot = __ballot_sync(0xffffffffu, has);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    if (has) {
      int at = offsets[tap * n_rc + blockIdx.x] +
               __popc(ballot & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) at += s_warp[w];
      pairs[at] = static_cast<int32_t>(row);
    }
    __syncthreads();
  }
}

// grid (max_chunks, k, ceil(co / gw)): block (j, tap, g) writes columns
// [g * gw, min((g + 1) * gw, co)) of partial[tap, j] (c x co) if tap k's
// list has a j-th chunk (c, co: the padded widths, multiples of 4; feats
// and dout rows of c and co floats). At most 80 registers, so that three
// blocks share an SM and the 27-tap convs' chunks run in one wave.
__global__ void __launch_bounds__(kThreads, 3)
    dweight_partial_kernel(const float* __restrict__ feats,
                           const float* __restrict__ dout,
                           const int32_t* __restrict__ rb,
                           const int32_t* __restrict__ pairs,
                           const int32_t* __restrict__ tap_start,
                           float* __restrict__ partial, int n, int m, int k,
                           int c, int co, int gw, int max_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int col0 = blockIdx.z * gw;
  gw = min(gw, co - col0);  // the last group may be narrower
  float* s_f[2];
  float* s_d[2];
  s_f[0] = reinterpret_cast<float*>(smem);
  s_d[0] = s_f[0] + kTilePairs * c;
  s_f[1] = s_d[0] + kTilePairs * gw;
  s_d[1] = s_f[1] + kTilePairs * c;

  const int t = threadIdx.x;
  const int tap = blockIdx.y;
  const int start = tap_start[tap] + blockIdx.x * kPairChunk;
  const int end = min(start + kPairChunk, tap_start[tap + 1]);
  if (start >= end) return;

  const int c4 = c / 4;
  const int g4 = gw / 4;
  const int units = c4 * g4;  // 4 x 4 micro-tiles of the c x gw columns
  const int slices = units >= kThreads ? 1 : kThreads / units;
  const int slice = units >= kThreads ? 0 : t / units;
  const bool active = units >= kThreads || t < slices * units;
  const int unit0 = units >= kThreads ? t : t - slice * units;
  const int mine = active ? (units - unit0 + kThreads - 1) / kThreads : 0;

  float4 acc[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[s][a] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  auto issue = [&](int stage, int p0) {
    const int np = min(kTilePairs, end - p0);
    for (int e = t; e < np * c4; e += kThreads) {
      const int p = e / c4;
      const int q = e - p * c4;
      const int row = pairs[p0 + p];
      const int src = (row / m) * n + rb[static_cast<int64_t>(row) * k + tap];
      cp_async16(s_f[stage] + p * c + q * 4,
                 feats + static_cast<size_t>(src) * c + q * 4);
    }
    for (int e = t; e < np * g4; e += kThreads) {
      const int p = e / g4;
      const int q = e - p * g4;
      const int row = pairs[p0 + p];
      cp_async16(s_d[stage] + p * gw + q * 4,
                 dout + static_cast<size_t>(row) * co + col0 + q * 4);
    }
  };

  const int n_tiles = (end - start + kTilePairs - 1) / kTilePairs;
  issue(0, start);
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    const int p0 = start + i * kTilePairs;
    if (i + 1 < n_tiles) issue((i + 1) & 1, p0 + kTilePairs);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int np = min(kTilePairs, end - p0);
    const float* sf = s_f[i & 1];
    const float* sd = s_d[i & 1];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s < mine) {
        const int u = unit0 + s * kThreads;
        const int ci0 = (u / g4) * 4;
        const int oc0 = (u - (u / g4) * g4) * 4;
        for (int p = slice; p < np; p += slices) {
          const float4 f = *reinterpret_cast<const float4*>(sf + p * c + ci0);
          const float4 d =
              *reinterpret_cast<const float4*>(sd + p * gw + oc0);
          dm::gemm::fma4(acc[s][0], f.x, d);
          dm::gemm::fma4(acc[s][1], f.y, d);
          dm::gemm::fma4(acc[s][2], f.z, d);
          dm::gemm::fma4(acc[s][3], f.w, d);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  const int cw = c * co;
  float* out = partial +
               (static_cast<size_t>(tap) * max_chunks + blockIdx.x) * cw +
               col0;
  float* red = reinterpret_cast<float*>(smem);  // (slices, c, gw)
  const int cg = c * gw;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < mine) {
      const int u = unit0 + s * kThreads;
      const int ci0 = (u / g4) * 4;
      const int oc0 = (u - (u / g4) * g4) * 4;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (slices == 1) {
          *reinterpret_cast<float4*>(out + (ci0 + a) * co + oc0) = acc[s][a];
        } else {
          *reinterpret_cast<float4*>(red + slice * cg + (ci0 + a) * gw +
                                     oc0) = acc[s][a];
        }
      }
    }
  }
  if (slices == 1) return;
  __syncthreads();
  for (int e = t; e < cg; e += kThreads) {
    float v = 0.f;
    for (int s = 0; s < slices; ++s) v += red[s * cg + e];
    const int ci = e / gw;
    out[ci * co + (e - ci * gw)] = v;
  }
}

// dw[tap, ci, oc] = sum over tap's chunks j ascending of partial[tap, j,
// ci, oc], partial's rows c4 x co4 wide (the padded widths).
__global__ void __launch_bounds__(kThreads)
    dweight_reduce_kernel(const float* __restrict__ partial,
                          const int32_t* __restrict__ tap_start,
                          float* __restrict__ dw, int k, int c, int co,
                          int c4, int co4, int max_chunks) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int cw = c * co;
  if (i >= k * cw) return;
  const int tap = i / cw;
  const int ci = (i - tap * cw) / co;
  const int oc = i - tap * cw - ci * co;
  const int cw4 = c4 * co4;
  const int cnt = tap_start[tap + 1] - tap_start[tap];
  const int chunks = (cnt + kPairChunk - 1) / kPairChunk;
  const float* p = partial + static_cast<size_t>(tap) * max_chunks * cw4 +
                   ci * co4 + oc;
  float s = 0.f;
  for (int j = 0; j < chunks; ++j) s += p[static_cast<size_t>(j) * cw4];
  dw[i] = s;
}

// wt[tap, oc, ci] = w[tap, ci, oc] over (k, co4, c4), zeros in the pads
__global__ void __launch_bounds__(kThreads)
    transpose_taps_kernel(const float* __restrict__ w,
                          float* __restrict__ wt, int k, int c, int co,
                          int c4, int co4) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= k * co4 * c4) return;
  const int tap = i / (co4 * c4);
  const int e = i - tap * co4 * c4;
  const int oc = e / c4;
  const int ci = e - oc * c4;
  wt[i] = ci < c && oc < co
              ? w[(static_cast<size_t>(tap) * c + ci) * co + oc]
              : 0.f;
}

// Returns unless *flag is kRepeat. Block bi owns sample bi: it marks in
// dirty[bi] the input rows with a (row, tap) slot that an output row
// besides its claimant reads, zeroes their dF rows, then recomputes
// them: warp w of the 8 takes the dirty rows r with r % 8 == w and walks
// the taps ascending, each tap's pairs of the sample ascending (its piece
// of the pair list), and for each pair that reads one of its rows adds,
// for each input channel (lanes), fmaf(dout[row, oc], wt[tap, oc, ci], .)
// over oc ascending: the tile's order with every writer of a tap in
// place of the one it keeps. dout rows of co4 floats; dF rows of c.
__global__ void __launch_bounds__(kThreads)
    repeat_rows_kernel(const float* __restrict__ dout,
                       const float* __restrict__ wt,
                       const int32_t* __restrict__ rb,
                       const int32_t* __restrict__ pairs,
                       const int32_t* __restrict__ tap_start,
                       const int32_t* __restrict__ inv,
                       const int32_t* __restrict__ flag,
                       int32_t* __restrict__ dirty, float* __restrict__ dfeats,
                       int n, int m, int k, int c, int c4, int co4) {
  if (*flag != kRepeat) return;
  const int t = threadIdx.x;
  const int bi = blockIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t first_row = static_cast<int64_t>(bi) * m;
  int32_t* mark = dirty + static_cast<int64_t>(bi) * n;
  float* df = dfeats + static_cast<int64_t>(bi) * n * c;
  for (int i = t; i < n; i += kThreads) mark[i] = 0;
  __syncthreads();
  // this sample's piece [lo, hi) of a tap's pair list (rows ascending)
  auto piece = [&](int tap, int& lo, int& hi) {
    const int a = tap_start[tap];
    const int z = tap_start[tap + 1];
    int l = a, h = z;
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (pairs[mid] < first_row) l = mid + 1; else h = mid;
    }
    lo = l;
    h = z;
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (pairs[mid] < first_row + m) l = mid + 1; else h = mid;
    }
    hi = l;
  };
  for (int tap = 0; tap < k; ++tap) {
    int lo, hi;
    piece(tap, lo, hi);
    for (int p = lo + t; p < hi; p += kThreads) {
      const int row = pairs[p];
      const int v = rb[static_cast<int64_t>(row) * k + tap];
      if (inv[(static_cast<int64_t>(bi) * n + v) * k + tap] !=
          static_cast<int32_t>(row - first_row)) {
        mark[v] = 1;
      }
    }
  }
  __syncthreads();
  for (int64_t e = t; e < static_cast<int64_t>(n) * c; e += kThreads) {
    if (mark[e / c]) df[e] = 0.f;
  }
  __syncthreads();
  for (int tap = 0; tap < k; ++tap) {
    int lo, hi;
    piece(tap, lo, hi);
    const float* wk = wt + static_cast<size_t>(tap) * co4 * c4;
    for (int p0 = lo; p0 < hi; p0 += 32) {
      const int p = p0 + lane;
      int row = 0, v = 0;
      bool mine = false;
      if (p < hi) {
        row = pairs[p];
        v = rb[static_cast<int64_t>(row) * k + tap];
        mine = v % (kThreads / 32) == warp && mark[v] != 0;
      }
      unsigned ballot = __ballot_sync(0xffffffffu, mine);
      while (ballot != 0u) {
        const int j = __ffs(ballot) - 1;
        ballot &= ballot - 1u;
        const int r = __shfl_sync(0xffffffffu, row, j);
        const int x = __shfl_sync(0xffffffffu, v, j);
        const float* d = dout + static_cast<int64_t>(r) * co4;
        for (int ci = lane; ci < c; ci += 32) {
          float a = df[static_cast<int64_t>(x) * c + ci];
          for (int oc = 0; oc < co4; ++oc) {
            a = fmaf(d[oc], wk[oc * c4 + ci], a);
          }
          df[static_cast<int64_t>(x) * c + ci] = a;
        }
      }
    }
  }
}

// Columns of dout a dW block takes: all of them, or 16 where the taps'
// chunks alone could not fill the card (k * max_chunks below
// kFewDwBlocks, e.g. the 3-tap z-compressing conv) and 16 divides Co4;
// at most kMaxDwFloats / C4, so that a thread holds at most two 4 x 4
// micro-tiles (C4 = 128: 64 columns a group). Splitting the columns
// gathers each F row once per group: at 27 taps it made the wide convs
// slower (tools/port_probes/k1_tiles.py).
int dw_group(int c4, int co4, int k, int max_chunks) {
  const int gw = co4 % 16 == 0 && k * max_chunks < kFewDwBlocks ? 16 : co4;
  const int most = kMaxDwFloats / c4 / 4 * 4;
  return gw < most ? gw : most;
}

int64_t dw_smem_bytes(int c, int gw) {
  const int64_t stages = 2LL * kTilePairs * (c + gw) * 4;
  const int64_t red = 4LL * kThreads * 16;  // slices * c * gw <= 16 * 256
  return stages > red ? stages : red;
}

// Int32 workspace of the backward (mirrored by
// ops/cuda/window_key_conv.bwd_workspace): counts and offsets (k * n_rc
// each, n_rc = ceil(b * m / 256)), tap_start (32), pairs (b * m * k) and,
// if dfeats is wanted, inv (b * n * k), the repeat flag (1) and the
// repeat pass's row marks (b * n).
int64_t bwd_workspace(int b, int n, int m, int k, bool dfeats) {
  const int64_t n_rc = (static_cast<int64_t>(b) * m + kThreads - 1) /
                       kThreads;
  return 2 * k * n_rc + 32 + static_cast<int64_t>(b) * m * k +
         (dfeats ? static_cast<int64_t>(b) * n * (k + 1) + 1 : 0);
}

}  // namespace

// feats (b, n, c) f32; rb (b, m, k) int32 from the forward; weights
// (k, c, co) f32; dout (b, m, co) f32. Scratch from the caller: ws, int32,
// of bwd_workspace(...) entries; partial (k, max_chunks, C4, Co4) f32 with
// max_chunks = max(1, ceil(b * m / kPairChunk)); wt (k, Co4, C4) f32 if
// dfeats is wanted; fp (b * n, C4) and dp (b * m, Co4) f32, the padded
// copies of feats and dout, or nullptr where C (Co) is a multiple of 4
// and feats (dout) starts on 16 bytes (ops/cuda/window_key_conv.
// needs_pad). C4, Co4: C, Co up to multiples of 4. Outputs: dfeats
// (b, n, c) (nullptr = not wanted; then wt may be nullptr), dw (k, c, co).
// rows: input rows per block of the dF tile (tile_rows(k, Co4, C4)).
DM_EXPORT int dm_window_key_conv_bwd(
    const float* feats, const int32_t* rb, const float* weights,
    const float* dout, int32_t* ws, int64_t ws_len, float* partial,
    float* wt, float* fp, float* dp, float* dfeats, float* dw, int b, int n,
    int m, int k, int c, int co, int rows, int max_chunks,
    cudaStream_t stream) {
  const int c4 = (c + 3) / 4 * 4;
  const int co4 = (co + 3) / 4 * 4;
  if (b < 0 || n <= 0 || m < 0 || m >= kUnclaimed || k <= 0 ||
      k > kMaxTaps || c <= 0 || c > kMaxCin || co <= 0 || co > kMaxCout ||
      c * co > kMaxW || (dfeats != nullptr && wt == nullptr) ||
      ws_len != bwd_workspace(b, n, m, k, dfeats != nullptr) ||
      (dfeats != nullptr && !dm::gemm::tile_ok(rows, k, co4, c4)) ||
      (fp == nullptr && (c != c4 || !dm::aligned16(feats))) ||
      (dp == nullptr && (co != co4 || !dm::aligned16(dout)))) {
    return cudaErrorInvalidValue;
  }
  const int64_t out_rows = static_cast<int64_t>(b) * m;
  const int64_t in_rows = static_cast<int64_t>(b) * n;
  const int64_t need_chunks = (out_rows + kPairChunk - 1) / kPairChunk;
  if (in_rows * c4 > 0x7fffffff || out_rows * k > 0x7fffffff ||
      static_cast<int64_t>(b) * n * k > 0x7fffffff ||
      max_chunks != (need_chunks > 1 ? need_chunks : 1)) {
    return cudaErrorInvalidValue;
  }
  const int cw = c * co;
  cudaError_t err;
  if (out_rows == 0) {  // no pairs: zero gradients
    err = cudaMemsetAsync(dw, 0, sizeof(float) * k * cw, stream);
    if (err == cudaSuccess && dfeats != nullptr) {
      err = cudaMemsetAsync(dfeats, 0, sizeof(float) * in_rows * c, stream);
    }
    return err;
  }
  if (fp != nullptr) {
    err = dm::gemm::launch_pad_operands<false>(feats, nullptr, fp, nullptr,
                                               in_rows, 0, c, 4, c4, 4,
                                               stream);
    if (err != cudaSuccess) return err;
    feats = fp;
  }
  if (dp != nullptr) {
    err = dm::gemm::launch_pad_operands<false>(dout, nullptr, dp, nullptr,
                                               out_rows, 0, co, 4, co4, 4,
                                               stream);
    if (err != cudaSuccess) return err;
    dout = dp;
  }
  const int n_rc = static_cast<int>((out_rows + kThreads - 1) / kThreads);
  int32_t* counts = ws;
  int32_t* offsets = counts + static_cast<int64_t>(k) * n_rc;
  int32_t* tap_start = offsets + static_cast<int64_t>(k) * n_rc;
  int32_t* pairs = tap_start + 32;
  int32_t* inv = dfeats != nullptr ? pairs + out_rows * k : nullptr;
  int32_t* flag = inv != nullptr ? inv + in_rows * k : nullptr;
  if (inv != nullptr) {  // the map and the flag: kUnclaimed
    err = cudaMemsetAsync(inv, 0x7f, sizeof(int32_t) * (in_rows * k + 1),
                          stream);
    if (err != cudaSuccess) return err;
  }
  pair_count_kernel<<<n_rc, kThreads, 0, stream>>>(rb, inv, flag, counts, b,
                                                   n, m, k, n_rc);
  pair_scan_kernel<<<1, 1024, 0, stream>>>(counts, offsets, tap_start, k,
                                           n_rc);
  pair_fill_kernel<<<n_rc, kThreads, 0, stream>>>(rb, offsets, pairs, b, n,
                                                  m, k, n_rc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  static bool attr_set = false;
  if (!attr_set) {
    err = cudaFuncSetAttribute(dweight_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dm::gemm::kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int gw = dw_group(c4, co4, k, max_chunks);
  dweight_partial_kernel<<<dim3(static_cast<unsigned>(max_chunks),
                                static_cast<unsigned>(k),
                                static_cast<unsigned>((co4 + gw - 1) / gw)),
                           kThreads, static_cast<size_t>(dw_smem_bytes(c4,
                                                                       gw)),
                           stream>>>(feats, dout, rb, pairs, tap_start,
                                     partial, n, m, k, c4, co4, gw,
                                     max_chunks);
  dweight_reduce_kernel<<<(k * cw + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(partial, tap_start, dw, k, c, co, c4, co4,
                                    max_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess || dfeats == nullptr) return err;

  const int cw4 = c4 * co4;
  transpose_taps_kernel<<<(k * cw4 + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(weights, wt, k, c, co, c4, co4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = dm::gemm::launch_gather_gemm<false>(dout, nullptr, inv, wt, dfeats,
                                            nullptr, b, m, n, k, co4, c4,
                                            rows, stream, c);
  if (err != cudaSuccess) return err;
  repeat_rows_kernel<<<b, kThreads, 0, stream>>>(
      dout, wt, rb, pairs, tap_start, inv, flag, flag + 1, dfeats, n, m, k,
      c, c4, co4);
  return cudaGetLastError();
}
