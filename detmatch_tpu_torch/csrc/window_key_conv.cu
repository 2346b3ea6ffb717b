// Sparse 3D convolution forward over sorted int32 voxel keys (K1):
//   out[b, m] = sum_k F[b, row(nkeys[b, m, k])] . W_k
// where row(q) is the row of key q in sample b's own sorted key table
// (no row if q is absent or INVALID_KEY).
//
// Replaces the TPU kernel detmatch_tpu/ops/pallas/window_key_conv.py:_fwd
// (_fwd_kernel, pallas_call at :190), which avoids gathers, slow on the
// TPU, by comparing each 512-row output tile's neighbour keys against a
// window of the flattened key table and contracting one-hot matches on
// the MXU in bf16. Gathers are cheap here, so this kernel does not copy
// the key-window compare. It also searches each sample's own segment:
// the TPU wrapper's flattened table keeps INVALID_KEY pads between
// samples, which breaks the sorted order its window search relies on.
// fp32 throughout, like the XLA rulebook path (spconv.gather_conv_batched)
// that the JAX reference runs off the TPU.
//
// What bounds it on the H100: the fp32 FMAs of the matched (row, tap)
// pairs, one per (pair, C, Co); the backbone's features and key tables
// are a few MB. Between 5% and 23% of the rows x 27 taps of a conv find
// an input row (pad rows and empty neighbourhoods), so the design spends
// no arithmetic on the others.
//
// Design: the gather-GEMM tile of csrc/gather_gemm.cuh in search mode.
// Per block of output rows, the (row, tap) sources are binary-searched in
// the sample's key table once; per tap only the rows with a source are
// gathered (cp.async, two stages, W_k once per block) and multiplied into
// shared-memory accumulators by 4 x 4 register micro-tiles. With rb given
// the resolved rows are also written out, the rulebook that the backward
// (csrc/window_key_conv_bwd.cu) reads instead of searching again.
//
// Any C and Co: the tile copies 16-byte vectors, so where C or Co is not
// a multiple of 4, or feats or weights does not start on 16 bytes, a
// prologue copies them into fp (b * n, C4) and wp (k, C4, Co4) with zero
// pads (K7's, csrc/gather_gemm.cuh:pad_operands_kernel; C, Co up to
// multiples of 4), and the tile stores Co of its Co4 columns.
//
// Order of the sums, per output element: fp32 from +0, fmaf over the taps
// ascending, then the input channels ascending. Taps without a row are
// skipped and zero pads add nothing, which changes no bit, so the result
// is bit-equal to K7 (csrc/gather_conv.cu) on spconv.rulebook_batched's
// rulebook.
#include "gather_gemm.cuh"

// feats (b, n, c) f32; keys (b, n) int32 sorted per sample, INVALID_KEY
// padded; nkeys (b, m, k) int32; weights (k, c, co) f32 → out (b, m, co);
// rb (b, m, k) int32 per-sample input rows, -1 = none (nullptr = not
// wanted). fp, wp: the padded scratch, or both nullptr where no pad is
// needed (ops/cuda/window_key_conv.needs_pad). rows: output rows per
// block (a multiple of 32, <= 128, whose tile fits the shared memory at
// C4 x Co4; ops/cuda/window_key_conv.tile_rows).
DM_EXPORT int dm_window_key_conv_fwd(const float* feats, const int32_t* keys,
                                     const int32_t* nkeys,
                                     const float* weights, float* fp,
                                     float* wp, float* out, int32_t* rb,
                                     int b, int n, int m, int k, int c,
                                     int co, int rows, cudaStream_t stream) {
  if (b < 0 || n <= 0 || c <= 0 || co <= 0 ||
      (fp == nullptr) != (wp == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int c4 = (c + 3) / 4 * 4;
  const int co4 = (co + 3) / 4 * 4;
  if (fp != nullptr) {
    if (static_cast<int64_t>(b) * m == 0) return cudaSuccess;
    const cudaError_t err = dm::gemm::launch_pad_operands<false>(
        feats, weights, fp, wp, static_cast<int64_t>(b) * n, k, c, co, c4,
        co4, stream);
    if (err != cudaSuccess) return err;
    feats = fp;
    weights = wp;
  } else if (c != c4 || co != co4 || !dm::aligned16(feats) ||
             !dm::aligned16(weights)) {
    return cudaErrorInvalidValue;
  }
  return dm::gemm::launch_gather_gemm<true>(feats, keys, nkeys, weights, out,
                                            rb, b, n, m, k, c4, co4, rows,
                                            stream, co);
}
