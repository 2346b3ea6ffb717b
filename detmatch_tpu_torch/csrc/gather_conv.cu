// The rulebook gather-GEMM sparse conv in fp32 (K7), on the gather-GEMM
// tile of csrc/gather_gemm.cuh in map mode. K6's forward, the rulebook
// conv with bf16 operands, is csrc/onehot_gather_conv.cu.
#include "gather_gemm.cuh"

namespace {

constexpr int kMaxTaps = 27;
constexpr int kMaxCin = 128;
constexpr int kMaxCout = 128;
constexpr int kMaxW = 16384;  // C * Co floats per tap

bool bad_args(int b, int n, int m, int k, int c, int co) {
  return b < 0 || n <= 0 || m < 0 || k <= 0 || k > kMaxTaps || c <= 0 ||
         c > kMaxCin || co <= 0 || co > kMaxCout || c * co > kMaxW ||
         static_cast<int64_t>(b) * n > 0x7fffffff ||
         static_cast<int64_t>(b) * m > 0x7fffffff;
}

}  // namespace

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
  } else if (c != c4 || co != co4 || !dm::aligned16(feats) ||
             !dm::aligned16(weights)) {
    return cudaErrorInvalidValue;
  }
  return dm::gemm::launch_gather_gemm<false>(feats, nullptr, rb, weights, out,
                                             nullptr, b, n, m, k, c4, co4,
                                             rows, stream, co);
}
