// K6's forward by the fp32 tile, kept as a measured comparison to the
// port's bf16 tensor-core tile (detmatch_tpu_torch/csrc/
// onehot_gather_conv.cu): K5's prologue rounds F and W to bf16 values in
// fp32 scratch (C, Co up to multiples of 4), then K7's gather-GEMM tile
// runs in map mode on the rulebook, fmaf over the taps ascending, then
// the channels: K5's forward with a rulebook in place of the keys. Built
// and timed by tools/port_probes/k6k8_plans.py (nvcc -I the port's csrc).
#include "gather_gemm.cuh"

// feats (n, c), rb (m, k), weights (k, c, co) f32 → out (m, co); fr
// (n, C4) and wr (k, C4, Co4) f32 scratch; rows: the tile's output rows
// (ops/cuda/window_key_conv.tile_rows(k, C4, Co4)).
extern "C" int probe_k6_fp32_tile(const float* feats, const int32_t* rb,
                                  const float* weights, float* fr, float* wr,
                                  float* out, int n, int m, int k, int c,
                                  int co, int rows, cudaStream_t stream) {
  const int c4 = (c + 3) / 4 * 4;
  const int co4 = (co + 3) / 4 * 4;
  const cudaError_t err = dm::gemm::launch_pad_operands<true>(
      feats, weights, fr, wr, n, k, c, co, c4, co4, stream);
  if (err != cudaSuccess) return err;
  return dm::gemm::launch_gather_gemm<false>(fr, nullptr, rb, wr, out,
                                             nullptr, 1, n, m, k, c4, co4,
                                             rows, stream, co);
}
