// The backward scatter of the rulebook conv with bf16 operands (K6):
//   S[k, n] = sum_m 1[rb[m, k] == n] * bf16(dout[m])     (fp32 sums)
// for a flattened rulebook rb (M, K) over N input rows; entries outside
// [0, N) are dropped. dF = sum_k S_k W_k^T and dW_k = F^T S_k follow as
// fp32 matmuls outside the kernel, as in JAX's custom VJP (_vjp_bwd).
//
// Replaces the TPU kernel detmatch_tpu/ops/pallas/onehot_gather.py:
// _scatter_all_taps (pallas_call at :138), which builds each N-tile of S as
// transposed one-hot matmuls over all M rows (O(K * N * M) compares). A
// spconv rulebook is injective per tap (an input row and a tap fix one
// output row), a general one may repeat a row: the wrapper stably sorts
// the (tap, row) pairs by slot k * N + row, and this kernel sums each
// slot's pairs in ascending m (csrc/segment_sum.cuh), deterministically
// and with no atomics; an injective rulebook gives the twin's S bit for
// bit. K6's forward is csrc/gather_conv.cu with its bf16 flag.
//
// What bounds it on the H100: S is K * N * Co floats written once (up to
// 27 x 192,000 x 16-64, 0.3-1.3 GB at the backbone's shapes) beside M * Co
// floats of dout read through the order; the bytes of S bound it. Design:
// one thread per element of S, channels of one slot on neighbouring
// threads (coalesced writes, and coalesced reads of each dout row).
#include "segment_sum.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    onehot_gather_scatter_kernel(const float* __restrict__ dout,
                                 const int32_t* __restrict__ order,
                                 const int32_t* __restrict__ offsets,
                                 float* __restrict__ s, int k, int64_t total,
                                 int co) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += stride) {
    s[e] = dm::segment_sum_bf16(dout, order, offsets, k, co, e);
  }
}

}  // namespace

// dout (m, co) f32; order (pairs,) int32: pair p = m * k + tap sorted
// stably by slot; offsets (slots + 1,) int32 → s (slots, co) f32 with
// slots = k * n.
DM_EXPORT int dm_onehot_gather_scatter(const float* dout,
                                       const int32_t* order,
                                       const int32_t* offsets, float* s,
                                       int k, int slots, int co,
                                       cudaStream_t stream) {
  if (k <= 0 || slots < 0 || co <= 0) return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(slots) * co;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  onehot_gather_scatter_kernel<<<
      static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16), kThreads,
      0, stream>>>(dout, order, offsets, s, k, total, co);
  return cudaGetLastError();
}
