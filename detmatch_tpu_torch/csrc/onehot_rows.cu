// Row gather with bf16 rounding (K8's forward):
//   out[b, q] = bf16(x[b, idx[b, q]])   (0 where idx is outside [0, N): -1,
//               or padding)
// Its transpose, the scatter-add dx[b, n] = sum_q 1[idx[b, q] == n] *
// bf16(dout[b, q]), is the chunked segment sum of csrc/segment_sum.cu.
//
// Replaces the TPU kernels of detmatch_tpu/ops/pallas/onehot_rows.py:
// _gather_fwd (pallas_call at :62) and its batched form
// _gather_fwd_batched (:162). They form the gather as a one-hot matmul
// over the whole table (O(Q * N * C) MACs on the TPU's matrix unit); the
// one match of each row gives bf16(x[idx]) exactly, so the gather here
// reads the row by index.
//
// What bounds it on the H100: bytes. The gather reads the B * Q indices
// and the table rows they reach and writes B * Q * C floats (~3.5 M rows
// at the RoI-grid shape). Design: one thread per output element, the
// channels of one row on neighbouring threads.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

unsigned grid_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
    onehot_take_rows_kernel(const float* __restrict__ x,
                            const int32_t* __restrict__ idx,
                            float* __restrict__ out, int n, int q, int c,
                            int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += stride) {
    const int64_t bq = e / c;
    const int ch = static_cast<int>(e - bq * c);
    const int32_t i = idx[bq];
    float v = 0.f;
    if (i >= 0 && i < n) {
      const int64_t bi = bq / q;
      v = __bfloat162float(
          __float2bfloat16_rn(x[(bi * n + i) * c + ch]));
    }
    out[e] = v;
  }
}

}  // namespace

// x (b, n, c) f32, idx (b, q) int32 → out (b, q, c) f32.
DM_EXPORT int dm_onehot_take_rows(const float* x, const int32_t* idx,
                                  float* out, int b, int n, int q, int c,
                                  cudaStream_t stream) {
  if (b < 0 || n <= 0 || q < 0 || c <= 0) return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(b) * q * c;
  if (total == 0) return cudaSuccess;
  onehot_take_rows_kernel<<<grid_for(total), kThreads, 0, stream>>>(
      x, idx, out, n, q, c, total);
  return cudaGetLastError();
}
