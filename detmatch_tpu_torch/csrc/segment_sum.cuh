// Deterministic segment sums of bf16-rounded rows, shared by the backward
// kernels of the one-hot ops (K6's S in onehot_gather.cu, K8's scatter-add
// in onehot_rows.cu).
//
// The wrapper orders the (slot, source row) pairs by slot with a stable
// sort and passes, per slot s, the range [offsets[s], offsets[s + 1]) of
// that order; pair j reads source row order[j] / div. Each output element
// is then one thread's fp32 sum, in ascending source order, starting from
// 0: no float atomics, the same bits on every run, and a slot with one
// writer holds exactly the bf16-rounded value (a slot with none, 0).
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace dm {

// out[s, ch] = sum over j in [offsets[s], offsets[s + 1]) of
// bf16(rows[(order[j] / div) * cols + ch]), for element e = s * cols + ch.
__device__ __forceinline__ float segment_sum_bf16(
    const float* __restrict__ rows, const int32_t* __restrict__ order,
    const int32_t* __restrict__ offsets, int div, int cols, int64_t e) {
  const int64_t s = e / cols;
  const int ch = static_cast<int>(e - s * cols);
  const int end = offsets[s + 1];
  float acc = 0.f;
  for (int j = offsets[s]; j < end; ++j) {
    const int64_t src = order[j] / div;
    acc += __bfloat162float(__float2bfloat16_rn(rows[src * cols + ch]));
  }
  return acc;
}

}  // namespace dm
