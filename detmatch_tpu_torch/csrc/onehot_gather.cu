// The backward scatter of the rulebook conv with bf16 operands (K6):
//   S[k, n] = sum_m 1[rb[m, k] == n] * bf16(dout[m])     (fp32 sums)
// for a flattened rulebook rb (M, K) over N input rows; entries outside
// [0, N) are dropped. dF = sum_k S_k W_k^T and dW_k = F^T S_k follow as
// fp32 matmuls outside the kernel, as in JAX's custom VJP (_vjp_bwd).
//
// Replaces the TPU kernel detmatch_tpu/ops/pallas/onehot_gather.py:
// _scatter_all_taps (pallas_call at :138), which builds each N-tile of S as
// transposed one-hot matmuls over all M rows (O(K * N * M) compares). K6's
// forward is csrc/gather_conv.cu with its bf16 flag.
//
// What bounds it on the H100: bytes. S is K * N * Co floats written once
// (up to 27 x 192,000 x 16-128 at the backbone's shapes, 0.3-2.7 GB)
// beside M * Co floats of dout and the rulebook read once.
//
// Why the first design lost to index_add_: it sorted all K * M pairs
// (unmatched ones included, ~5.2 M a call) by slot and summed each slot in
// a per-element loop, although a spconv rulebook is injective per tap (an
// input row and a tap fix one output row), so no slot has two writers.
//
// Design: two paths with one result, chosen on the device.
//   Direct (every slot has at most one writer), one call: claim writes
//     the inverse map inv[k * N + rb[m, k]] = m (K * N int32, filled with
//     -1 first) by an integer atomicCAS from -1; a failed claim, a second
//     writer, sets the repeat flag; fill, queued behind it, writes S row
//     by row, bf16(dout[inv]) or 0, 16-byte stores where Co allows, four
//     a thread with their loads ahead. The wrapper then reads the flag
//     (one host synchronisation, after both kernels, so the card does not
//     wait on the host between them). One writer a slot: S equals the
//     twin exactly. Bytes: S once, dout's matched rows once, and
//     3 x K * N x 4 of map.
//   Sorted (the flag set): the chunked segment sum of csrc/segment_sum.cu
//     over the pairs' slots k * N + rb (pair m * K + k reads row m), in
//     its stated order, writes every element of S again: deterministic
//     for any rulebook.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

unsigned grid_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads)
    claim_kernel(const int32_t* __restrict__ rb, int32_t* __restrict__ inv,
                 int32_t* __restrict__ repeat, int pairs, int k, int n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < pairs; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int p = static_cast<int>(i);
    const int32_t r = rb[p];
    if (r < 0 || r >= n) continue;
    const int m = p / k;
    if (atomicCAS(inv + (p - m * k) * n + r, -1, m) != -1) *repeat = 1;
  }
}

// Each thread owns one V-channel piece of a row (groups = co / V threads a
// row, kThreads / groups rows a block, fixed for the kernel) and takes
// kUnroll rows a step, their loads issued before their stores: the gather
// of dout waits on the load of inv.
constexpr int kUnroll = 4;

template <int V>
__global__ void __launch_bounds__(kThreads)
    fill_kernel(const float* __restrict__ dout,
                const int32_t* __restrict__ inv, float* __restrict__ s,
                int slots, int co) {
  const int groups = co / V;
  const int rows = kThreads / groups;
  const int r = threadIdx.x / groups;
  if (r >= rows) return;  // the block's last, partial group
  const int ch = (threadIdx.x - r * groups) * V;
  const int64_t step = static_cast<int64_t>(gridDim.x) * rows;
  for (int64_t slot = static_cast<int64_t>(blockIdx.x) * rows + r;
       slot < slots; slot += step * kUnroll) {
    int32_t m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      m[u] = slot + u * step < slots ? inv[slot + u * step] : -1;
    }
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (m[u] >= 0) {
        const float* src = dout + static_cast<int64_t>(m[u]) * co + ch;
        if constexpr (V == 4) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(src));
          v[u][0] = t.x;
          v[u][1] = t.y;
          v[u][2] = t.z;
          v[u][3] = t.w;
        } else {
          v[u][0] = __ldg(src);
        }
#pragma unroll
        for (int t = 0; t < V; ++t) v[u][t] = bf16_round(v[u][t]);
      } else {
#pragma unroll
        for (int t = 0; t < V; ++t) v[u][t] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (slot + u * step >= slots) break;
      float* dst = s + (slot + u * step) * co + ch;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
      } else {
        dst[0] = v[u][0];
      }
    }
  }
}

}  // namespace

// The direct path in one call: rb (m, k) int32 and dout (m, co) f32 →
// inv (k * n + 1,) int32 scratch: the writer of each slot (-1 for none),
// then the repeat flag (-1, or 1 if a slot has two writers); and s
// (k * n, co) f32: bf16(dout[inv]), 0 where inv is -1 (S when the flag is
// -1). The sizes fit in 32 bits (the wrapper checks: m * k below 2^30,
// k * n * co below 2^31); co / 4 (co / 1 where 4 does not divide it) is
// at most kThreads.
DM_EXPORT int dm_onehot_gather_direct(const int32_t* rb, const float* dout,
                                      int32_t* inv, float* s, int m, int k,
                                      int n, int co, cudaStream_t stream) {
  const int v = co % 4 == 0 ? 4 : 1;
  if (m < 0 || k <= 0 || n < 0 || co <= 0 || co / v > kThreads) {
    return cudaErrorInvalidValue;
  }
  const int slots = k * n;
  const cudaError_t err = cudaMemsetAsync(
      inv, 0xff, (static_cast<size_t>(slots) + 1) * sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  const int pairs = m * k;
  if (pairs > 0) {
    claim_kernel<<<grid_for(pairs), kThreads, 0, stream>>>(
        rb, inv, inv + slots, pairs, k, n);
  }
  if (slots > 0) {
    const int64_t rows = kThreads / (co / v);  // a block's rows a step
    const int64_t blocks = (slots + rows * kUnroll - 1) / (rows * kUnroll);
    const unsigned grid = static_cast<unsigned>(
        blocks < kMaxBlocks ? blocks : kMaxBlocks);
    if (v == 4) {
      fill_kernel<4><<<grid, kThreads, 0, stream>>>(dout, inv, s, slots, co);
    } else {
      fill_kernel<1><<<grid, kThreads, 0, stream>>>(dout, inv, s, slots, co);
    }
  }
  return cudaGetLastError();
}
