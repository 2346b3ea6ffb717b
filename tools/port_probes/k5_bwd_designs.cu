// Other designs of K5's backward (S of the key-compare conv from the
// forward's rulebook), for tools/port_probes/k5k7_plans.py --plans to
// time beside the port's (detmatch_tpu_torch/csrc/key_conv.cu); not part
// of the port. Each writes the port's S:
//   S[tap * b * n + bi * n + rb[bi, m, tap]] = bf16(dout[bi, m]), zero
//   elsewhere, (k * b * n, co) fp32, co a multiple of 4.
// Designs 0-4 build the port's inverse map (fill with -1, then one
// thread an output row over its taps, integer atomicMax), then write
// every row of S once:
//   0 rows a block step, a thread one float4, 4 steps in flight,
//     streaming stores (the port's write_s_kernel);
//   1 as 0 with plain stores;
//   2 as 1 with one step in flight and one step a block (no grid stride);
//   3 one float4 a thread over S's flat float4 index, grid-stride, as a
//     zero fill is written;
//   4 a warp takes 32 consecutive rows: one coalesced load of their map
//     entries, then their 32 * co / 4 float4 stores, each row's source
//     shuffled from its lane.
// Design 5 keeps a zero fill of S and then scatters the matched rows, a
// warp per 32 rulebook entries (its matched entries' rows in turn);
// design 6 is that zero fill alone (not S: the floor of a pass that
// writes S's bytes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PROBE_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 bf16_round4(float4 v) {
  auto r = [](float x) { return __bfloat162float(__float2bfloat16_rn(x)); };
  return make_float4(r(v.x), r(v.y), r(v.z), r(v.w));
}

__global__ void __launch_bounds__(kThreads)
    invert(const int32_t* __restrict__ rb, int32_t* __restrict__ inv, int b,
           int n, int m, int k) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (row >= static_cast<int64_t>(b) * m) return;
  const int64_t base = row / m * n;
  const int64_t slab = static_cast<int64_t>(b) * n;
  for (int tap = 0; tap < k; ++tap) {
    const int32_t v = rb[row * k + tap];
    if (v >= 0 && v < n) {
      atomicMax(inv + tap * slab + base + v, static_cast<int32_t>(row));
    }
  }
}

template <int kUnroll, bool kStream>
__global__ void __launch_bounds__(kThreads)
    write_rows(const float4* __restrict__ dout,
               const int32_t* __restrict__ inv, float4* __restrict__ s,
               int64_t slots, int co4) {
  const int per_step = kThreads / co4;
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
        v = bf16_round4(dout[static_cast<int64_t>(src[u]) * co4 + q]);
      }
      if (slot < slots) {
        if (kStream) {
          __stcs(s + slot * co4 + q, v);
        } else {
          s[slot * co4 + q] = v;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    write_flat(const float4* __restrict__ dout,
               const int32_t* __restrict__ inv, float4* __restrict__ s,
               int64_t n4, int co4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < n4; e += stride) {
    const int64_t slot = e / co4;
    const int q = static_cast<int>(e - slot * co4);
    const int src = __ldg(inv + slot);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src >= 0) v = bf16_round4(dout[static_cast<int64_t>(src) * co4 + q]);
    s[e] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
    write_warp(const float4* __restrict__ dout,
               const int32_t* __restrict__ inv, float4* __restrict__ s,
               int64_t slots, int co4) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                   (threadIdx.x >> 5);
       w * 32 < slots; w += warps) {
    const int64_t slot0 = w * 32;
    const int mine = slot0 + lane < slots ? inv[slot0 + lane] : -1;
    const int count =
        static_cast<int>(min(static_cast<int64_t>(32), slots - slot0)) * co4;
    float4* dst = s + slot0 * co4;
    for (int e = lane; e < count; e += 32) {
      const int j = e / co4;
      const int q = e - j * co4;
      const int src = __shfl_sync(0xffffffffu, mine, j);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src >= 0) {
        v = bf16_round4(dout[static_cast<int64_t>(src) * co4 + q]);
      }
      dst[e] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    zero_fill(float4* __restrict__ s, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += stride) {
    s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
    scatter_pairs(const float4* __restrict__ dout,
                  const int32_t* __restrict__ rb, float4* __restrict__ s,
                  int b, int n, int m, int k, int co4) {
  const int lane = threadIdx.x & 31;
  const int64_t total = static_cast<int64_t>(b) * m * k;
  const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      (threadIdx.x >> 5)) * 32;
  if (p0 >= total) return;
  bool hit = false;
  if (p0 + lane < total) {
    const int v = rb[p0 + lane];
    hit = v >= 0 && v < n;
  }
  unsigned mask = __ballot_sync(0xffffffffu, hit);
  while (mask) {
    const int j = __ffs(mask) - 1;
    mask &= mask - 1;
    const int64_t p = p0 + j;
    const int64_t row = p / k;
    const int tap = static_cast<int>(p - row * k);
    const int64_t slot = static_cast<int64_t>(tap) * b * n + row / m * n +
                         rb[p];
    for (int q = lane; q < co4; q += 32) {
      s[slot * co4 + q] = bf16_round4(dout[row * co4 + q]);
    }
  }
}

unsigned capped(int64_t want, int64_t cap) {
  return static_cast<unsigned>(want < cap ? want : cap);
}

}  // namespace

// dout (b, m, co), rb (b, m, k) → s (k, b * n, co) by design `design`;
// inv: scratch of k * b * n int32.
PROBE_EXPORT int probe_k5_bwd(int design, const float* dout,
                              const int32_t* rb, int32_t* inv, float* s,
                              int b, int n, int m, int k, int co,
                              cudaStream_t stream) {
  if (design < 0 || design > 6 || co % 4 != 0 || co > 128) {
    return cudaErrorInvalidValue;
  }
  const int64_t slots = static_cast<int64_t>(k) * b * n;
  const int co4 = co / 4;
  const int64_t n4 = slots * co4;
  const int64_t rows = static_cast<int64_t>(b) * m;
  const float4* d4 = reinterpret_cast<const float4*>(dout);
  float4* s4 = reinterpret_cast<float4*>(s);
  const unsigned fill_blocks = capped((n4 + kThreads - 1) / kThreads,
                                      132 * 16);
  if (design >= 5) {
    zero_fill<<<fill_blocks, kThreads, 0, stream>>>(s4, n4);
    if (design == 5) {
      const int64_t warps = (rows * k + 31) / 32;
      scatter_pairs<<<static_cast<unsigned>((warps + 7) / 8), kThreads, 0,
                      stream>>>(d4, rb, s4, b, n, m, k, co4);
    }
    return cudaGetLastError();
  }
  cudaError_t err = cudaMemsetAsync(inv, 0xff, slots * sizeof(int32_t),
                                    stream);
  if (err != cudaSuccess) return err;
  invert<<<static_cast<unsigned>((rows + kThreads - 1) / kThreads), kThreads,
           0, stream>>>(rb, inv, b, n, m, k);
  const int per_step = kThreads / co4;
  const int64_t steps = (slots + per_step - 1) / per_step;
  switch (design) {
    case 0:
      write_rows<4, true><<<capped((steps + 3) / 4, 132 * 64), kThreads, 0,
                            stream>>>(d4, inv, s4, slots, co4);
      break;
    case 1:
      write_rows<4, false><<<capped((steps + 3) / 4, 132 * 64), kThreads, 0,
                             stream>>>(d4, inv, s4, slots, co4);
      break;
    case 2:
      write_rows<1, false><<<capped(steps, 1LL << 31), kThreads, 0,
                             stream>>>(d4, inv, s4, slots, co4);
      break;
    case 3:
      write_flat<<<fill_blocks, kThreads, 0, stream>>>(d4, inv, s4, n4, co4);
      break;
    default:
      write_warp<<<capped((slots + 255) / 256, 132 * 16), kThreads, 0,
                   stream>>>(d4, inv, s4, slots, co4);
  }
  return cudaGetLastError();
}
