// Farthest-point sampling, one block per sample.
//
// Replaces the TPU kernel detmatch_tpu/ops/pallas/fps.py:_fps_pallas
// (_fps_kernel), which keeps the whole batch's (3, N) coordinates and
// running distances in VMEM and advances the B greedy chains in lockstep.
//
// What bounds it on the H100: the 2,048 selections are strictly
// sequential, so the time is 2,048 x (one sweep over N points + one
// block-wide argmax); the data is small (16,384 points = 192 KB of xyz).
// Latency per step, not bandwidth, is the limit.
//
// Design: the sample's xyz lives in shared memory (3 x N floats, N <=
// 18,432 fits in the 227 KB a block may use), each thread keeps the
// running min-distances of its own points in registers (up to 18 at
// 1,024 threads), and every step ends in a warp-shuffle argmax plus one
// cross-warp pass. Ties break on (distance desc, index asc): the first
// occurrence, as jnp.argmax. Invalid points start at -1 and, since every
// squared distance is >= 0, stay at -1 and are never chosen while a
// valid point remains; an all-invalid row yields index 0 throughout.
#include <float.h>
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 18;
constexpr float kBigDist = 1e10f;  // ops/pointnet.BIG_DIST

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d > bd || (d == bd && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& d, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// Block-wide argmax; every thread gets the winning index.
__device__ __forceinline__ int block_argmax(float d, int i, float* red_d,
                                            int* red_i, int* result) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(d, i);
  if (lane == 0) {
    red_d[warp] = d;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    d = red_d[lane];
    i = red_i[lane];
    warp_argmax(d, i);
    if (lane == 0) *result = i;
  }
  __syncthreads();
  return *result;
}

__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
               int32_t* __restrict__ out, int n, int k) {
  extern __shared__ float s_xyz[];  // x[0:n] | y[0:n] | z[0:n]
  __shared__ float red_d[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_result;

  float* sx = s_xyz;
  float* sy = s_xyz + n;
  float* sz = s_xyz + 2 * n;
  const int t = threadIdx.x;
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  const uint8_t* v = valid + static_cast<size_t>(blockIdx.x) * n;
  int32_t* o = out + static_cast<size_t>(blockIdx.x) * k;

  float dist[kMaxPerThread];
  int first = INT_MAX;  // smallest valid index this thread owns
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int i = t + j * kThreads;
    dist[j] = -1.f;
    if (i < n) {
      sx[i] = p[3 * i];
      sy[i] = p[3 * i + 1];
      sz[i] = p[3 * i + 2];
      if (v[i]) {
        dist[j] = kBigDist;
        first = min(first, i);
      }
    }
  }
  // first valid point (ties on the constant key pick the smallest index);
  // the barriers inside also publish the shared xyz
  int last = block_argmax(0.f, first, red_d, red_i, &s_result);
  if (last == INT_MAX) last = 0;
  if (t == 0) o[0] = last;

  for (int s = 1; s < k; ++s) {
    const float lx = sx[last];
    const float ly = sy[last];
    const float lz = sz[last];
    float bd = -FLT_MAX;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int i = t + j * kThreads;
      if (i < n) {
        const float d = fminf(dist[j], dm::sq_dist(sx[i], sy[i], sz[i],
                                                   lx, ly, lz));
        dist[j] = d;
        if (d > bd) {  // i grows with j: strict keeps the first occurrence
          bd = d;
          bi = i;
        }
      }
    }
    last = block_argmax(bd, bi, red_d, red_i, &s_result);
    if (t == 0) o[s] = last;
  }
}

}  // namespace

// xyz (b, n, 3) f32, valid (b, n) bool as bytes → out (b, k) int32.
DM_EXPORT int dm_fps(const float* xyz, const uint8_t* valid, int32_t* out,
                     int b, int n, int k, cudaStream_t stream) {
  if (b < 0 || n <= 0 || n > kThreads * kMaxPerThread || k <= 0) {
    return cudaErrorInvalidValue;
  }
  if (b == 0) return cudaSuccess;
  const int smem = 3 * n * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fps_kernel<<<b, kThreads, smem, stream>>>(xyz, valid, out, n, k);
  return cudaGetLastError();
}
