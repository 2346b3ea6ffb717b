// Shared definitions of the port's CUDA kernels (built for sm_90a).
//
// Every kernel is reached through a plain C function that launches it on
// the caller's stream and returns cudaGetLastError() (or a cudaError_t
// for arguments it refuses), so the Python wrapper, bound with ctypes,
// can raise on anything but cudaSuccess. Kernels allocate nothing: the
// wrapper passes outputs allocated with torch.empty.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DM_EXPORT extern "C" __attribute__((visibility("default")))

namespace dm {

constexpr int32_t kInvalidKey = 0x7fffffff;  // ops/voxelize.INVALID_KEY

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// First position in the sorted keys[0, n) whose key is >= q.
__device__ __forceinline__ int lower_bound(const int32_t* keys, int n,
                                           int32_t q) {
  int a = 0;
  int z = n;
  while (a < z) {
    const int mid = (a + z) >> 1;
    if (keys[mid] < q) {
      a = mid + 1;
    } else {
      z = mid;
    }
  }
  return a;
}

// (a - b)^2 summed over xyz as ((dx*dx + dy*dy) + dz*dz), every step
// rounded to nearest: no FMA contraction, so the result is bit-identical
// to the plain PyTorch twin (ops/pointnet.sq_dist) and near-ties break
// the same way.
__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Asynchronous global → shared copies (sm_80+): 16 bytes (L2 only) or 4
// bytes (cached); each thread waits for its own groups, and a barrier
// (__syncthreads or __syncwarp) then publishes the data to the others.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace dm
