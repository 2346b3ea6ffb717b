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

}  // namespace dm
