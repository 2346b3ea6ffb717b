// Error text for the codes the launch functions return.
#include "common.cuh"

DM_EXPORT const char* dm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
