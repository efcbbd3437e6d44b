// Error strings for the Python side (the C entry points return
// cudaGetLastError() after their launches).
#include "common.cuh"

RT_EXPORT const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
