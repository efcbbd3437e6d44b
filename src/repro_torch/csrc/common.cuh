// Shared helpers for the repro_torch CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ int floor_mod(int x, int m) {
  int r = x % m;
  return r < 0 ? r + m : r;
}
