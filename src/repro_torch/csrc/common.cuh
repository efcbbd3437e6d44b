// Shared helpers for the repro_torch CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

// Tie rule of the reference's selections (kernels/common.py
// extract_topk_rows): ascending distance, and among equal distances the
// earlier-arriving candidate first. Arrival indices are unique, so this
// is a strict total order and the k smallest keys are one fixed set
// whatever order a kernel visits them in.
__device__ __forceinline__ bool key_less(float da, int aa, float db, int ab) {
  return da < db || (da == db && aa < ab);
}

__device__ __forceinline__ int floor_mod(int x, int m) {
  int r = x % m;
  return r < 0 ? r + m : r;
}
