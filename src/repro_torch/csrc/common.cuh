// Shared helpers for the repro_torch CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

// Dynamic shared memory one block may opt into on the H100 (227 KB). A
// scan whose LUT and queue need more reads the LUT from global memory.
constexpr size_t kSmemLimit = 227 * 1024;

__device__ __forceinline__ int floor_mod(int x, int m) {
  int r = x % m;
  return r < 0 ? r + m : r;
}

// 16-byte asynchronous copy from global to shared memory (bypasses L1).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// The same copy, or 16 zero bytes when `full` is false (then nothing is
// read from gmem, which must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 16 : 0));
}

// A 4-byte asynchronous copy (through L1), or 4 zero bytes when `full` is
// false (gmem must still be a valid address).
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 4 : 0));
}

// Closes the group of cp.async this thread issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The in-kernel merge of a result that `n` blocks compute in parts. Every
// thread of a block calls it after the block wrote its part to global
// memory; it returns true in the one block of the n that arrives last,
// which may then read the other parts (with __ldcg, past L1). That block
// also sets *counter back to 0, so the next launch on the stream finds it
// clean: the wrapper zero-fills the counters once, when it allocates them.
__device__ __forceinline__ bool last_block(int* counter, int n) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counter, 1) == n - 1;
    if (last) *counter = 0;
    s_last = last;
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}
