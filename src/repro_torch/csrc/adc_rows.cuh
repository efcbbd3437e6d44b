// The PQ lookups of the two ADC scans that keep a running top-k
// (chamvs_scan.cu, and adc_scan in pq_adc.cu).
#pragma once

#include "common.cuh"

// Copies an n-float LUT into shared memory with a block of kThreads
// threads; the caller synchronises.
template <int kThreads>
__device__ __forceinline__ void load_lut(float* dst, const float* src,
                                         int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = __ldg(src + i);
  }
}

// Adds to dist[i] the m = 16 W lookups of row i into a [m, 256] LUT in
// shared memory, from the row's W 16-byte chunks of codes, in sub-space
// order 0..m-1 in float32. The kRows rows' sums advance together, one
// sub-space at a time, so that their float32 chains interleave; each
// still adds in index order.
template <int kRows, int W>
__device__ __forceinline__ void lookup_rows(const float* lut,
                                            const uint4 (&c)[kRows][W],
                                            float (&dist)[kRows]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int by = 0; by < 4; ++by) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const unsigned w = reinterpret_cast<const unsigned*>(&c[i][k])[e];
          dist[i] +=
              lut[(k * 16 + e * 4 + by) * 256 + ((w >> (8 * by)) & 0xffu)];
        }
      }
    }
  }
}

// The ADC distances of kRows rows first + i * kStride (i < kRows) of one
// list's codes at base ([*, m] uint8), the rows at or past hi left at 0:
// every row's 16-byte code loads are issued before the lookups when V > 0
// (m = 16 V, ksub = 256, 16-byte aligned rows), else bytes are read one by
// one.
template <int V, int kRows, int kStride>
__device__ __forceinline__ void round_sums(const float* lut,
                                           const uint8_t* base, int m,
                                           int ksub, int first, int hi,
                                           float (&dist)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) dist[i] = 0.f;
  if (V > 0) {
    uint4 cv[kRows][V > 0 ? V : 1];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = first + i * kStride;
#pragma unroll
      for (int j = 0; j < (V > 0 ? V : 1); ++j)
        cv[i][j] = make_uint4(0, 0, 0, 0);
      if (r < hi) {
        const uint4* src =
            reinterpret_cast<const uint4*>(base + (long long)r * m);
#pragma unroll
        for (int j = 0; j < (V > 0 ? V : 1); ++j) cv[i][j] = __ldg(src + j);
      }
    }
    lookup_rows(lut, cv, dist);
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = first + i * kStride;
      if (r >= hi) continue;
      const uint8_t* row = base + (long long)r * m;
      for (int j = 0; j < m; ++j) dist[i] += lut[j * ksub + row[j]];
    }
  }
}
