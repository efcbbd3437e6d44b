// PQ asymmetric-distance scans of the staged ChamVS path: the per-entry
// scan with its running top-k (adc_scan) and the batched scan of one
// shared code slab (shared_scan).
//
// adc_scan replaces: src/repro/kernels/pq_adc/kernel.py:101 adc_scan
//           (body _adc_scan_kernel, kernel.py:62).
// One block per (query, probe) entry b, 256 threads. The entry's LUT
// (m x ksub float32, 32 KB at m=32, ksub=256) is copied into shared
// memory once; threads stride over the rows below lens[b], each doing
// the real byte lookup per sub-space and summing the m terms in index
// order 0..m-1 in float32 (the plain version's order, bit for bit). The
// TPU kernel's one-hot compare-FMA (kernel.py:75-80) exists only because
// its vector unit has no byte-addressable table, and its tiles of
// tile_n rows need padded codes; here the block stops at lens[b] itself,
// so padding rows are never read. The running top-k is the shared queue
// of topk_queue.cuh under the key (distance, row): the reference's
// lower-row-first order, (+inf, -1) past the valid rows.
// Bound on the H100: memory. It must read the codes of the valid rows
// (sum(lens) * m bytes) and one LUT per entry; a warp reads 32
// consecutive m-byte rows with 16-byte vector loads. Blocks are as
// uneven as the lists are long; the bitonic merges are rare once the
// queue's threshold has settled.
//
// shared_scan replaces: src/repro/kernels/pq_adc/kernel.py:158
//           shared_scan (body _shared_scan_kernel, kernel.py:142).
// A block takes a tile of up to kMaxTileQ queries (as many LUTs as fit
// in 64 KB of shared memory, so that three blocks share an SM) and a
// chunk of rows; each thread reads its row's codes once and forms every
// (row, query) output of the tile as the index-order sum of m lookups.
// The TPU kernel builds a [tile_n, m * ksub] one-hot matrix for its
// matrix unit (kernel.py:145-155); no one-hot matrix exists here. Query
// tiles vary fastest across the grid, so the blocks that read one chunk
// of codes run together and share it through L2.
// Bound on the H100: the n * q * 4-byte output and the n * m code bytes
// against n * q * m float32 adds put it on memory, but each add is a
// shared-memory lookup at random banks, so the lookups set its time.
// The tensor-core form (a one-hot product in fp32 via TF32 would change
// the sums) is later work.
#include <math.h>

#include "topk_queue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSort = 2048;       // queue + candidate buffer, power of two
constexpr int kMaxTileQ = 8;      // shared_scan queries per block
using Queue = SmemQueue<kThreads, kSort, false>;

// Index-order sum of one row's m lookups into a [m, ksub] table.
__device__ __forceinline__ float adc_row(const float* lut,
                                         const uint8_t* row, int m, int ksub,
                                         bool vec) {
  float d = 0.f;
  if (vec) {
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    for (int j16 = 0; j16 < m / 16; ++j16) {
      const uint4 v = rv[j16];
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = j16 * 16 + k * 4 + b;
          d += lut[j * ksub + ((w[k] >> (8 * b)) & 0xffu)];
        }
      }
    }
  } else {
    for (int j = 0; j < m; ++j) d += lut[j * ksub + row[j]];
  }
  return d;
}

__global__ void __launch_bounds__(kThreads)
adc_scan_kernel(const float* __restrict__ luts, long long lut_bs,
                const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ lens, float* __restrict__ out_d,
                int32_t* __restrict__ out_i, int n, int m, int ksub, int k,
                int vec) {
  extern __shared__ float smem[];
  float* lut = smem;                                  // [m * ksub]
  float* sd = lut + m * ksub;                         // [kSort]
  int* sa = reinterpret_cast<int*>(sd + kSort);       // [kSort]
  __shared__ QueueScalars qs;
  const Queue queue{sd, sa, nullptr, k, &qs};

  const int b = blockIdx.x, t = threadIdx.x;
  const float* lsrc = luts + b * lut_bs;
  for (int i = t; i < m * ksub; i += kThreads) lut[i] = lsrc[i];
  queue.init();
  __syncthreads();

  const int len = max(0, min(lens[b], n));
  const uint8_t* cbase = codes + (long long)b * n * m;
  for (int r0 = 0; r0 < len; r0 += kThreads) {
    const int r = r0 + t;
    if (r < len) {
      queue.offer(adc_row(lut, cbase + (long long)r * m, m, ksub, vec != 0),
                  r);
    }
    queue.end_round(1);
  }
  queue.finish();

  const long long o = (long long)b * k;
  for (int i = t; i < k; i += kThreads) {
    out_d[o + i] = sd[i];
    out_i[o + i] = queue.id(i);
  }
}

__global__ void __launch_bounds__(kThreads)
shared_scan_kernel(const float* __restrict__ luts,
                   const uint8_t* __restrict__ codes, float* __restrict__ out,
                   int n, int q, int m, int ksub, int tq, int rows_per_block,
                   int vec) {
  extern __shared__ float lut[];                      // [tq, m, ksub]
  const int q0 = blockIdx.x * tq, t = threadIdx.x;
  const int nq = min(tq, q - q0);
  const int tab = m * ksub;
  const float* lsrc = luts + (long long)q0 * tab;
  for (int i = t; i < nq * tab; i += kThreads) lut[i] = lsrc[i];
  __syncthreads();

  const long long r_end =
      min((long long)n, (long long)(blockIdx.y + 1) * rows_per_block);
  for (long long r = (long long)blockIdx.y * rows_per_block + t; r < r_end;
       r += kThreads) {
    const uint8_t* row = codes + r * m;
    float acc[kMaxTileQ];
#pragma unroll
    for (int qi = 0; qi < kMaxTileQ; ++qi) acc[qi] = 0.f;
    if (vec) {
      const uint4* rv = reinterpret_cast<const uint4*>(row);
      for (int j16 = 0; j16 < m / 16; ++j16) {
        const uint4 v = rv[j16];
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int kw = 0; kw < 4; ++kw) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int off = (j16 * 16 + kw * 4 + b) * ksub +
                            ((w[kw] >> (8 * b)) & 0xffu);
#pragma unroll
            for (int qi = 0; qi < kMaxTileQ; ++qi) {
              if (qi < nq) acc[qi] += lut[qi * tab + off];
            }
          }
        }
      }
    } else {
      for (int j = 0; j < m; ++j) {
        const int off = j * ksub + row[j];
#pragma unroll
        for (int qi = 0; qi < kMaxTileQ; ++qi) {
          if (qi < nq) acc[qi] += lut[qi * tab + off];
        }
      }
    }
    float* o = out + r * q + q0;
#pragma unroll
    for (int qi = 0; qi < kMaxTileQ; ++qi) {
      if (qi < nq) o[qi] = acc[qi];
    }
  }
}

}  // namespace

// luts: float32 [B, m, ksub] with stride lut_bs (in elements) between
// entries and contiguous [m, ksub] blocks; codes [B, n, m] uint8,
// contiguous; lens [B] int32 -> out_d [B, k] f32 ascending, out_i [B, k]
// int32 (row within n, -1 on +inf slots). vec: codes rows are 16-byte
// aligned and m % 16 == 0.
RT_EXPORT int adc_scan_launch(const void* luts, long long lut_bs,
                              const void* codes, const void* lens,
                              void* out_d, void* out_i, int B, int n, int m,
                              int ksub, int k, int vec, void* stream) {
  if (k < 1 || k > kSort - kThreads) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (size_t)m * ksub +
                      (sizeof(float) + sizeof(int)) * kSort;
  cudaError_t err = cudaFuncSetAttribute(
      adc_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  adc_scan_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(luts), lut_bs,
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(lens),
      static_cast<float*>(out_d), static_cast<int32_t*>(out_i), n, m, ksub, k,
      vec);
  return cudaGetLastError();
}

// luts: float32 [q, m, ksub], contiguous; codes [n, m] uint8, contiguous
// -> out [n, q] f32. tq: queries per block (<= kMaxTileQ);
// rows_per_block: rows of one block's chunk.
RT_EXPORT int shared_scan_launch(const void* luts, const void* codes,
                                 void* out, int n, int q, int m, int ksub,
                                 int tq, int rows_per_block, int vec,
                                 void* stream) {
  if (tq < 1 || tq > kMaxTileQ || rows_per_block < 1)
    return cudaErrorInvalidValue;
  if (n == 0 || q == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (size_t)tq * m * ksub;
  cudaError_t err = cudaFuncSetAttribute(
      shared_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((q + tq - 1) / tq, (n + rows_per_block - 1) / rows_per_block);
  shared_scan_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(luts), static_cast<const uint8_t*>(codes),
      static_cast<float*>(out), n, q, m, ksub, tq, rows_per_block, vec);
  return cudaGetLastError();
}
