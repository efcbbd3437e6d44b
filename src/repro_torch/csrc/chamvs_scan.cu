// Fused ChamVS scan: PQ asymmetric distances over every shard's probed
// IVF lists, and a running top-kk of (distance, global id) behind it.
//
// Replaces: src/repro/kernels/chamvs_scan/kernel.py:93 fused_scan
//           (body _chamvs_scan_kernel, kernel.py:41, with the queue of
//           kernels/common.py extract_topk_rows).
//
// One block per (query, shard), 256 threads. For each probe in order the
// block loads that query's LUT (m x ksub float32, 32 KB at m=32) into
// shared memory and does the real byte lookup — the TPU kernel's
// one-hot compare-FMA (kernel.py:51-76) exists only because its vector
// unit has no byte-addressable table. The block indexes the probed list
// of the stacked shard tables itself (probe_ids), so the reference's
// [S, nq, nprobe, cap, m] gather of the codes (chamvs_scan/ops.py:60-62)
// never exists; it reads only the list's valid prefix (rows < lens),
// which is the reference's +inf masking (kernel.py:80-82) without the
// reads. A thread sums its row's m terms in index order 0..m-1 in
// float32 (the plain version sums in the same order, bit for bit).
//
// Selection: the shared queue of topk_queue.cuh under the key
// (distance, arrival index = probe * cap + row), which is exactly the
// reference queue's stable arrival order, with the global id as payload
// and +inf slots reported as id -1.
//
// Bound on the H100: memory. It must read the probed lists' codes,
// S * nq * nprobe * mean_len * m bytes, and the LUTs; a global id is read
// only for a row that enters the queue, so the function needs just the
// winners' ids. Rows are one thread each, so a warp reads 32 consecutive
// m-byte rows (16-byte vector loads). The bitonic merges are rare once
// the queue's threshold has settled.
#include <math.h>

#include "topk_queue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSort = 2048;       // queue + candidate buffer, power of two
using Queue = SmemQueue<kThreads, kSort, true>;

__global__ void __launch_bounds__(kThreads)
chamvs_scan_kernel(const float* __restrict__ luts, long long lut_qs,
                   long long lut_ps, const uint8_t* __restrict__ codes,
                   const int32_t* __restrict__ gids,
                   const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ probe,
                   float* __restrict__ out_d, int32_t* __restrict__ out_i,
                   int nq, int nprobe, int nlist, int cap, int m, int ksub,
                   int kk) {
  extern __shared__ float smem[];
  float* lut = smem;                                  // [m * ksub]
  float* sd = lut + m * ksub;                         // [kSort]
  int* sa = reinterpret_cast<int*>(sd + kSort);       // [kSort]
  int* sg = sa + kSort;                               // [kSort]
  __shared__ QueueScalars qs;
  const Queue queue{sd, sa, sg, kk, &qs};

  const int q = blockIdx.x, s = blockIdx.y, t = threadIdx.x;
  queue.init();

  const bool vec = (m & 15) == 0;
  for (int p = 0; p < nprobe; ++p) {
    __syncthreads();
    const float* lsrc = luts + q * lut_qs + p * lut_ps;
    for (int i = t; i < m * ksub; i += kThreads) lut[i] = lsrc[i];
    __syncthreads();
    const int list = probe[(long long)q * nprobe + p];
    const long long lrow = (long long)s * nlist + list;
    const int len = lens[lrow];
    const uint8_t* cbase = codes + lrow * cap * m;
    const int32_t* gbase = gids + lrow * cap;
    for (int r0 = 0; r0 < len; r0 += kThreads) {
      const int r = r0 + t;
      if (r < len) {
        const uint8_t* row = cbase + (long long)r * m;
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
        // the id is read only for a row that enters the buffer
        const int a = p * cap + r;
        if (queue.beats(d, a)) queue.push(d, a, gbase[r]);
      }
      queue.end_round(1);
    }
  }
  queue.finish();

  const long long o = ((long long)s * nq + q) * kk;
  for (int i = t; i < kk; i += kThreads) {
    out_d[o + i] = sd[i];
    out_i[o + i] = queue.id(i);
  }
}

}  // namespace

// luts: float32, [nq, nprobe, m, ksub] with strides lut_qs / lut_ps (in
// elements) over the query and probe axes (lut_ps = 0 for a LUT shared
// by every probe) and a contiguous [m, ksub] block; codes [S, nlist,
// cap, m] uint8; gids [S, nlist, cap] int32; lens [S, nlist] int32;
// probe [nq, nprobe] int32 -> out_d [S, nq, kk] f32, out_i [S, nq, kk]
// int32.
RT_EXPORT int chamvs_scan_launch(const void* luts, long long lut_qs,
                                 long long lut_ps, const void* codes,
                                 const void* gids, const void* lens,
                                 const void* probe, void* out_d, void* out_i,
                                 int S, int nq, int nprobe, int nlist, int cap,
                                 int m, int ksub, int kk, void* stream) {
  if (kk < 1 || kk > kSort - kThreads) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)m * ksub +
                      (sizeof(float) + 2 * sizeof(int)) * kSort;
  cudaError_t err = cudaFuncSetAttribute(
      chamvs_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nq, S);
  chamvs_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(luts), lut_qs, lut_ps,
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(gids),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(probe),
      static_cast<float*>(out_d), static_cast<int32_t*>(out_i), nq, nprobe,
      nlist, cap, m, ksub, kk);
  return cudaGetLastError();
}
