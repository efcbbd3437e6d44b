// IVF probe: squared L2 from each query to every coarse centroid, and a
// running top-nprobe selection fused behind it.
//
// Replaces: src/repro/kernels/ivf_scan/kernel.py:51 ivf_scan
//           (body _ivf_scan_kernel, kernel.py:22).
//
// One block per tile of up to 8 queries (128 threads). The query tile
// sits in shared memory; centroid tiles of 128 rows stream through
// shared memory 32 dimensions at a time, one centroid per thread, and
// each thread forms q2 - 2 q.c + c2 in float32 for every query of the
// tile with plain FMAs (the reference's formula, kernel.py:33-39). The
// [tile_q, 128] score tile stays in shared memory and is folded at once
// into a per-query queue of the nprobe smallest (distance, centroid id)
// keys, also in shared memory: a warp tests 32 candidates against the
// queue's last key with one ballot and inserts the few that pass in
// sorted position. Ties go to the lower centroid id, the reference's
// rule, and no score ever reaches device memory.
//
// Bound on the H100: the centroid table is read once per query tile,
// nlist * D * 4 bytes, against 2 * nq * nlist * D flops; at serving
// sizes (nq <= 64, nlist <= 32K) both are microseconds and the kernel
// is latency bound. Tensor cores would need TF32, which changes the
// probe ids, so the products stay on the FMA pipes.
#include <math.h>

#include "topk_queue.cuh"

namespace {

constexpr int kThreads = 128;   // = centroid tile
constexpr int kTileQ = 8;
constexpr int kChunk = 32;      // dims staged per step
constexpr int kMaxProbe = 128;
constexpr int kIntMax = 0x7fffffff;

__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const float* __restrict__ queries,
                const float* __restrict__ cents, float* __restrict__ out_d,
                int32_t* __restrict__ out_i, int nq, int nlist, int D,
                int nprobe, int tq) {
  extern __shared__ float smem[];
  float* sq = smem;                              // [tq][D]
  float* sc = sq + kTileQ * D;                   // [128][kChunk + 1]
  float* sd = sc + kThreads * (kChunk + 1);      // [tq][128]
  float* qd = sd + kTileQ * kThreads;            // [tq][nprobe]
  int* qa = reinterpret_cast<int*>(qd + kTileQ * nprobe);
  float* q2 = reinterpret_cast<float*>(qa + kTileQ * nprobe);   // [tq]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q0 = blockIdx.x * tq;
  const int nvalid = min(tq, nq - q0);

  for (int i = t; i < kTileQ * D; i += kThreads) {
    const int r = i / D;
    sq[i] = r < nvalid ? queries[(long long)(q0 + r) * D + i % D] : 0.f;
  }
  for (int i = t; i < tq * nprobe; i += kThreads) {
    qd[i] = INFINITY;
    qa[i] = kIntMax;
  }
  __syncthreads();
  if (t < tq) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += sq[t * D + d] * sq[t * D + d];
    q2[t] = s;
  }

  for (int c0 = 0; c0 < nlist; c0 += kThreads) {
    float acc[kTileQ];
#pragma unroll
    for (int r = 0; r < kTileQ; ++r) acc[r] = 0.f;
    float c2 = 0.f;
    for (int d0 = 0; d0 < D; d0 += kChunk) {
      __syncthreads();
      for (int j = t; j < kThreads * kChunk; j += kThreads) {
        const int row = j / kChunk, col = j % kChunk;
        const int c = c0 + row, d = d0 + col;
        sc[row * (kChunk + 1) + col] =
            (c < nlist && d < D) ? cents[(long long)c * D + d] : 0.f;
      }
      __syncthreads();
      const int dn = min(kChunk, D - d0);
      for (int dd = 0; dd < dn; ++dd) {
        const float cv = sc[t * (kChunk + 1) + dd];
        c2 += cv * cv;
#pragma unroll
        for (int r = 0; r < kTileQ; ++r) acc[r] += sq[r * D + d0 + dd] * cv;
      }
    }
    const bool live = c0 + t < nlist;
    for (int r = 0; r < tq; ++r)
      sd[r * kThreads + t] = live ? (q2[r] - 2.0f * acc[r]) + c2 : INFINITY;
    __syncthreads();

    // fold the score tile into each query's queue: one warp per query
    for (int r = warp; r < tq; r += kThreads / 32) {
      float* rd = qd + r * nprobe;
      int* ra = qa + r * nprobe;
      for (int j0 = 0; j0 < kThreads; j0 += 32) {
        const int cid = c0 + j0 + lane;
        const float cd = cid < nlist ? sd[r * kThreads + j0 + lane] : INFINITY;
        const int ca = cid < nlist ? cid : kIntMax;
        unsigned pass = __ballot_sync(
            0xffffffffu, key_less(cd, ca, rd[nprobe - 1], ra[nprobe - 1]));
        while (pass) {
          const int src = __ffs(pass) - 1;
          pass &= pass - 1;
          const float vd = __shfl_sync(0xffffffffu, cd, src);
          const int va = __shfl_sync(0xffffffffu, ca, src);
          int at = 0;
          for (int e0 = 0; e0 < nprobe; e0 += 32) {
            const int e = e0 + lane;
            at += __popc(__ballot_sync(
                0xffffffffu, e < nprobe && key_less(rd[e], ra[e], vd, va)));
          }
          if (at >= nprobe) continue;   // no longer beats the queue tail
          float keep_d[kMaxProbe / 32];
          int keep_a[kMaxProbe / 32];
#pragma unroll
          for (int k = 0; k < kMaxProbe / 32; ++k) {
            const int e = lane + 32 * k;
            if (e > at && e < nprobe) {
              keep_d[k] = rd[e - 1];
              keep_a[k] = ra[e - 1];
            }
          }
          __syncwarp();
#pragma unroll
          for (int k = 0; k < kMaxProbe / 32; ++k) {
            const int e = lane + 32 * k;
            if (e > at && e < nprobe) {
              rd[e] = keep_d[k];
              ra[e] = keep_a[k];
            }
          }
          if (lane == 0) {
            rd[at] = vd;
            ra[at] = va;
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
  }

  for (int i = t; i < nvalid * nprobe; i += kThreads) {
    const int r = i / nprobe, j = i % nprobe;
    const float d = qd[r * nprobe + j];
    out_d[(long long)(q0 + r) * nprobe + j] = d;
    out_i[(long long)(q0 + r) * nprobe + j] = isinf(d) ? -1 : qa[r * nprobe + j];
  }
}

}  // namespace

// queries [nq, D] f32, centroids [nlist, D] f32 -> out_d [nq, nprobe]
// f32 ascending, out_i [nq, nprobe] int32. tile_q <= 8, nprobe <= 128.
RT_EXPORT int ivf_scan_launch(const void* queries, const void* centroids,
                              void* out_d, void* out_i, int nq, int nlist,
                              int D, int nprobe, int tile_q, void* stream) {
  if (tile_q < 1 || tile_q > kTileQ || nprobe < 1 || nprobe > kMaxProbe)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kTileQ * D + kThreads * (kChunk + 1) +
                                       kTileQ * kThreads + kTileQ) +
                      (sizeof(float) + sizeof(int)) * kTileQ * nprobe;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (nq + tile_q - 1) / tile_q;
  ivf_scan_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(centroids),
      static_cast<float*>(out_d), static_cast<int32_t*>(out_i), nq, nlist, D,
      nprobe, tile_q);
  return cudaGetLastError();
}
