// IVF probe: squared L2 from each query to every coarse centroid, and the
// nprobe smallest (distance, centroid id) keys of each query.
//
// Replaces: src/repro/kernels/ivf_scan/kernel.py:51 ivf_scan
//           (body _ivf_scan_kernel, kernel.py:22).
//
// Bound on the H100: the centroid table, nlist * D * 4 bytes, against
// 2 * nq * nlist * D float32 operations on the FMA pipes (tensor cores
// would need TF32, which changes the probe ids). At 32 queries the two
// are near each other (16 operations a byte against the card's 20), so a
// block must stream centroids while it multiplies. At the serve index's
// nlist = 256 both are microseconds and the grid's width sets the time.
//
// Design:
//  - grid (query tiles, centroid splits): the wrapper picks (ops.
//    probe_grid) the split so that about two blocks are resident on every
//    SM, with one kTC-centroid tile a block at least, and 32 queries a
//    block, or 16 where 32 would leave most SMs without a block (the
//    serve index's 256 centroids make 8 splits).
//  - a block walks its split in tiles of kTC centroids; each tile's
//    queries and centroids stream through a kStages-deep ring of kKD-dim
//    chunks in shared memory (16-byte cp.async, zero-filled past the
//    edges; four copies a thread per chunk, three chunks in flight).
//  - the 256 threads form kKS groups that split each chunk's dims; in a
//    group a thread accumulates a 4 x 4 (query, centroid) tile of dot
//    products in float32 FMAs from 16-byte shared-memory reads. At the
//    tile's end the groups' partial sums are added in group order, and
//    dist = (|q|^2 - 2 q.c) + |c|^2, the reference's formula
//    (kernel.py:33-39); |q|^2 and |c|^2 are summed from the staged
//    chunks, eight lanes' parts added by shuffles. Every (query,
//    centroid) pair is summed in the same order wherever it sits, so
//    equal centroids give equal distances.
//  - a warp owns kTQ / 8 queries' queues (nprobe keys each, sorted, in
//    shared memory). A tile's 32 candidates of each, when one beats its
//    queue's last key, are bitonic-sorted by shuffles and merged with
//    the queue by one bitonic merge (warp_select.cuh): a fixed number of
//    shuffle steps, whatever the number that enter, the queries' steps
//    interleaved.
//  - the splits' lists are merged in the same launch, exactly (every
//    global winner is among its own split's nprobe smallest), by a tree
//    of fan-in fan_in: each block writes its list to scratch, and the last
//    block of each group (last_block in common.cuh) stages the group's
//    lists in shared memory with cp.async, merges them into its queues
//    (merge_lists) and moves up a level. The counters are left at 0.
// Ties go to the lower centroid id, the reference's rule; (+inf, -1) past
// nlist.
#include <math.h>

#include "warp_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTC = 32;                // centroids per tile
constexpr int kKD = 64;                // dims per staged chunk
constexpr int kStages = 4;             // cp.async ring depth
constexpr int kLd = kKD + 4;           // row stride of a staged chunk
constexpr int kRedLd = kTC + 8;        // row stride of the partial sums

// The shared-memory layout and thread groups of a block of kTQ queries
// (32, or 16 where a grid of 32-query blocks would leave most SMs idle).
template <int kTQ>
struct Layout {
  static constexpr int kStage = (kTQ + kTC) * kLd;  // one ring stage
  static constexpr int kGroup = kTQ / 4 * 8;        // threads of a dim group
  static constexpr int kKS = kThreads / kGroup;     // dim groups
  static constexpr int kFree =                      // ring + partial sums
      kStages * kStage + kKS * kTQ * kRedLd;
  static constexpr int kCopies = (kTQ + kTC) * (kKD / 4) / kThreads;
  static constexpr int kQW = kTQ / kWarps;          // queries a warp merges
  static constexpr int kFloats =                    // all but the queues
      kFree + kTQ * (kTC + 1) + kTQ + kTC;
};

// R: the queue's registers a lane (nprobe <= 32 R); kTQ: queries a block.
template <int R, int kTQ>
__global__ void __launch_bounds__(kThreads, 2)
ivf_scan_kernel(const float* __restrict__ queries,
                const float* __restrict__ cents, float* __restrict__ out_d,
                int32_t* __restrict__ out_i, float* __restrict__ part_d,
                int32_t* __restrict__ part_a, int* __restrict__ counters,
                int nq, int nlist, int D, int nprobe, int per_block,
                int splits, int fan_in, int slots, int n_counters) {
  using L = Layout<kTQ>;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // [kStages][kStage]
  float* red = ring + kStages * L::kStage;             // [kKS][kTQ][kRedLd]
  float* sd = red + L::kKS * kTQ * kRedLd;             // [kTQ][kTC + 1]
  float* q2 = sd + kTQ * (kTC + 1);                    // [kTQ]
  float* c2 = q2 + kTQ;                                // [kTC]
  float* qd = c2 + kTC;                                // [kTQ][nprobe]
  int* qa = reinterpret_cast<int*>(qd + kTQ * nprobe); // [kTQ][nprobe]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int qt = blockIdx.x, q0 = qt * kTQ;
  const int c_lo = blockIdx.y * per_block;
  const int c_hi = min(nlist, c_lo + per_block);
  const int chunks = (D + kKD - 1) / kKD;
  const int steps = max(0, (c_hi - c_lo + kTC - 1) / kTC) * chunks;

  // this thread's copies of every step: rows of the [queries; centroids]
  // stage and their dims within a chunk
  int c_row[L::kCopies], c_col[L::kCopies];
#pragma unroll
  for (int u = 0; u < L::kCopies; ++u) {
    const int i = t + u * kThreads;
    c_row[u] = i / (kKD / 4);
    c_col[u] = (i % (kKD / 4)) * 4;
  }
  // step s stages the queries and tile s / chunks' centroids, dims of
  // chunk s % chunks; every thread commits one group per step
  auto issue = [&](int s) {
    if (s < steps) {
      const int tile = s / chunks, d0 = (s - tile * chunks) * kKD;
      const int c0 = c_lo + tile * kTC;
      float* dst = ring + (s % kStages) * L::kStage;
#pragma unroll
      for (int u = 0; u < L::kCopies; ++u) {
        const int row = c_row[u], d = d0 + c_col[u];
        const bool isq = row < kTQ;
        const int r = isq ? q0 + row : c0 + row - kTQ;
        const bool ok = (isq ? r < nq : r < c_hi) && d < D;
        const float* src = (isq ? queries : cents) +
                           (ok ? (long long)r * D + d : 0);
        cp_async16_zfill(dst + row * kLd + c_col[u], src, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int i = t; i < kTQ * nprobe; i += kThreads) {
    qd[i] = INFINITY;
    qa[i] = kQueueIntMax;
  }

  // thread roles: group kg takes dims [kg * kKD / kKS, ...) of a chunk;
  // in it, queries ty + kTQ / 4 * i and centroids tx + 8 j (a quarter-warp
  // reads one query row and eight centroid rows: no bank conflicts). For
  // the squared norms, thread t sums 8 dims of query row t / 8 (if there
  // is one) and of centroid row t / 8; eight lanes' sums are added by
  // shuffles.
  const int kg = t / L::kGroup, ty = (t % L::kGroup) / 8, tx = t % 8;
  const int k0 = kg * (kKD / L::kKS);
  const int n_row = t / 8, n_col = (t % 8) * 8;
  float acc[4][4] = {};
  float q2p = 0.f, c2p = 0.f;

  for (int s = 0, d_i = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(s + kStages - 1);
    const float* sq = ring + (s % kStages) * L::kStage;
    const float* sc = sq + kTQ * kLd;
#pragma unroll
    for (int kk = 0; kk < kKD / L::kKS; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            sq + (ty + kTQ / 4 * i) * kLd + k0 + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(sc + (tx + 8 * j) * kLd +
                                                k0 + kk);
      // dim by dim over the 16 accumulators: each still adds its dims in
      // order, and 15 independent FMAs separate two dependent ones
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(reinterpret_cast<const float*>(&a[i])[u],
                             reinterpret_cast<const float*>(&b[j])[u],
                             acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 u = reinterpret_cast<const float4*>(
          sq + n_row * kLd + n_col)[h];
      const float4 v = reinterpret_cast<const float4*>(
          sc + n_row * kLd + n_col)[h];
      q2p = fmaf(u.x, u.x, q2p);
      q2p = fmaf(u.y, u.y, q2p);
      q2p = fmaf(u.z, u.z, q2p);
      q2p = fmaf(u.w, u.w, q2p);
      c2p = fmaf(v.x, v.x, c2p);
      c2p = fmaf(v.y, v.y, c2p);
      c2p = fmaf(v.z, v.z, c2p);
      c2p = fmaf(v.w, v.w, c2p);
    }
    if (++d_i < chunks) continue;
    d_i = 0;

    // the tile is summed: the groups' sums in group order, then distances
    // and each query's queue merge
    const int c0 = c_lo + (s / chunks) * kTC;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[(kg * kTQ + ty + kTQ / 4 * i) * kRedLd + tx + 8 * j] =
            acc[i][j];
        acc[i][j] = 0.f;
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      q2p += __shfl_xor_sync(0xffffffffu, q2p, off);
      c2p += __shfl_xor_sync(0xffffffffu, c2p, off);
    }
    if (t % 8 == 0) {
      if (n_row < kTQ) q2[n_row] = q2p;
      c2[n_row] = c2p;
    }
    q2p = c2p = 0.f;
    __syncthreads();
    for (int i = t; i < kTQ * kTC; i += kThreads) {
      const int r = i / kTC, c = i % kTC;
      float dot = red[r * kRedLd + c];
#pragma unroll
      for (int g = 1; g < L::kKS; ++g)
        dot += red[(g * kTQ + r) * kRedLd + c];
      sd[r * (kTC + 1) + c] = (q2[r] - 2.0f * dot) + c2[c];
    }
    __syncthreads();
    const bool ok = c0 + lane < c_hi;
    float cd[L::kQW];
    int ca[L::kQW];
#pragma unroll
    for (int x = 0; x < L::kQW; ++x) {
      cd[x] = ok ? sd[(warp + kWarps * x) * (kTC + 1) + lane] : INFINITY;
      ca[x] = ok ? c0 + lane : kQueueIntMax;
    }
    merge_candidates<R, L::kQW>(qd + warp * nprobe, qa + warp * nprobe,
                             kWarps * nprobe, nprobe, cd, ca);
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the splits' lists: a tree of fan-in fan_in over the splits; a
  // merging block stages the other members' lists in the ring's space
  const int list = kTQ * nprobe;                       // one split's keys
  const int batch = max(1, L::kFree / (2 * list));     // lists a stage
  float* stage_d = smem;
  int* stage_a = reinterpret_cast<int*>(smem + batch * list);
  int idx = blockIdx.y, n = splits, slot0 = 0, cnt0 = 0;
  while (n > 1) {
    const int group = idx / fan_in, first = group * fan_in;
    const int members = min(fan_in, n - first);
    if (members > 1) {
      float* pd = part_d + ((long long)qt * slots + slot0) * list;
      int32_t* pa = part_a + ((long long)qt * slots + slot0) * list;
      for (int i = t; i < list; i += kThreads) {
        pd[(long long)idx * list + i] = qd[i];
        pa[(long long)idx * list + i] = qa[i];
      }
      if (!last_block(counters + qt * n_counters + cnt0 + group, members))
        return;
      for (int b0 = first; b0 < first + members; b0 += batch) {
        const int nb = min(batch, first + members - b0);
        for (int i = t * 4; i < nb * list; i += kThreads * 4) {
          cp_async16(stage_d + i, pd + (long long)b0 * list + i);
          cp_async16(stage_a + i, pa + (long long)b0 * list + i);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        merge_lists<R, L::kQW>(qd + warp * nprobe, qa + warp * nprobe,
                            kWarps * nprobe, nprobe, stage_d, stage_a, list,
                            nb, b0 <= idx && idx < b0 + nb ? idx - b0 : -1,
                            warp * nprobe);
        __syncthreads();
      }
    }
    slot0 += n;
    cnt0 += (n + fan_in - 1) / fan_in;
    idx = group;
    n = (n + fan_in - 1) / fan_in;
  }

  for (int i = t; i < kTQ * nprobe; i += kThreads) {
    const int r = i / nprobe;
    if (q0 + r >= nq) break;
    const long long o = (long long)q0 * nprobe + i;
    out_d[o] = qd[i];
    out_i[o] = isinf(qd[i]) ? -1 : qa[i];
  }
}

template <int R, int kTQ>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t st,
                   const float* queries, const float* cents, float* out_d,
                   int32_t* out_i, float* part_d, int32_t* part_a,
                   int* counters, int nq, int nlist, int D, int nprobe,
                   int per_block, int splits, int fan_in, int slots,
                   int n_counters) {
  cudaError_t err = cudaFuncSetAttribute(
      ivf_scan_kernel<R, kTQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ivf_scan_kernel<R, kTQ><<<grid, kThreads, smem, st>>>(
      queries, cents, out_d, out_i, part_d, part_a, counters, nq, nlist, D,
      nprobe, per_block, splits, fan_in, slots, n_counters);
  return cudaGetLastError();
}

}  // namespace

// queries [nq, D] f32, centroids [nlist, D] f32 (contiguous, 16-byte
// aligned, D % 4 == 0) -> out_d [nq, nprobe] f32 ascending, out_i
// [nq, nprobe] int32. A block takes tile_q (16 or 32) queries; each of
// the `splits` blocks of a query tile takes per_block centroids (a
// multiple of 32). With splits > 1: part_d / part_a hold [q tiles, slots,
// tile_q, nprobe] scratch and counters [q tiles, n_counters] int32 are
// zero (ops.merge_plan sizes both).
RT_EXPORT int ivf_scan_launch(const void* queries, const void* centroids,
                              void* out_d, void* out_i, void* part_d,
                              void* part_a, void* counters, int nq,
                              int nlist, int D, int nprobe, int tile_q,
                              int per_block, int splits, int fan_in,
                              int slots, int n_counters, void* stream) {
  if (nprobe < 1 || nprobe > 128 || (tile_q != 16 && tile_q != 32) ||
      per_block < kTC || per_block % kTC || splits < 1 || fan_in < 2 ||
      D < 4 || D % 4)
    return cudaErrorInvalidValue;
  if (nq == 0) return cudaSuccess;
  const size_t floats = tile_q == 16 ? Layout<16>::kFloats
                                     : Layout<32>::kFloats;
  const size_t smem = sizeof(float) * floats +
                      (sizeof(float) + sizeof(int)) * tile_q * (size_t)nprobe;
  const dim3 grid((nq + tile_q - 1) / tile_q, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* q = static_cast<const float*>(queries);
  auto* c = static_cast<const float*>(centroids);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int32_t*>(out_i);
  auto* pd = static_cast<float*>(part_d);
  auto* pa = static_cast<int32_t*>(part_a);
  auto* cn = static_cast<int*>(counters);
#define IVF_LAUNCH(RR, TQ)                                                   \
  launch<RR, TQ>(grid, smem, st, q, c, od, oi, pd, pa, cn, nq, nlist, D,      \
                 nprobe, per_block, splits, fan_in, slots, n_counters)
  if (tile_q == 16) {
    if (nprobe <= 32) return IVF_LAUNCH(1, 16);
    return nprobe <= 64 ? IVF_LAUNCH(2, 16) : IVF_LAUNCH(4, 16);
  }
  if (nprobe <= 32) return IVF_LAUNCH(1, 32);
  return nprobe <= 64 ? IVF_LAUNCH(2, 32) : IVF_LAUNCH(4, 32);
#undef IVF_LAUNCH
}
