// Fused ChamVS scan: PQ asymmetric distances over every shard's probed
// IVF lists, and a running top-kk of (distance, global id) behind it.
//
// Replaces: src/repro/kernels/chamvs_scan/kernel.py:93 fused_scan
//           (body _chamvs_scan_kernel, kernel.py:41, with the queue of
//           kernels/common.py extract_topk_rows).
//
// A block looks its rows up in a LUT (m x ksub float32, 32 KB at m=32)
// in shared memory: the real byte lookup, where the TPU kernel's one-hot
// compare-FMA (kernel.py:51-76) exists only because its vector unit has
// no byte-addressable table. Blocks index the probed lists of the stacked
// shard tables themselves (probe_ids), so the reference's [S, nq, nprobe,
// cap, m] gather of the codes (chamvs_scan/ops.py:60-62) never exists,
// and read only each list's valid prefix (rows < lens): the reference's
// +inf masking (kernel.py:80-82) without the reads. A thread sums its
// row's m terms in index order 0..m-1 in float32 (the plain version sums
// in the same order, bit for bit).
//
// Selection: the shared queue of topk_queue.cuh under the key (distance,
// arrival index = global probe index * cap + row), which is exactly the
// reference queue's stable arrival order. The queue carries only the
// key: the kk winners' global ids are read once, at the end, from their
// arrival index (+inf slots report id -1), so the scan loop never waits
// on a global load for a row that enters the queue.
//
// Bound on the H100: memory, the probed lists' codes (0.17 ms at the
// serve shape). The lookups into the LUT are shared-memory reads at the
// banks the codes pick; a warp looks up one sub-space of 32 consecutive
// rows, and on the serve index's codes that takes ~1.2 wavefronts, a
// floor near 0.08 ms on 132 SMs. The earlier design ran 64 blocks on the
// 132 SMs, paid a DRAM round trip and two barriers for every 256 rows,
// and read a global id for every row that entered the queue. This design:
//  - grid (nq * groups, S): the probed rows of one (query, shard), probe
//    after probe, are split evenly between `groups` blocks by row count
//    (the wrapper picks groups so that two blocks are resident on every
//    SM). Each block keeps its own top-kk under the global key; the last
//    block of the (query, shard) to finish (last_block in common.cuh)
//    offers the others' kk-lists to its queue. That is exact: every
//    global winner is among its own group's kk smallest.
//  - a thread looks up kRows rows a round, their 16-byte code loads all
//    issued before the lookups, so one barrier pair of the queue covers
//    kRows * 256 rows, and the rows' sums interleave. (Staging the next
//    round through shared memory with cp.async, and prefetching it into
//    L2, were both measured slower on the H100: PERF.md.)
//  - a LUT shared by every probe (lut_ps = 0, a non-residual index) is
//    loaded once per block; a residual index reloads it per probe.
//  - the serve index's m = 32 (ksub = 256) reads each row as two 16-byte
//    loads; any other m, and kk past the small queue, takes a byte-load
//    path in the same kernel.
#include <math.h>

#include "adc_rows.cuh"
#include "topk_queue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;   // rows a thread looks up per round

// The probe holding virtual row v (v < pref[nprobe]): the largest p with
// pref[p] <= v, which skips empty probes.
__device__ __forceinline__ int probe_of(const int* pref, int nprobe, int v) {
  int lo = 0, hi = nprobe;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pref[mid] <= v) lo = mid;
    else hi = mid;
  }
  return lo;
}

// V: 16-byte code chunks per row (m = 16 V, ksub = 256); 0 = byte path.
// kSort: the queue's slots, >= kk + kRows * kThreads.
template <int V, int kSort>
__global__ void __launch_bounds__(kThreads, 2)
chamvs_scan_kernel(const float* __restrict__ luts, long long lut_qs,
                   long long lut_ps, const uint8_t* __restrict__ codes,
                   const int32_t* __restrict__ gids,
                   const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ probe,
                   float* __restrict__ out_d, int32_t* __restrict__ out_i,
                   float* __restrict__ part_d, int32_t* __restrict__ part_a,
                   int* __restrict__ counters, int nq, int nprobe, int nlist,
                   int cap, int m, int ksub, int kk, int groups) {
  using Queue = SmemQueue<kThreads, kSort, false>;
  extern __shared__ __align__(16) float smem[];
  float* lut = smem;                                  // [m * ksub]
  float* sd = lut + m * ksub;                         // [kSort]
  int* sa = reinterpret_cast<int*>(sd + kSort);       // [kSort]
  int* pref = sa + kSort;        // [nprobe + 1] first virtual row of a probe
  int* plist = pref + nprobe + 1;                     // [nprobe] its list
  __shared__ QueueScalars qs;
  const Queue queue{sd, sa, nullptr, kk, &qs};

  const int q = blockIdx.x / groups, g = blockIdx.x % groups;
  const int s = blockIdx.y, t = threadIdx.x, lane = t & 31;
  const long long srow = (long long)s * nlist;

  // the probed lists' lengths as a prefix sum: rows of probe p are the
  // virtual rows [pref[p], pref[p + 1])
  if (t < 32) {
    int carry = 0;
    for (int b = 0; b < nprobe; b += 32) {
      const int p = b + lane;
      int x = 0;
      if (p < nprobe) {
        const int l = probe[(long long)q * nprobe + p];
        plist[p] = l;
        x = lens[srow + l];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      if (p < nprobe) pref[p + 1] = carry + x;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) pref[0] = 0;
  }
  queue.init();
  const bool shared_lut = lut_ps == 0;
  const float* lq = luts + (long long)q * lut_qs;
  if (shared_lut) load_lut<kThreads>(lut, lq, m * ksub);
  __syncthreads();

  // this block's even share of the virtual rows
  const int total = pref[nprobe];
  const int lo = (int)((long long)total * g / groups);
  const int hi = (int)((long long)total * (g + 1) / groups);
  constexpr int kRound = kThreads * kRows;
  int pc = lo < total ? probe_of(pref, nprobe, lo) : 0;  // thread's cursor

  for (int v = lo; v < hi;) {
    // a segment of rows that one LUT serves: the rest of the share, or
    // the rest of the probe when every probe has its own LUT
    int end = hi;
    if (!shared_lut) {
      const int p = probe_of(pref, nprobe, v);
      end = min(hi, pref[p + 1]);
      __syncthreads();
      load_lut<kThreads>(lut, lq + p * lut_ps, m * ksub);
      __syncthreads();
    }
    for (int r0 = v; r0 < end; r0 += kRound) {
      long long off[kRows];   // row index in the [S, nlist, cap] tables
      int arr[kRows];         // arrival index, -1 past the segment
      uint4 c[kRows][V > 0 ? V : 1];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i * kThreads + t;
        arr[i] = -1;
#pragma unroll
        for (int k = 0; k < (V > 0 ? V : 1); ++k)
          c[i][k] = make_uint4(0, 0, 0, 0);
        if (r < end) {
          while (r >= pref[pc + 1]) ++pc;
          const int row = r - pref[pc];
          off[i] = (srow + plist[pc]) * cap + row;
          arr[i] = pc * cap + row;
          if (V > 0) {
            const uint4* src =
                reinterpret_cast<const uint4*>(codes + off[i] * m);
#pragma unroll
            for (int k = 0; k < (V > 0 ? V : 1); ++k) c[i][k] = __ldg(src + k);
          }
        }
      }
      float dist[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dist[i] = 0.f;
      if (V > 0) {
        lookup_rows(lut, c, dist);
      } else {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (arr[i] < 0) continue;
          const uint8_t* row = codes + off[i] * m;
          for (int j = 0; j < m; ++j) dist[i] += lut[j * ksub + row[j]];
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (arr[i] >= 0) queue.offer(dist[i], arr[i]);
      queue.end_round(kRows);
    }
    v = end;
  }
  queue.finish();

  const long long qo = (long long)s * nq + q;
  if (groups > 1) {
    const long long po = (qo * groups + g) * kk;
    for (int i = t; i < kk; i += kThreads) {
      part_d[po + i] = sd[i];
      part_a[po + i] = sa[i];
    }
    if (!last_block(counters + qo, groups)) return;
    // the last block offers the other groups' kk-lists to its queue
    for (int g2 = 0; g2 < groups; ++g2) {
      if (g2 == g) continue;
      const long long o2 = (qo * groups + g2) * kk;
      for (int i0 = 0; i0 < kk; i0 += kThreads) {
        const int i = i0 + t;
        if (i < kk)
          queue.offer(__ldcg(part_d + o2 + i), __ldcg(part_a + o2 + i));
        queue.end_round(1);
      }
    }
    queue.finish();
  }
  // the winners' global ids, from their arrival index p * cap + row
  for (int i = t; i < kk; i += kThreads) {
    const int a = sa[i];
    out_d[qo * kk + i] = sd[i];
    out_i[qo * kk + i] =
        isinf(sd[i]) ? -1 : gids[(srow + plist[a / cap]) * cap + a % cap];
  }
}

template <int V, int kSort>
int launch(dim3 grid, size_t smem, cudaStream_t st, const float* luts,
           long long lut_qs, long long lut_ps, const uint8_t* codes,
           const int32_t* gids, const int32_t* lens, const int32_t* probe,
           float* out_d, int32_t* out_i, float* part_d, int32_t* part_a,
           int* counters, int nq, int nprobe, int nlist, int cap, int m,
           int ksub, int kk, int groups) {
  cudaError_t err = cudaFuncSetAttribute(
      chamvs_scan_kernel<V, kSort>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  chamvs_scan_kernel<V, kSort><<<grid, kThreads, smem, st>>>(
      luts, lut_qs, lut_ps, codes, gids, lens, probe, out_d, out_i, part_d,
      part_a, counters, nq, nprobe, nlist, cap, m, ksub, kk, groups);
  return cudaGetLastError();
}

}  // namespace

// luts: float32, [nq, nprobe, m, ksub] with strides lut_qs / lut_ps (in
// elements) over the query and probe axes (lut_ps = 0 for a LUT shared
// by every probe) and a contiguous [m, ksub] block; codes [S, nlist,
// cap, m] uint8; gids [S, nlist, cap] int32; lens [S, nlist] int32;
// probe [nq, nprobe] int32 -> out_d [S, nq, kk] f32, out_i [S, nq, kk]
// int32. groups blocks share each (query, shard); with groups > 1,
// part_d / part_a [S, nq, groups, kk] are scratch and counters [S * nq]
// int32 are zero.
RT_EXPORT int chamvs_scan_launch(const void* luts, long long lut_qs,
                                 long long lut_ps, const void* codes,
                                 const void* gids, const void* lens,
                                 const void* probe, void* out_d, void* out_i,
                                 void* part_d, void* part_a, void* counters,
                                 int S, int nq, int nprobe, int nlist,
                                 int cap, int m, int ksub, int kk, int groups,
                                 void* stream) {
  constexpr int kSmall = 2048, kLarge = 4096;
  if (kk < 1 || kk > kLarge - kThreads * kRows || groups < 1 || nprobe < 1)
    return cudaErrorInvalidValue;
  const bool small = kk <= kSmall - kThreads * kRows;
  const int kSort = small ? kSmall : kLarge;
  const size_t smem = sizeof(float) * ((size_t)m * ksub + 2 * (size_t)kSort +
                                       2 * (size_t)nprobe + 1);
  if (S == 0 || nq == 0) return cudaSuccess;
  const bool vec = small && ksub == 256 && m == 32 &&
                   reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  dim3 grid(nq * groups, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* lf = static_cast<const float*>(luts);
  auto* cb = static_cast<const uint8_t*>(codes);
  auto* gb = static_cast<const int32_t*>(gids);
  auto* lb = static_cast<const int32_t*>(lens);
  auto* pb = static_cast<const int32_t*>(probe);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int32_t*>(out_i);
  auto* pd = static_cast<float*>(part_d);
  auto* pa = static_cast<int32_t*>(part_a);
  auto* cn = static_cast<int*>(counters);
#define CHAMVS_LAUNCH(VV, SORT)                                              \
  launch<VV, SORT>(grid, smem, st, lf, lut_qs, lut_ps, cb, gb, lb, pb, od, oi, \
                   pd, pa, cn, nq, nprobe, nlist, cap, m, ksub, kk, groups)
  if (vec) return CHAMVS_LAUNCH(2, kSmall);
  return small ? CHAMVS_LAUNCH(0, kSmall) : CHAMVS_LAUNCH(0, kLarge);
#undef CHAMVS_LAUNCH
}
