// PQ asymmetric-distance scans of the staged ChamVS path: the per-entry
// scan with its running top-k (adc_scan) and the batched scan of one
// shared code slab (shared_scan).
//
// adc_scan replaces: src/repro/kernels/pq_adc/kernel.py:101 adc_scan
//           (body _adc_scan_kernel, kernel.py:62).
// An entry b is one (query, probe) pair: the top-k of the ADC distances
// over the first lens rows of one IVF list. Its codes are read where
// they lie: at codes + list * n rows, where list is lists[b] (the probed
// list of a shard's [nlist, cap, m] table) or b itself (a gathered
// [B, n, m] batch); its LUT at luts + q * lut_qs + p * lut_ps, where
// b = q * per_q + p, so a non-residual index's one LUT per query
// (lut_ps = 0) is never copied per probe. A block looks rows up in the
// LUT (m x ksub float32, 32 KB at m=32) in shared memory, the real byte
// lookup where the TPU kernel's one-hot compare-FMA (kernel.py:75-80)
// exists only because its vector unit has no byte-addressable table, and
// sums each row's m terms in index order 0..m-1 in float32 (the plain
// version's order, bit for bit). It reads only the valid rows, so the
// codes need no padding.
// Bound on the H100: memory, the valid rows' codes (sum(lens) * m bytes)
// and the distinct LUTs.
//  - an entry's valid rows are cut into parts = ceil(lens / chunk_rows)
//    even chunks, one block each (grid B x chunks; blocks past an entry's
//    parts return at once), so a long list spreads over several blocks
//    and an empty one costs one block that writes (+inf, -1). Every
//    block of the entry computes parts from lens alone. The last block of
//    the entry (last_block in common.cuh) merges the chunks' k-lists,
//    which is exact (every winner is among its own chunk's k smallest),
//    and leaves the entry's counter at 0.
//  - a thread looks up kRows rows a round, their 16-byte code loads all
//    issued before the lookups (m = 32, ksub = 256; any other shape
//    takes a byte-load path), as the fused scan does.
//  - k <= 128 (the staged serve path's k is 63): adc_select_kernel, in
//    which each warp keeps its own sorted run of keys (distance, row) in
//    registers and the scan crosses no block barrier (warp_select.cuh).
//    A queue shared by the block (topk_queue.cuh), whose barrier pairs
//    and sorts dominated blocks of a few thousand rows, is left to larger
//    k (adc_scan_kernel).
// Ties go to the lower row, the reference's order; (+inf, -1) past the
// valid rows.
//  - an LUT too large for shared memory beside the selection (m above
//    ~220 at ksub = 256) is read where it lies, from global memory through
//    L1, by the byte path (kGL); the sums keep their index order, so the
//    distances stay bit-equal to the plain version's.
//
// shared_scan replaces: src/repro/kernels/pq_adc/kernel.py:158
//           shared_scan (body _shared_scan_kernel, kernel.py:142).
// dists[n, q] = sum_j luts[q, j, codes[n, j]] for a query batch against
// one shared code slab. The TPU kernel builds a [tile_n, m * ksub]
// one-hot matrix for its matrix unit (kernel.py:145-155), because the TPU
// has no byte-addressable table; shared memory is one, so no one-hot
// matrix exists here. The one-hot product would also lose on this card:
// it spends 2 m ksub operations an output (1.08 TFLOP at q = 32, n = 2 M,
// m = 32), 1.1 ms in one bf16 pass, and float32 LUT values need three.
// Bound on the H100: the n * q * 4-byte output is most of the bytes, but
// the n * q * m lookups move 4 bytes each from shared memory, at most
// 128 bytes a clock on an SM, which sets the floor at this width.
//  - a block holds TQ = 4 queries' LUTs (128 KB at m = 32, ksub = 256)
//    laid out query fastest, so one 16-byte load serves four queries'
//    terms of a lookup, and one code offset is computed once for them;
//    a row's code bytes are read q / 4 times (from L2, as the query tiles
//    of one chunk run together: they vary fastest across the grid).
//  - a row's four sums leave as one 16-byte store.
//  - each query's m terms add in index order 0..m-1 in float32, the plain
//    version's order, bit for bit.
//  - a query whose one LUT does not fit in shared memory (m above ~220 at
//    ksub = 256) takes a block of its own (TQ = 1) and reads its LUT from
//    global memory through L1 (kGL), in the same order.
#include <math.h>

#include "adc_rows.cuh"
#include "warp_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;          // rows a thread looks up per round
constexpr int kScanThreads = 512;  // shared_scan: threads per block
constexpr int kScanRows = 2;       // shared_scan: rows a thread takes a round

// V: 16-byte code chunks per row (m = 16 V, ksub = 256); 0 = byte path.
// kSort: the queue's slots, >= k + kRows * kThreads. kGL: the LUT is read
// from global memory (byte path only).
template <int V, int kSort, bool kGL>
__global__ void __launch_bounds__(kThreads, 2)
adc_scan_kernel(const float* __restrict__ luts, long long lut_qs,
                long long lut_ps, const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ lists,
                const int32_t* __restrict__ lens, float* __restrict__ out_d,
                int32_t* __restrict__ out_i, float* __restrict__ part_d,
                int32_t* __restrict__ part_a, int* __restrict__ counters,
                int n, int per_q, int m, int ksub, int k, int chunks,
                int chunk_rows) {
  using Queue = SmemQueue<kThreads, kSort, false>;
  static_assert(!kGL || V == 0, "a global LUT takes the byte path");
  extern __shared__ __align__(16) float smem[];
  float* slut = smem;                           // [m * ksub] unless kGL
  float* sd = kGL ? smem : slut + m * ksub;           // [kSort]
  int* sa = reinterpret_cast<int*>(sd + kSort);       // [kSort]
  __shared__ QueueScalars qs;
  const Queue queue{sd, sa, nullptr, k, &qs};

  const int b = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int t = threadIdx.x;
  const int list = lists != nullptr ? lists[b] : b;
  const int len = max(0, min(lens[list], n));
  const int parts = len > 0 ? (len + chunk_rows - 1) / chunk_rows : 1;
  if (c >= parts) return;
  const int lo = (int)((long long)len * c / parts);
  const int hi = (int)((long long)len * (c + 1) / parts);
  const float* glut =
      luts + (b / per_q) * lut_qs + (b % per_q) * lut_ps;
  if (!kGL) load_lut<kThreads>(slut, glut, m * ksub);
  queue.init();
  __syncthreads();

  const uint8_t* base = codes + (long long)list * n * m;
  for (int r0 = lo; r0 < hi; r0 += kThreads * kRows) {
    float dist[kRows];
    if (kGL)
      round_sums<V, kRows, kThreads>(glut, base, m, ksub, r0 + t, hi, dist);
    else
      round_sums<V, kRows, kThreads>(slut, base, m, ksub, r0 + t, hi, dist);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i * kThreads + t;
      if (r < hi) queue.offer(dist[i], r);
    }
    queue.end_round(kRows);
  }
  queue.finish();

  if (parts > 1) {
    const long long po = ((long long)b * chunks + c) * k;
    for (int i = t; i < k; i += kThreads) {
      part_d[po + i] = sd[i];
      part_a[po + i] = sa[i];
    }
    if (!last_block(counters + b, parts)) return;
    // the last block offers the entry's other chunks' k-lists
    for (int c2 = 0; c2 < parts; ++c2) {
      if (c2 == c) continue;
      const long long o2 = ((long long)b * chunks + c2) * k;
      for (int i0 = 0; i0 < k; i0 += kThreads) {
        const int i = i0 + t;
        if (i < k)
          queue.offer(__ldcg(part_d + o2 + i), __ldcg(part_a + o2 + i));
        queue.end_round(1);
      }
    }
    queue.finish();
  }
  const long long o = (long long)b * k;
  for (int i = t; i < k; i += kThreads) {
    out_d[o + i] = sd[i];
    out_i[o + i] = queue.id(i);
  }
}

// The same scan for k <= 32 R, without block barriers: each warp keeps
// its own sorted run of 32 R keys in registers (warp_select.cuh). A row
// whose key beats the warp's filter is appended to the warp's buffer in
// shared memory; each 32 buffered keys are sorted and merged into the run
// by shuffles. The filter is the least of every warp's k-th key (a warp
// publishes its k-th key after each merge), which drops only rows that k
// rows of one warp beat. At the chunk's end warp 0 merges the other
// warps' runs, then, as above, the entry's last block the other chunks'.
template <int V, int R, bool kGL>
__global__ void __launch_bounds__(kThreads, 4)
adc_select_kernel(const float* __restrict__ luts, long long lut_qs,
                  long long lut_ps, const uint8_t* __restrict__ codes,
                  const int32_t* __restrict__ lists,
                  const int32_t* __restrict__ lens, float* __restrict__ out_d,
                  int32_t* __restrict__ out_i, float* __restrict__ part_d,
                  int32_t* __restrict__ part_a, int* __restrict__ counters,
                  int n, int per_q, int m, int ksub, int k, int chunks,
                  int chunk_rows) {
  constexpr int kWarps = kThreads / 32;
  static_assert(!kGL || V == 0, "a global LUT takes the byte path");
  extern __shared__ __align__(16) float smem[];
  float* slut = smem;                           // [m * ksub] unless kGL
  float* bd = kGL ? smem : slut + m * ksub;           // [kWarps][64]
  int* ba = reinterpret_cast<int*>(bd + kWarps * 64);
  float* rd = reinterpret_cast<float*>(ba + kWarps * 64);  // [kWarps][32R]
  int* ra = reinterpret_cast<int*>(rd + kWarps * 32 * R);
  __shared__ float tau_d[kWarps];
  __shared__ int tau_a[kWarps];

  const int b = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int list = lists != nullptr ? lists[b] : b;
  const int len = max(0, min(lens[list], n));
  const int parts = len > 0 ? (len + chunk_rows - 1) / chunk_rows : 1;
  if (c >= parts) return;
  const int lo = (int)((long long)len * c / parts);
  const int hi = (int)((long long)len * (c + 1) / parts);
  const float* glut =
      luts + (b / per_q) * lut_qs + (b % per_q) * lut_ps;
  if (!kGL) load_lut<kThreads>(slut, glut, m * ksub);
  if (lane == 0) {
    tau_d[warp] = INFINITY;
    tau_a[warp] = kQueueIntMax;
  }
  __syncthreads();

  WarpKeys<R> w[1];
#pragma unroll
  for (int r = 0; r < R; ++r) w[0].put(r, INFINITY, kQueueIntMax);
  float* wbd = bd + warp * 64;
  int* wba = ba + warp * 64;
  volatile float* vtd = tau_d;
  volatile int* vta = tau_a;
  float fd = INFINITY;        // the filter (warp-uniform)
  int fa = kQueueIntMax;
  int cnt = 0;                // keys in the warp's buffer (warp-uniform)
  const unsigned below = (1u << lane) - 1;

  const uint8_t* base = codes + (long long)list * n * m;
  for (int r0 = lo + warp * 32; r0 < hi; r0 += kThreads * kRows) {
    float dist[kRows];
    if (kGL)
      round_sums<V, kRows, kThreads>(glut, base, m, ksub, r0 + lane, hi,
                                     dist);
    else
      round_sums<V, kRows, kThreads>(slut, base, m, ksub, r0 + lane, hi,
                                     dist);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i * kThreads + lane;
      const bool pass = r < hi && key_less(dist[i], r, fd, fa);
      const unsigned mask = __ballot_sync(0xffffffffu, pass);
      if (pass) {
        const int at = cnt + __popc(mask & below);
        wbd[at] = dist[i];
        wba[at] = r;
      }
      cnt += __popc(mask);
      if (cnt >= 32)
        flush_buffer<kWarps>(w, wbd, wba, cnt, vtd, vta, k, fd, fa);
    }
  }
  if (cnt > 0) flush_buffer<kWarps>(w, wbd, wba, cnt, vtd, vta, k, fd, fa);

  // warp 0 merges the other warps' runs
  w[0].store(rd + warp * 32 * R, ra + warp * 32 * R, k);
  __syncthreads();
  if (warp == 0) {
    for (int w2 = 1; w2 < kWarps; ++w2)
      merge_list<false>(w, rd + w2 * 32 * R, ra + w2 * 32 * R, 0, k);
  }
  if (parts > 1) {
    const long long po = ((long long)b * chunks + c) * k;
    if (warp == 0) w[0].store(part_d + po, part_a + po, k);
    if (!last_block(counters + b, parts)) return;
    if (warp == 0) {
      for (int c2 = 0; c2 < parts; ++c2) {
        if (c2 == c) continue;
        const long long o2 = ((long long)b * chunks + c2) * k;
        merge_list<true>(w, part_d + o2, part_a + o2, 0, k);
      }
    }
  }
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = r * 32 + lane;
      if (e < k) {
        out_d[(long long)b * k + e] = w[0].d[r];
        out_i[(long long)b * k + e] = isinf(w[0].d[r]) ? -1 : w[0].a[r];
      }
    }
  }
}

template <int V, int R, bool kGL>
int launch_select(int blocks, size_t smem, cudaStream_t st, const float* luts,
                  long long lut_qs, long long lut_ps, const uint8_t* codes,
                  const int32_t* lists, const int32_t* lens, float* out_d,
                  int32_t* out_i, float* part_d, int32_t* part_a,
                  int* counters, int n, int per_q, int m, int ksub, int k,
                  int chunks, int chunk_rows) {
  cudaError_t err = cudaFuncSetAttribute(
      adc_select_kernel<V, R, kGL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  adc_select_kernel<V, R, kGL><<<blocks, kThreads, smem, st>>>(
      luts, lut_qs, lut_ps, codes, lists, lens, out_d, out_i, part_d, part_a,
      counters, n, per_q, m, ksub, k, chunks, chunk_rows);
  return cudaGetLastError();
}

template <int V, int kSort, bool kGL>
int launch_adc(int blocks, size_t smem, cudaStream_t st, const float* luts,
               long long lut_qs, long long lut_ps, const uint8_t* codes,
               const int32_t* lists, const int32_t* lens, float* out_d,
               int32_t* out_i, float* part_d, int32_t* part_a, int* counters,
               int n, int per_q, int m, int ksub, int k, int chunks,
               int chunk_rows) {
  cudaError_t err = cudaFuncSetAttribute(
      adc_scan_kernel<V, kSort, kGL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  adc_scan_kernel<V, kSort, kGL><<<blocks, kThreads, smem, st>>>(
      luts, lut_qs, lut_ps, codes, lists, lens, out_d, out_i, part_d, part_a,
      counters, n, per_q, m, ksub, k, chunks, chunk_rows);
  return cudaGetLastError();
}

// shared_scan's terms of one lookup: the TQ floats at p (one per query of
// the tile, 16-, 8- or 4-byte aligned), added to the tile's sums.
template <int TQ>
__device__ __forceinline__ void add_terms(float (&acc)[TQ], const float* p) {
  if constexpr (TQ == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  } else if constexpr (TQ == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    acc[0] += v.x;
    acc[1] += v.y;
  } else {
    acc[0] += *p;
  }
}

// shared_scan: a block holds the LUTs of TQ queries in shared memory,
// query fastest ([m * ksub][TQ]), and takes a chunk of rows; a thread
// looks up kR rows a round (their code loads issued first), each lookup
// one TQ-wide load that serves the tile's TQ queries, and stores a row's
// TQ sums as one vector when q % TQ == 0.
// V: 16-byte code chunks per row (m = 16 V, ksub = 256); 0 = byte path.
// kGL (TQ = 1, byte path): the query's LUT is read from global memory.
template <int TQ, int V, int kT, int kR, bool kGL>
__global__ void __launch_bounds__(kT, 1)
shared_scan_kernel(const float* __restrict__ luts,
                   const uint8_t* __restrict__ codes, float* __restrict__ out,
                   int n, int q, int m, int ksub, int rows_per_block) {
  static_assert(!kGL || (TQ == 1 && V == 0), "a global LUT: one query, "
                "the byte path");
  extern __shared__ __align__(16) float slut[];       // [m * ksub][TQ]
  const int q0 = blockIdx.x * TQ, t = threadIdx.x;
  const int nq = min(TQ, q - q0);
  const int tab = m * ksub;
  const float* lut = kGL ? luts + (long long)q0 * tab : slut;
  if (!kGL) {
#pragma unroll
    for (int qi = 0; qi < TQ; ++qi) {
      const float* src = luts + (long long)(q0 + qi) * tab;
      for (int e = t; e < tab; e += kT)
        slut[e * TQ + qi] = qi < nq ? __ldg(src + e) : 0.f;
    }
  }
  __syncthreads();

  const bool vec_out = q % TQ == 0;
  const long long lo = (long long)blockIdx.y * rows_per_block;
  const long long hi = min((long long)n, lo + rows_per_block);
  for (long long r0 = lo + t; r0 < hi; r0 += (long long)kT * kR) {
    float acc[kR][TQ];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int qi = 0; qi < TQ; ++qi) acc[i][qi] = 0.f;
    }
    if constexpr (V > 0) {
      uint4 c[kR][V];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const long long r = r0 + (long long)i * kT;
        const uint4* src = reinterpret_cast<const uint4*>(codes + r * m);
#pragma unroll
        for (int j = 0; j < V; ++j)
          c[i][j] = r < hi ? __ldg(src + j) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int by = 0; by < 4; ++by) {
#pragma unroll
            for (int i = 0; i < kR; ++i) {
              const unsigned w =
                  reinterpret_cast<const unsigned*>(&c[i][j])[e];
              const int code = (w >> (8 * by)) & 0xffu;
              add_terms(acc[i],
                        slut + ((j * 16 + e * 4 + by) * 256 + code) * TQ);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const long long r = r0 + (long long)i * kT;
        if (r >= hi) continue;
        const uint8_t* row = codes + r * m;
        if (kGL) {
          for (int j = 0; j < m; ++j)
            acc[i][0] += __ldg(lut + j * ksub + row[j]);
        } else {
          for (int j = 0; j < m; ++j)
            add_terms(acc[i], slut + (j * ksub + row[j]) * TQ);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const long long r = r0 + (long long)i * kT;
      if (r >= hi) continue;
      float* o = out + r * q + q0;
      if constexpr (TQ == 4) {
        if (vec_out) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          continue;
        }
      } else if constexpr (TQ == 2) {
        if (vec_out) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[i][0], acc[i][1]);
          continue;
        }
      }
#pragma unroll
      for (int qi = 0; qi < TQ; ++qi) {
        if (qi < nq) o[qi] = acc[i][qi];
      }
    }
  }
}

template <int TQ, int V, bool kGL = false>
int launch_shared(dim3 grid, cudaStream_t st, const float* luts,
                  const uint8_t* codes, float* out, int n, int q, int m,
                  int ksub, int rows_per_block) {
  const size_t smem = kGL ? 0 : sizeof(float) * TQ * (size_t)m * ksub;
  auto kernel = shared_scan_kernel<TQ, V, kScanThreads, kScanRows, kGL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kScanThreads, smem, st>>>(luts, codes, out, n, q, m, ksub,
                                           rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// Entry b = q * per_q + p: its LUT is float32 [m, ksub], contiguous, at
// luts + q * lut_qs + p * lut_ps (in elements); its codes are the rows
// [list * n, list * n + n) of codes [*, n, m] uint8, and it scans the
// first lens[list] of them, where list = lists[b] (int32 [B]), or b when
// lists is null -> out_d [B, k] f32 ascending, out_i [B, k] int32 (row
// within n, -1 on +inf slots). chunk_rows: a block's most rows; chunks
// = ceil(n / chunk_rows) blocks per entry. With chunks > 1, part_d /
// part_a [B, chunks, k] are scratch and counters [B] int32 are zero.
// vec: the code rows are 16-byte aligned.
RT_EXPORT int adc_scan_launch(const void* luts, long long lut_qs,
                              long long lut_ps, const void* codes,
                              const void* lists, const void* lens,
                              void* out_d, void* out_i, void* part_d,
                              void* part_a, void* counters, int B, int n,
                              int per_q, int m, int ksub, int k,
                              int chunk_rows, int vec, void* stream) {
  constexpr int kSmall = 2048, kLarge = 4096;
  if (k < 1 || k > kLarge - kThreads * kRows || chunk_rows < 1 ||
      per_q < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const bool small = k <= kSmall - kThreads * kRows;
  const int kSort = small ? kSmall : kLarge;
  const size_t lut_bytes = sizeof(float) * (size_t)m * ksub;
  const size_t queue_bytes = (sizeof(float) + sizeof(int)) * kSort;
  const bool glut = lut_bytes + queue_bytes > kSmemLimit;
  const size_t smem = (glut ? 0 : lut_bytes) + queue_bytes;
  const int chunks = n > 0 ? (n + chunk_rows - 1) / chunk_rows : 1;
  const long long blocks = (long long)B * chunks;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* lf = static_cast<const float*>(luts);
  auto* cb = static_cast<const uint8_t*>(codes);
  auto* li = static_cast<const int32_t*>(lists);
  auto* lb = static_cast<const int32_t*>(lens);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int32_t*>(out_i);
  auto* pd = static_cast<float*>(part_d);
  auto* pa = static_cast<int32_t*>(part_a);
  auto* cn = static_cast<int*>(counters);
  const bool v2 = vec && m == 32 && ksub == 256 && !glut;
#define ADC_ARGS(SMEM)                                                      \
  (int)blocks, SMEM, st, lf, lut_qs, lut_ps, cb, li, lb, od, oi, pd, pa, cn, \
      n, per_q, m, ksub, k, chunks, chunk_rows
  if (k <= 128) {
    const int R = k <= 32 ? 1 : (k <= 64 ? 2 : 4);
    const size_t runs = (sizeof(float) + sizeof(int)) * kThreads / 32 *
                        (64 + 32 * (size_t)R);
    const bool sglut = lut_bytes + runs > kSmemLimit;
    const size_t ssmem = (sglut ? 0 : lut_bytes) + runs;
    if (sglut) {
      if (R == 1) return launch_select<0, 1, true>(ADC_ARGS(ssmem));
      return R == 2 ? launch_select<0, 2, true>(ADC_ARGS(ssmem))
                    : launch_select<0, 4, true>(ADC_ARGS(ssmem));
    }
    if (v2) {
      if (R == 1) return launch_select<2, 1, false>(ADC_ARGS(ssmem));
      return R == 2 ? launch_select<2, 2, false>(ADC_ARGS(ssmem))
                    : launch_select<2, 4, false>(ADC_ARGS(ssmem));
    }
    if (R == 1) return launch_select<0, 1, false>(ADC_ARGS(ssmem));
    return R == 2 ? launch_select<0, 2, false>(ADC_ARGS(ssmem))
                  : launch_select<0, 4, false>(ADC_ARGS(ssmem));
  }
  if (glut)
    return small ? launch_adc<0, kSmall, true>(ADC_ARGS(smem))
                 : launch_adc<0, kLarge, true>(ADC_ARGS(smem));
  if (v2 && small) return launch_adc<2, kSmall, false>(ADC_ARGS(smem));
  return small ? launch_adc<0, kSmall, false>(ADC_ARGS(smem))
               : launch_adc<0, kLarge, false>(ADC_ARGS(smem));
#undef ADC_ARGS
}

// luts: float32 [q, m, ksub], contiguous; codes [n, m] uint8, contiguous
// -> out [n, q] f32. tq: queries per block (1, 2 or 4; tq LUTs must fit
// in shared memory, or tq = 1 reads its LUT from global memory);
// rows_per_block: rows of one block's chunk; vec: the code rows are
// 16-byte aligned.
RT_EXPORT int shared_scan_launch(const void* luts, const void* codes,
                                 void* out, int n, int q, int m, int ksub,
                                 int tq, int rows_per_block, int vec,
                                 void* stream) {
  if ((tq != 1 && tq != 2 && tq != 4) || rows_per_block < 1)
    return cudaErrorInvalidValue;
  if (n == 0 || q == 0) return cudaSuccess;
  const long long chunks = ((long long)n + rows_per_block - 1) / rows_per_block;
  if (chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid((q + tq - 1) / tq, (unsigned)chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* lf = static_cast<const float*>(luts);
  auto* cb = static_cast<const uint8_t*>(codes);
  auto* of = static_cast<float*>(out);
  const bool v2 = vec && m == 32 && ksub == 256;
#define SHARED_ARGS grid, st, lf, cb, of, n, q, m, ksub, rows_per_block
  if (sizeof(float) * tq * (size_t)m * ksub > kSmemLimit) {
    if (tq != 1) return cudaErrorInvalidValue;
    return launch_shared<1, 0, true>(SHARED_ARGS);
  }
  if (tq == 4)
    return v2 ? launch_shared<4, 2>(SHARED_ARGS)
              : launch_shared<4, 0>(SHARED_ARGS);
  if (tq == 2)
    return v2 ? launch_shared<2, 2>(SHARED_ARGS)
              : launch_shared<2, 0>(SHARED_ARGS);
  return v2 ? launch_shared<1, 2>(SHARED_ARGS)
            : launch_shared<1, 0>(SHARED_ARGS);
#undef SHARED_ARGS
}
