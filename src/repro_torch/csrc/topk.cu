// Approximate hierarchical top-k (paper §4.2.2): every column block of a
// distance row keeps its k' smallest entries (level 1), then one exact
// merge of the num_blocks * k' survivors per row (level 2).
//
// Replaces: src/repro/kernels/topk/kernel.py:34 hierarchical_topk
//           (body _l1_kernel, kernel.py:21). The reference leaves level 2
//           to XLA outside its kernel (kernel.py:68-74); here both levels
//           are one launch.
//
// Every selection is under the key (distance, column): the Pallas
// argmin's lower-column-first order. Level 2 under the same key is the
// reference's merge: its stable sort keeps the survivors in (block, rank)
// order among equal distances, and that is column order, as blocks are
// in column order and each block's survivors are. +inf entries come back
// as id -1. With one block per row and k' = k it is the exact top-k,
// which is how the wrapper serves tilings the hierarchy cannot split.
//
// Bound on the H100: memory, the [B, n] rows read once (4 bytes an entry)
// against one compare an entry; the merges touch B * num_blocks * k'
// entries, kilobytes.
//  - k <= 128 (topk_select_kernel): each column block is cut into
//    `pieces` even column ranges, a block (CTA) each, where the grid
//    needs more blocks (ops.topk_pieces). A warp stages its steps of 512
//    columns through a two-step cp.async ring in shared memory (16-byte
//    copies where the rows allow), the next step in flight while it
//    reads the current one, and keeps a sorted run of its k' smallest
//    keys in registers (flush_buffer in warp_select.cuh, as adc_scan
//    does): no block barrier in the scan. A step whose 512 entries all
//    lie above the filter (most of them, once it has tightened) costs a
//    16-entry compare a lane; the others go through the ballot loop,
//    which is not unrolled, so that the merge's code appears once in it.
//    Warp 0 merges the warps' runs; the column block's last piece merges
//    the pieces' lists, which is exact (every winner is among its own
//    piece's k' smallest); the row's last column block merges the column
//    blocks' lists, each warp some of them and warp 0 the warps' runs.
//    The truncation stays: level 2 sees only each column block's k'
//    smallest.
//  - k > 128 (topk_queue_kernel): one block per column block with the
//    shared queue of topk_queue.cuh, and the row's last column block
//    offers the column blocks' lists to a queue of k slots.
// Both merges find their last block through counters (last_block in
// common.cuh) that it sets back to 0.
#include <math.h>

#include "warp_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 512;        // columns a warp stages a step
constexpr int kStages = 2;        // a warp's ring of staged steps
constexpr int kSort = 2048;       // queue path: queue + candidate buffer
constexpr int kPerThread = 4;     // queue path: entries a thread offers
constexpr int kWarpMaxK = 128;

// Stages the warp's step of kStep columns at column s of a piece ending at
// hi into buf (kStep floats) by cp.async: 16-byte copies (kVec; s and hi
// are multiples of 4) or 4-byte ones; zeros past hi. Commits one group.
template <bool kVec>
__device__ __forceinline__ void stage_step(float* buf, const float* src,
                                           int s, int hi) {
  const int lane = threadIdx.x & 31;
  if (kVec) {
#pragma unroll
    for (int i = 0; i < kStep / 128; ++i) {
      const int e = (i * 32 + lane) * 4;
      cp_async16_zfill(buf + e, src + (s + e < hi ? s + e : s), s + e < hi);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kStep / 32; ++i) {
      const int e = i * 32 + lane;
      cp_async4_zfill(buf + e, src + (s + e < hi ? s + e : s), s + e < hi);
    }
  }
  cp_async_commit();
}

// Writes warp run w's first k keys as a row of the result: ascending,
// -1 for +inf slots.
template <int R>
__device__ __forceinline__ void write_result(const WarpKeys<R>& w,
                                             float* out_d, int32_t* out_i,
                                             int k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    if (e < k) {
      out_d[e] = w.d[r];
      out_i[e] = isinf(w.d[r]) ? -1 : w.a[r];
    }
  }
}

// Block blockIdx.x takes piece p of column block cb = (row, blk).
// part_d / part_a [B * num_blocks, pieces, kp] and l1_d / l1_a
// [B * num_blocks, kp] are scratch; counters [B * num_blocks + B] zero.
// R1: the run for k' <= 32 R1; R2: the level-2 run for k <= 32 R2.
template <bool kVec, int R1, int R2>
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const float* __restrict__ d, long long row_stride,
                   float* __restrict__ part_d, int* __restrict__ part_a,
                   float* __restrict__ l1_d, int* __restrict__ l1_a,
                   float* __restrict__ out_d, int32_t* __restrict__ out_i,
                   int* __restrict__ counters, int B, int num_blocks,
                   int tile, int pieces, int kp, int k) {
  __shared__ float bd[kWarps * 64];
  __shared__ int ba[kWarps * 64];
  __shared__ float rd[kWarps * 32 * R2];
  __shared__ int ra[kWarps * 32 * R2];
  __shared__ float tau_d[kWarps];
  __shared__ int tau_a[kWarps];
  extern __shared__ __align__(16) float stage[];   // [kWarps][kStages][kStep]

  const int p = blockIdx.x % pieces, cb = blockIdx.x / pieces;
  const int blk = cb % num_blocks, row = cb / num_blocks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int unit = kVec ? 4 : 1;
  const int units = tile / unit;
  const int lo = unit * (int)((long long)units * p / pieces);
  const int hi = unit * (int)((long long)units * (p + 1) / pieces);
  const int c_base = blk * tile;
  const float* src = d + row * row_stride + c_base;
  if (lane == 0) {
    tau_d[warp] = INFINITY;
    tau_a[warp] = kQueueIntMax;
  }
  __syncthreads();

  WarpKeys<R1> w[1];
#pragma unroll
  for (int r = 0; r < R1; ++r) w[0].put(r, INFINITY, kQueueIntMax);
  float* wbd = bd + warp * 64;
  int* wba = ba + warp * 64;
  volatile float* vtd = tau_d;
  volatile int* vta = tau_a;
  float fd = INFINITY;        // the filter (warp-uniform)
  int fa = kQueueIntMax;
  int cnt = 0;                // keys in the warp's buffer (warp-uniform)
  const unsigned below = (1u << lane) - 1;
  // the warp's steps at s0 + j * stride, staged kStages - 1 steps ahead
  float* ring = stage + warp * kStages * kStep;
  const int s0 = lo + warp * kStep, stride = kWarps * kStep;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (s0 + t * stride < hi)
      stage_step<kVec>(ring + t * kStep, src, s0 + t * stride, hi);
    else
      cp_async_commit();
  }
  for (int s = s0, j = 0; s < hi; s += stride, ++j) {
    const int ahead = s + (kStages - 1) * stride;
    if (ahead < hi)
      stage_step<kVec>(ring + (j + kStages - 1) % kStages * kStep, src,
                       ahead, hi);
    else
      cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const float* buf = ring + j % kStages * kStep;
    // a lane's 16 entries against the filter first: most steps pass none
    bool any = false;
#pragma unroll
    for (int i = 0; i < kStep / 128; ++i) {
      const int e = (i * 32 + lane) * 4;
      const float4 x = *reinterpret_cast<const float4*>(buf + e);
      any |= (s + e < hi && x.x <= fd) || (s + e + 1 < hi && x.y <= fd) ||
             (s + e + 2 < hi && x.z <= fd) || (s + e + 3 < hi && x.w <= fd);
    }
    if (__any_sync(0xffffffffu, any)) {
      // not unrolled: one copy of the merge in the loop keeps the code
      // small
#pragma unroll 1
      for (int e = lane; e < kStep; e += 32) {
        const float v = buf[e];
        const int c = c_base + s + e;
        const bool pass = s + e < hi && key_less(v, c, fd, fa);
        const unsigned mask = __ballot_sync(0xffffffffu, pass);
        if (pass) {
          const int at = cnt + __popc(mask & below);
          wbd[at] = v;
          wba[at] = c;
        }
        cnt += __popc(mask);
        if (cnt >= 32)
          flush_buffer<kWarps>(w, wbd, wba, cnt, vtd, vta, kp, fd, fa);
      }
    }
    __syncwarp();
  }
  if (cnt > 0) flush_buffer<kWarps>(w, wbd, wba, cnt, vtd, vta, kp, fd, fa);

  // warp 0 merges the other warps' runs
  w[0].store(rd + warp * 32 * R1, ra + warp * 32 * R1, kp);
  __syncthreads();
  if (warp == 0) {
    for (int w2 = 1; w2 < kWarps; ++w2)
      merge_list<false>(w, rd + w2 * 32 * R1, ra + w2 * 32 * R1, 0, kp);
  }
  // the column block's last piece merges the other pieces' lists
  if (pieces > 1) {
    const long long po = ((long long)cb * pieces + p) * kp;
    if (warp == 0) w[0].store(part_d + po, part_a + po, kp);
    if (!last_block(counters + cb, pieces)) return;
    if (warp == 0) {
      for (int p2 = 0; p2 < pieces; ++p2) {
        if (p2 == p) continue;
        const long long o2 = ((long long)cb * pieces + p2) * kp;
        merge_list<true>(w, part_d + o2, part_a + o2, 0, kp);
      }
    }
  }
  if (num_blocks == 1) {          // k' = k: the column block is the row
    if (warp == 0) write_result(w[0], out_d + (long long)row * k,
                                out_i + (long long)row * k, k);
    return;
  }
  // level 2: the row's last column block merges the column blocks' lists
  if (warp == 0) w[0].store(l1_d + (long long)cb * kp,
                            l1_a + (long long)cb * kp, kp);
  if (!last_block(counters + B * num_blocks + row, num_blocks)) return;
  WarpKeys<R2> w2[1];
#pragma unroll
  for (int r = 0; r < R2; ++r) w2[0].put(r, INFINITY, kQueueIntMax);
  for (int b2 = warp; b2 < num_blocks; b2 += kWarps) {
    const long long o2 = ((long long)row * num_blocks + b2) * kp;
    merge_list<true>(w2, l1_d + o2, l1_a + o2, 0, kp);
  }
  const int busy = min(kWarps, num_blocks);
  w2[0].store(rd + warp * 32 * R2, ra + warp * 32 * R2, k);
  __syncthreads();
  if (warp == 0) {
    for (int w3 = 1; w3 < busy; ++w3)
      merge_list<false>(w2, rd + w3 * 32 * R2, ra + w3 * 32 * R2, 0, k);
    write_result(w2[0], out_d + (long long)row * k, out_i + (long long)row * k,
                 k);
  }
}

// The same result for k > 128, one block per column block, with the
// shared queue; l1_d / l1_a and the row counters as above.
__global__ void __launch_bounds__(kThreads)
topk_queue_kernel(const float* __restrict__ d, long long row_stride,
                  float* __restrict__ l1_d, int* __restrict__ l1_a,
                  float* __restrict__ out_d, int32_t* __restrict__ out_i,
                  int* __restrict__ counters, int B, int num_blocks, int tile,
                  int kp, int k) {
  __shared__ float sd[kSort];
  __shared__ int sa[kSort];
  __shared__ QueueScalars qs;
  const SmemQueue<kThreads, kSort, false> queue{sd, sa, nullptr, kp, &qs};

  const int cb = blockIdx.x, blk = cb % num_blocks, row = cb / num_blocks;
  const int t = threadIdx.x;
  const int c_base = blk * tile;
  const float* src = d + row * row_stride + c_base;
  queue.init();
  __syncthreads();
  for (int c0 = 0; c0 < tile; c0 += kPerThread * kThreads) {
    float v[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = c0 + i * kThreads + t;
      v[i] = c < tile ? __ldg(src + c) : INFINITY;
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = c0 + i * kThreads + t;
      if (c < tile) queue.offer(v[i], c_base + c);
    }
    queue.end_round(kPerThread);
  }
  queue.finish();

  float* od = out_d + (long long)row * k;
  int32_t* oi = out_i + (long long)row * k;
  if (num_blocks == 1) {          // k' = k: the column block is the row
    for (int i = t; i < k; i += kThreads) {
      od[i] = sd[i];
      oi[i] = queue.id(i);
    }
    return;
  }
  for (int i = t; i < kp; i += kThreads) {
    l1_d[(long long)cb * kp + i] = sd[i];
    l1_a[(long long)cb * kp + i] = sa[i];
  }
  if (!last_block(counters + B * num_blocks + row, num_blocks)) return;
  const SmemQueue<kThreads, kSort, false> merged{sd, sa, nullptr, k, &qs};
  merged.init();
  __syncthreads();
  for (int b2 = 0; b2 < num_blocks; ++b2) {
    const long long o2 = ((long long)row * num_blocks + b2) * kp;
    for (int i0 = 0; i0 < kp; i0 += kThreads) {
      const int i = i0 + t;
      if (i < kp) merged.offer(__ldcg(l1_d + o2 + i), __ldcg(l1_a + o2 + i));
      merged.end_round(1);
    }
  }
  merged.finish();
  for (int i = t; i < k; i += kThreads) {
    od[i] = sd[i];
    oi[i] = merged.id(i);
  }
}

template <bool kVec, int R1, int R2>
int launch_select(int blocks, cudaStream_t st, const float* d,
                  long long row_stride, float* part_d, int* part_a,
                  float* l1_d, int* l1_a, float* out_d, int32_t* out_i,
                  int* counters, int B, int num_blocks, int tile, int pieces,
                  int kp, int k) {
  const size_t smem = sizeof(float) * kWarps * kStages * kStep;
  cudaError_t err = cudaFuncSetAttribute(
      topk_select_kernel<kVec, R1, R2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  topk_select_kernel<kVec, R1, R2><<<blocks, kThreads, smem, st>>>(
      d, row_stride, part_d, part_a, l1_d, l1_a, out_d, out_i, counters, B,
      num_blocks, tile, pieces, kp, k);
  return cudaGetLastError();
}

template <bool kVec>
int dispatch_select(int r1, int r2, int blocks, cudaStream_t st, const float* d,
                  long long row_stride, float* part_d, int* part_a,
                  float* l1_d, int* l1_a, float* out_d, int32_t* out_i,
                  int* counters, int B, int num_blocks, int tile, int pieces,
                  int kp, int k) {
#define SELECT_ARGS                                                        \
  blocks, st, d, row_stride, part_d, part_a, l1_d, l1_a, out_d, out_i,     \
      counters, B, num_blocks, tile, pieces, kp, k
  if (r1 == 1) {
    if (r2 == 1) return launch_select<kVec, 1, 1>(SELECT_ARGS);
    return r2 == 2 ? launch_select<kVec, 1, 2>(SELECT_ARGS)
                   : launch_select<kVec, 1, 4>(SELECT_ARGS);
  }
  if (r1 == 2)
    return r2 == 2 ? launch_select<kVec, 2, 2>(SELECT_ARGS)
                   : launch_select<kVec, 2, 4>(SELECT_ARGS);
  return launch_select<kVec, 4, 4>(SELECT_ARGS);
#undef SELECT_ARGS
}

}  // namespace

// d: float32 [B, num_blocks * tile] rows with stride row_stride (in
// elements), contiguous along a row -> out_d / out_i [B, k]: the k
// smallest of the row's column blocks' kp smallest, ascending, ids are
// columns, -1 on +inf slots. num_blocks == 1 requires kp == k (the exact
// top-k). pieces: blocks per column block (1 when k > 128). Scratch:
// part_d / part_a [B, num_blocks, pieces, kp] when pieces > 1, l1_d /
// l1_a [B, num_blocks, kp] when num_blocks > 1, counters [B * num_blocks
// + B] int32 zero. vec: rows and tiles are 16-byte aligned.
RT_EXPORT int hierarchical_topk_launch(const void* d, long long row_stride,
                                       void* part_d, void* part_a,
                                       void* l1_d, void* l1_a, void* out_d,
                                       void* out_i, void* counters, int B,
                                       int num_blocks, int tile, int pieces,
                                       int kp, int k, int vec, void* stream) {
  const int max_k = kSort - kPerThread * kThreads;
  if (kp < 1 || kp > k || k > max_k || num_blocks < 1 || tile < 1 ||
      pieces < 1 || (num_blocks == 1 && kp != k) ||
      (k > kWarpMaxK && pieces != 1) || (vec && tile % 4 != 0))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const long long blocks = (long long)B * num_blocks * pieces;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* df = static_cast<const float*>(d);
  auto* pd = static_cast<float*>(part_d);
  auto* pa = static_cast<int*>(part_a);
  auto* ld = static_cast<float*>(l1_d);
  auto* la = static_cast<int*>(l1_a);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int32_t*>(out_i);
  auto* cn = static_cast<int*>(counters);
  if (k > kWarpMaxK) {
    topk_queue_kernel<<<(int)blocks, kThreads, 0, st>>>(
        df, row_stride, ld, la, od, oi, cn, B, num_blocks, tile, kp, k);
    return cudaGetLastError();
  }
  auto runs = [](int x) { return x <= 32 ? 1 : (x <= 64 ? 2 : 4); };
  return vec ? dispatch_select<true>(runs(kp), runs(k), (int)blocks, st, df,
                                     row_stride, pd, pa, ld, la, od, oi, cn,
                                     B, num_blocks, tile, pieces, kp, k)
             : dispatch_select<false>(runs(kp), runs(k), (int)blocks, st, df,
                                      row_stride, pd, pa, ld, la, od, oi, cn,
                                      B, num_blocks, tile, pieces, kp, k);
}
