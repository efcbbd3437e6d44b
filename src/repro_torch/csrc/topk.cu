// Approximate hierarchical top-k (paper §4.2.2): every column block of a
// distance row keeps its k' smallest entries (level 1), then one exact
// merge of the num_blocks * k' survivors per row (level 2).
//
// Replaces: src/repro/kernels/topk/kernel.py:34 hierarchical_topk
//           (body _l1_kernel, kernel.py:21). The reference leaves level 2
//           to XLA outside its kernel (kernel.py:68-74); here it is a
//           second, small launch of the same selection, so a call is one
//           C entry point and two kernels on one stream.
//
// Level 1: one block per (row, column block), 256 threads, on a 1-D grid.
// Each round a thread loads kPerThread entries of the block's columns
// (neighbouring threads on neighbouring columns) and offers them to the
// shared queue of topk_queue.cuh under the key (distance, column): the
// Pallas argmin's lower-column-first order, +inf entries reported as
// id -1. With one block per row and k' = k the same kernel is the exact
// top-k, which is how the wrapper serves tilings the hierarchy cannot
// split (no level 2 then).
// Level 2: one block per row over the row's survivors in (block, rank)
// order, under the key (distance, position). Within a block the
// survivors are already in column order among equal distances, and
// blocks are in column order, so position order is column order: the
// result is the exact top-k of the survivors under (distance, column),
// with the column carried as payload.
//
// Bound on the H100: memory. Level 1 reads the [B, n] rows once (4 bytes
// an entry) against one compare per entry; after the first merge a
// block's threshold admits about k' / columns-seen of its entries, so
// the bitonic merges are few. Level 2 touches B * num_blocks * k'
// entries, kilobytes.
#include <math.h>

#include "topk_queue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSort = 2048;       // queue + candidate buffer, power of two
constexpr int kPerThread = 4;     // entries a thread offers per round

// The k smallest of each row block of d [rows, num_blocks * tile]; with
// ids (level 2) the payload of entry c is ids[row, c], else its column.
template <bool kPayload>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ d, long long row_stride,
            const int32_t* __restrict__ ids, float* __restrict__ out_d,
            int32_t* __restrict__ out_i, int num_blocks, int tile, int k) {
  __shared__ float sd[kSort];
  __shared__ int sa[kSort];
  __shared__ int sg[kPayload ? kSort : 1];
  __shared__ QueueScalars qs;
  const SmemQueue<kThreads, kSort, kPayload> queue{sd, sa, sg, k, &qs};

  const int blk = blockIdx.x % num_blocks, row = blockIdx.x / num_blocks;
  const int t = threadIdx.x;
  const int c_base = blk * tile;
  const long long base = row * row_stride + c_base;
  queue.init();
  __syncthreads();

  for (int c0 = 0; c0 < tile; c0 += kPerThread * kThreads) {
    float v[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = c0 + i * kThreads + t;
      v[i] = c < tile ? d[base + c] : INFINITY;
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = c0 + i * kThreads + t;
      if (c < tile && queue.beats(v[i], c_base + c)) {
        queue.push(v[i], c_base + c, kPayload ? ids[base + c] : 0);
      }
    }
    queue.end_round(kPerThread);
  }
  queue.finish();

  const long long o = (long long)blockIdx.x * k;
  for (int i = t; i < k; i += kThreads) {
    out_d[o + i] = sd[i];
    out_i[o + i] = queue.id(i);
  }
}

}  // namespace

// d: float32 [B, num_blocks * tile] rows with stride row_stride (in
// elements), contiguous along a row. Level 1 writes each block's kp
// smallest to l1_d / l1_i [B, num_blocks, kp]; with num_blocks > 1,
// level 2 merges them into out_d / out_i [B, k] (with num_blocks == 1
// the caller passes kp == k and l1 == out). Ascending, ids are columns,
// -1 on +inf slots.
RT_EXPORT int hierarchical_topk_launch(const void* d, long long row_stride,
                                       void* l1_d, void* l1_i, void* out_d,
                                       void* out_i, int B, int num_blocks,
                                       int tile, int kp, int k,
                                       void* stream) {
  const int max_k = kSort - kPerThread * kThreads;
  if (kp < 1 || kp > max_k || k < 1 || k > max_k || num_blocks < 1 ||
      (num_blocks == 1 && kp != k))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  topk_kernel<false><<<B * num_blocks, kThreads, 0, st>>>(
      static_cast<const float*>(d), row_stride, nullptr,
      static_cast<float*>(l1_d), static_cast<int32_t*>(l1_i), num_blocks,
      tile, kp);
  if (num_blocks > 1) {
    const int n1 = num_blocks * kp;
    topk_kernel<true><<<B, kThreads, 0, st>>>(
        static_cast<const float*>(l1_d), n1,
        static_cast<const int32_t*>(l1_i), static_cast<float*>(out_d),
        static_cast<int32_t*>(out_i), 1, n1, k);
  }
  return cudaGetLastError();
}
