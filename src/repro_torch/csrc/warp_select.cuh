// Warp-wide selection of the smallest (distance, id) keys: a warp holds
// a sorted run of keys in registers and merges sorted or unsorted runs
// into it with bitonic networks of shuffles (ivf_scan.cu, pq_adc.cu,
// topk.cu).
#pragma once

#include "topk_queue.cuh"

// A warp's sorted run of P = 32 R keys: key e = r * 32 + lane in register
// r, ascending; a queue in shared memory holds the first np <= P.
template <int R>
struct WarpKeys {
  float d[R];
  int a[R];

  __device__ __forceinline__ void put(int r, float dv, int av) {
    d[r] = dv;
    a[r] = av;
  }
  // Keeps at slot e the smaller of its key and (dv, av).
  __device__ __forceinline__ void keep_min(int r, float dv, int av) {
    if (key_less(dv, av, d[r], a[r])) put(r, dv, av);
  }
  __device__ __forceinline__ void load(const float* qd, const int* qa,
                                       int np) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = r * 32 + lane;
      put(r, e < np ? qd[e] : INFINITY, e < np ? qa[e] : kQueueIntMax);
    }
  }
  // Key e (the same e in every lane), without indexing registers.
  __device__ __forceinline__ void key(int e, float& kd, int& ka) const {
    kd = d[0];
    ka = a[0];
#pragma unroll
    for (int r = 1; r < R; ++r) {
      if (r == e / 32) {
        kd = d[r];
        ka = a[r];
      }
    }
    kd = __shfl_sync(0xffffffffu, kd, e % 32);
    ka = __shfl_sync(0xffffffffu, ka, e % 32);
  }
  __device__ __forceinline__ void store(float* qd, int* qa, int np) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = r * 32 + lane;
      if (e < np) {
        qd[e] = d[r];
        qa[e] = a[r];
      }
    }
  }
};

// Sorts each of the kQ runs w[x], each a bitonic sequence, ascending:
// compare-exchange at distances 32 R / 2 .. 1, within a lane's registers,
// then across lanes by shuffles. Step by step over the runs, so that kQ
// runs' shuffles are in flight together.
template <int R, int kQ>
__device__ __forceinline__ void bitonic_merge(WarpKeys<R> (&w)[kQ]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = R / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int x = 0; x < kQ; ++x) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r & h) continue;
        if (key_less(w[x].d[r + h], w[x].a[r + h], w[x].d[r], w[x].a[r])) {
          const float td = w[x].d[r];
          const int ta = w[x].a[r];
          w[x].put(r, w[x].d[r + h], w[x].a[r + h]);
          w[x].put(r + h, td, ta);
        }
      }
    }
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    float od[kQ][R];
    int oa[kQ][R];
#pragma unroll
    for (int x = 0; x < kQ; ++x) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        od[x][r] = __shfl_xor_sync(0xffffffffu, w[x].d[r], j);
        oa[x][r] = __shfl_xor_sync(0xffffffffu, w[x].a[r], j);
      }
    }
    const bool lower = (lane & j) == 0;
#pragma unroll
    for (int x = 0; x < kQ; ++x) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (lower == key_less(od[x][r], oa[x][r], w[x].d[r], w[x].a[r]))
          w[x].put(r, od[x][r], oa[x][r]);
      }
    }
  }
}

// Merges sorted list x of np keys (at ld + x * stride) into run w[x]
// (np <= 32 R): the 32 R smallest of both are min(w[e], L[32 R - 1 - e]),
// a bitonic sequence, which one bitonic merge sorts. kGlobal: the lists
// lie in global memory, written by another block of the launch (read
// past L1).
template <bool kGlobal, int R, int kQ>
__device__ __forceinline__ void merge_list(WarpKeys<R> (&w)[kQ],
                                          const float* ld, const int* la,
                                          int stride, int np) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int x = 0; x < kQ; ++x) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int f = 32 * R - 1 - (r * 32 + lane);
      const long long at = (long long)x * stride + f;
      if (f < np)
        w[x].keep_min(r, kGlobal ? __ldcg(ld + at) : ld[at],
                      kGlobal ? __ldcg(la + at) : la[at]);
    }
  }
  bitonic_merge(w);
}

// Sorts kQ sets of one key per lane, each ascending across the warp
// (bitonic, by shuffles, the sets step by step together).
template <int kQ>
__device__ __forceinline__ void warp_sort32(float (&cd)[kQ], int (&ca)[kQ]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      float od[kQ];
      int oa[kQ];
#pragma unroll
      for (int x = 0; x < kQ; ++x) {
        od[x] = __shfl_xor_sync(0xffffffffu, cd[x], j);
        oa[x] = __shfl_xor_sync(0xffffffffu, ca[x], j);
      }
      const bool keep_low = ((lane & j) == 0) == ((lane & k) == 0);
#pragma unroll
      for (int x = 0; x < kQ; ++x) {
        if (keep_low == key_less(od[x], oa[x], cd[x], ca[x])) {
          cd[x] = od[x];
          ca[x] = oa[x];
        }
      }
    }
  }
}

// Merges candidate set x (one unsorted key per lane) into run w[x]: the
// set is sorted, reversed into the run's last 32 slots by the min rule,
// and one bitonic merge sorts the result.
template <int R, int kQ>
__device__ __forceinline__ void merge_candidates(WarpKeys<R> (&w)[kQ],
                                                 float (&cd)[kQ],
                                                 int (&ca)[kQ]) {
  const int lane = threadIdx.x & 31;
  warp_sort32(cd, ca);
#pragma unroll
  for (int x = 0; x < kQ; ++x)
    w[x].keep_min(R - 1, __shfl_sync(0xffffffffu, cd[x], 31 - lane),
                  __shfl_sync(0xffffffffu, ca[x], 31 - lane));
  bitonic_merge(w);
}

// A warp's kQ queues of np keys in shared memory, queue x at qd + x *
// stride: merges candidate x of each lane (cd[x], ca[x]) into queue x,
// unless no candidate beats its queue's last key.
template <int R, int kQ>
__device__ void merge_candidates(float* qd, int* qa, int stride, int np,
                                 const float (&cd)[kQ], const int (&ca)[kQ]) {
  bool any = false;
#pragma unroll
  for (int x = 0; x < kQ; ++x)
    any |= key_less(cd[x], ca[x], qd[x * stride + np - 1],
                    qa[x * stride + np - 1]);
  if (!__any_sync(0xffffffffu, any)) return;
  WarpKeys<R> w[kQ];
  float sd[kQ];
  int sa[kQ];
#pragma unroll
  for (int x = 0; x < kQ; ++x) {
    w[x].load(qd + x * stride, qa + x * stride, np);
    sd[x] = cd[x];
    sa[x] = ca[x];
  }
  merge_candidates(w, sd, sa);
  __syncwarp();
#pragma unroll
  for (int x = 0; x < kQ; ++x) w[x].store(qd + x * stride, qa + x * stride, np);
  __syncwarp();
}

// The same kQ queues: merges into queue x the sorted lists of nb staged
// blocks of keys (block o at ld + o * block; queue x's list at offset
// off + x * stride in it), skipping block `skip`.
template <int R, int kQ>
__device__ void merge_lists(float* qd, int* qa, int stride, int np,
                            const float* ld, const int* la, int block, int nb,
                            int skip, int off) {
  WarpKeys<R> w[kQ];
#pragma unroll
  for (int x = 0; x < kQ; ++x) w[x].load(qd + x * stride, qa + x * stride, np);
  for (int o = 0; o < nb; ++o) {
    if (o == skip) continue;
    const long long at = (long long)o * block + off;
    merge_list<false>(w, ld + at, la + at, stride, np);
  }
  __syncwarp();
#pragma unroll
  for (int x = 0; x < kQ; ++x) w[x].store(qd + x * stride, qa + x * stride, np);
  __syncwarp();
}

// A warp's step of a block's selection of the k smallest keys with no
// block barrier in the scan (adc_scan in pq_adc.cu, topk.cu): each warp
// keeps a sorted run w of 32 R >= k keys in registers and appends the
// keys that beat its filter to its buffer (bd, ba: 64 keys in shared
// memory, cnt of them held). This merges the first 32 keys of the buffer
// (pads past cnt) into the run, then publishes the run's k-th key in
// tau_d / tau_a [kWarps] and takes the least key the block's kWarps warps
// published as the filter (fd, fa): a key that k keys of one warp beat is
// not among the block's k smallest.
template <int kWarps, int R>
__device__ __forceinline__ void flush_buffer(WarpKeys<R> (&w)[1], float* bd,
                                             int* ba, int& cnt,
                                             volatile float* tau_d,
                                             volatile int* tau_a, int k,
                                             float& fd, int& fa) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  float cd[1] = {lane < cnt ? bd[lane] : INFINITY};
  int ca[1] = {lane < cnt ? ba[lane] : kQueueIntMax};
  __syncwarp();
  if (lane + 32 < cnt) {
    bd[lane] = bd[lane + 32];
    ba[lane] = ba[lane + 32];
  }
  cnt = max(0, cnt - 32);
  merge_candidates(w, cd, ca);
  float kd;
  int ka;
  w[0].key(k - 1, kd, ka);
  if (lane == 0) {
    tau_d[threadIdx.x / 32] = kd;
    tau_a[threadIdx.x / 32] = ka;
  }
  float od = INFINITY;
  int oa = kQueueIntMax;
  if (lane < kWarps) {
    od = tau_d[lane];
    oa = tau_a[lane];
  }
#pragma unroll
  for (int off = kWarps / 2; off > 0; off >>= 1) {
    const float xd = __shfl_xor_sync(0xffffffffu, od, off);
    const int xa = __shfl_xor_sync(0xffffffffu, oa, off);
    if (key_less(xd, xa, od, oa)) {
      od = xd;
      oa = xa;
    }
  }
  fd = __shfl_sync(0xffffffffu, od, 0);
  fa = __shfl_sync(0xffffffffu, oa, 0);
  __syncwarp();
}
