// The k-smallest queue shared by the port's selection kernels
// (chamvs_scan.cu, pq_adc.cu, topk.cu), and its key order.
//
// A block keeps its queue in shared memory as kSort slots of (distance,
// arrival index[, payload]): slots [0, kk) hold the current kk smallest
// keys in ascending order, slots [kk, kk + cnt) a buffer of candidates.
// Each round every thread offers at most `per_thread` candidates; a
// candidate is kept only if its key beats the queue's kk-th key (tau).
// Once the buffer holds kk candidates (or could overflow in the next
// round), queue and buffer are bitonic-sorted together and the first kk
// kept. The kk smallest keys of
// a strict total order are one fixed set whatever order they are offered
// in, so the result is the first kk of a stable ascending sort of every
// candidate in arrival order: the reference's queue (kernels/common.py
// extract_topk_rows), with +inf slots at the end.
#pragma once

#include <math.h>

#include "common.cuh"

// Tie rule of the reference's selections: ascending distance, and among
// equal distances the earlier-arriving candidate first. Arrival indices
// are unique, so this is a strict total order.
__device__ __forceinline__ bool key_less(float da, int aa, float db, int ab) {
  return da < db || (da == db && aa < ab);
}

constexpr int kQueueIntMax = 0x7fffffff;

// The queue's scalars, one per block in shared memory.
struct QueueScalars {
  int cnt;       // candidates in the buffer
  float tau_d;   // the kk-th key: a candidate must beat it
  int tau_a;
};

// kThreads: the block size; kSort: slots, a power of two >= kk + the
// most candidates one round can add. With kPayload false the arrival
// index is the payload (sg is unused and may be null).
template <int kThreads, int kSort, bool kPayload>
struct SmemQueue {
  float* sd;
  int* sa;
  int* sg;
  int kk;
  QueueScalars* s;

  // Empty queue; the caller synchronises before the first offer.
  __device__ void init() const {
    for (int i = threadIdx.x; i < kk; i += kThreads) {
      sd[i] = INFINITY;
      sa[i] = kQueueIntMax;
      if (kPayload) sg[i] = -1;
    }
    if (threadIdx.x == 0) {
      s->cnt = 0;
      s->tau_d = INFINITY;
      s->tau_a = kQueueIntMax;
    }
  }

  // Whether a candidate's key beats the kk-th key.
  __device__ __forceinline__ bool beats(float d, int a) const {
    return key_less(d, a, s->tau_d, s->tau_a);
  }

  // Append a candidate that beats the kk-th key to the buffer.
  __device__ __forceinline__ void push(float d, int a, int g = -1) const {
    const int slot = kk + atomicAdd(&s->cnt, 1);
    sd[slot] = d;
    sa[slot] = a;
    if (kPayload) sg[slot] = g;
  }

  // One thread's candidate whose payload is its arrival index.
  __device__ __forceinline__ void offer(float d, int a) const {
    if (beats(d, a)) push(d, a);
  }

  // Called by every thread at the end of a round in which each thread
  // offered at most per_thread candidates: merges as soon as the buffer
  // holds kk candidates (or the next round could overflow it), so that
  // each sort stays small and the threshold tightens early (a merge that
  // waits for a full buffer sorts all kSort slots).
  __device__ void end_round(int per_thread) const {
    __syncthreads();
    const int c = s->cnt;
    __syncthreads();
    if (c >= kk || c > kSort - kk - per_thread * kThreads) merge();
  }

  // Called by every thread after the last round: folds in what is left.
  __device__ void finish() const {
    __syncthreads();
    if (s->cnt > 0) merge();
  }

  // Payload of slot i of the finished queue (-1 for an empty slot).
  __device__ __forceinline__ int id(int i) const {
    return isinf(sd[i]) ? -1 : (kPayload ? sg[i] : sa[i]);
  }

  __device__ void merge() const {
    const int t = threadIdx.x;
    const int n = kk + s->cnt;
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    __syncthreads();
    for (int i = n + t; i < n2; i += kThreads) {
      sd[i] = INFINITY;
      sa[i] = kQueueIntMax;
      if (kPayload) sg[i] = -1;
    }
    __syncthreads();
    for (int k = 2; k <= n2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = t; i < n2; i += kThreads) {
          const int o = i ^ j;
          if (o > i) {
            const bool up = (i & k) == 0;
            const bool gt = key_less(sd[o], sa[o], sd[i], sa[i]);
            const bool lt = key_less(sd[i], sa[i], sd[o], sa[o]);
            if (up ? gt : lt) {
              const float td = sd[i];
              sd[i] = sd[o];
              sd[o] = td;
              const int ta = sa[i];
              sa[i] = sa[o];
              sa[o] = ta;
              if (kPayload) {
                const int tg = sg[i];
                sg[i] = sg[o];
                sg[o] = tg;
              }
            }
          }
        }
        __syncthreads();
      }
    }
    if (t == 0) {
      s->tau_d = sd[kk - 1];
      s->tau_a = sa[kk - 1];
      s->cnt = 0;
    }
    __syncthreads();
  }
};
