// Decode attention over the slotted KV pool, in one launch per wave and
// layer.
//
// Replaces: src/repro/kernels/decode_attn/kernel.py:109 fused_decode_attention
//           (body _decode_attn_kernel, kernel.py:50).
//
// One new token per wave row attends over its own cache rows. The wave
// row w reads pool row slots[w] directly (no [W, S, KV, D] gather copy
// of the pool, which the plain version and the reference make for every
// layer), over the first S slots of it (the engine's kv_len crop, or
// the ring size). Validity per slot is the reference's: linear caches
// hold position i at slot i (valid iff i <= pos, and i > pos - window
// with a window); ring caches hold pos - ((pos - i) mod S). Each block
// reads only the valid slots of its split, which is at least as fine as
// the reference's whole-block skip, and skips nothing that contributes.
//
// Head shapes: D in {16, 64, 96, 128, 256} (every d_head of the
// registered configs, reduced ones included) and up to G = 16 query
// heads a KV head (Llama-3-405B's 128:8).
//
// Bound on the H100: memory. The kernel must read K and V once,
// 2 * W * kv_len * KV * D * 2 bytes per layer (32 MB at the serve shape,
// ~9.5 us at 3.35 TB/s), against ~4 flops per byte. Latency is what held
// the earlier design back: each warp walked its slots one at a time with
// 256 bytes in flight, so the whole grid kept ~1 MB in flight where the
// card needs ~3 MB, and a second launch merged the splits. This design:
//  - grid (splits, KV, W): a block owns (row w, KV head, a split of the
//    slots), and the wrapper sizes the splits so that the grid is about
//    as many blocks an SM as its shared memory lets stay resident (at
//    most eight; one wave, no tail). The split length does not have to
//    divide S: the last split is ragged.
//  - the block streams its split through shared memory in tiles of 32
//    slots, two stages deep: while it computes on one tile, the K and V
//    head rows of the next are in flight as 16-byte cp.async copies
//    (8 KB a tile at D=64, 32 KB at D=256). The stages are dynamic
//    shared memory (64 KB at D=256, above the 48 KB static limit).
//  - per tile, the scores of all its slots (D/8 lanes a slot, one
//    16-byte chunk each, padded to a power of two lanes so that the
//    shuffle sum stays inside the slot's lanes: D=96 gives a slot 16
//    lanes, 12 loading and 4 adding zero) for the G query heads of the
//    KV head, then one online-softmax step (the tile's max, one expf per
//    score, its sum) and P.V from shared memory: a thread takes one bf16
//    pair of the head row and 1/J of the slots, J = 128 / (D/2) slot
//    subsets (at D=96 the last 32 threads sit out, so the subsets are
//    exact). At D <= 128 each access reads whole 128-byte rows per
//    quarter-warp, so the plain [slot][D] layout has no bank conflicts
//    without a swizzle.
//  - G up to 16 runs in one pass over each tile (an instance with room
//    for 16 heads' query chunks and accumulators in registers), not two
//    passes of 8: the K and V tile is read from shared memory once for
//    every head, and the reduction buffer after the loop is sized for
//    the instance (it reuses the stages' shared memory, or grows it).
//  - the splits merge inside the launch: each block writes its (m, l,
//    acc) partial, and the last block of each (row, KV head) to finish
//    (last_block in common.cuh) merges them and writes the bf16 output.
// Everything stays float32 until that final division, as in the
// reference kernel (kernel.py:101-104).
//
// Partial mode (decode_attn_partial_launch): the cache holds one rank's
// range of a sequence split over ranks, local slot i at absolute position
// slot_offset + i, so validity is slot_offset + i <= pos. The launch
// writes the rank's merged float32 partial instead of the bf16 output:
// the unnormalised acc [W, H, D] with its running max m and sum l
// [W, H], which the caller merges across ranks. A rank with no valid
// slot writes l = 0, acc = 0 and m = -1e30: finite, and weightless in
// the merge. Linear caches without a window; wave row w reads cache row
// w (the wrapper passes identity slots).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // slots a stage holds: one score per lane
constexpr float kNegInf = -1e30f;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* kc;
  const __nv_bfloat16* vc;
  const int32_t* slots;
  const int32_t* pos;
  float* part_m;
  float* part_l;
  float* part_acc;
  int* counters;
  __nv_bfloat16* out;
  int S_pool, S, KV, G, window, ring, split_len, NS;
  float scale;
  int slot_offset;   // absolute position of slot 0 (partial mode)
  float* out_m;      // partial mode: [W, H] running max, else null
  float* out_l;      // [W, H] sum of exp
  float* out_acc;    // [W, H, D] unnormalised P.V
};

constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// The instance's geometry: CH 16-byte chunks a head row, LPS lanes a
// slot, J slot subsets of the P.V sum; its dynamic shared memory holds
// two stages of K and V tiles, and after the loop the [J][GM][D] float
// reduction buffer, whichever is larger.
template <int D, int GM>
struct Shape {
  static constexpr int CH = D / 8;
  static constexpr int LPS = pow2_at_least(CH);
  static constexpr int SPW = 32 / LPS;
  static constexpr int PAIRS = D / 2;
  static constexpr int J = kThreads / PAIRS;
  static constexpr int kStage = kTile * D;  // bf16 values of a K (V) tile
  static constexpr int kStageBytes = 4 * kStage * 2;  // 2 stages, K and V
  static constexpr int kRedBytes = J * GM * D * 4;
  static constexpr int kSmem = kStageBytes > kRedBytes ? kStageBytes
                                                       : kRedBytes;
  static_assert(D % 8 == 0 && LPS <= 32, "a slot's chunks fit a warp");
  static_assert(PAIRS <= kThreads, "a head row's pairs fit the block");
};

__device__ __forceinline__ bool slot_valid(int s, int p, int S, int window,
                                           int ring) {
  if (ring) {
    const int ps = p - floor_mod(p - s, S);
    return ps >= 0 && (window <= 0 || ps > p - window);
  }
  return s <= p && (window <= 0 || s > p - window);
}

__device__ __forceinline__ void unpack8(uint4 raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// D: head dim; GM: the most query heads per KV head this instance takes
// (a power of two >= G).
template <int D, int GM>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(Args a) {
  using Sh = Shape<D, GM>;
  constexpr int CH = Sh::CH, LPS = Sh::LPS, SPW = Sh::SPW;
  constexpr int PAIRS = Sh::PAIRS, J = Sh::J, kStage = Sh::kStage;
  static_assert(kTile == 32, "the softmax step takes one score per lane");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sv = sk + 2 * kStage;
  float* red = reinterpret_cast<float*>(smem);  // [J][GM][D] after the loop
  __shared__ float sp[GM][kTile];      // scores, then softmax weights
  __shared__ float s_m[GM], s_l[GM], s_c[GM];

  const int S = a.S, window = a.window, ring = a.ring, G = a.G, NS = a.NS;
  const int split = blockIdx.x, kvh = blockIdx.y, w = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  // the row's position relative to slot 0 of this cache
  const int p = a.pos[w] - a.slot_offset;
  const long long row = a.slots[w];
  // the split's slots that can be valid, [lo, lo + n)
  int lo = split * a.split_len, hi = min(S, lo + a.split_len) - 1;
  if (!ring) {
    hi = min(hi, p);
    if (window > 0) lo = max(lo, p - window + 1);
  }
  const int n = hi - lo + 1;
  const int ntiles = n > 0 ? (n + kTile - 1) / kTile : 0;
  const long long ws = (long long)a.KV * D;
  const long long first = (row * a.S_pool + lo) * ws + (long long)kvh * D;

  // K and V head rows of tile `ti` into stage `st`; a ring slot that
  // holds no valid position is zero-filled instead
  auto issue = [&](int ti, int st) {
    const int j0 = ti * kTile, cnt = min(kTile, n - j0);
    for (int c = t; c < cnt * CH; c += kThreads) {
      const int j = c / CH, cc = c % CH;
      __nv_bfloat16* dk = sk + st * kStage + j * D + cc * 8;
      __nv_bfloat16* dv = sv + st * kStage + j * D + cc * 8;
      if (!ring || slot_valid(lo + j0 + j, p, S, window, 1)) {
        const long long src = first + (j0 + j) * ws + cc * 8;
        cp_async16(dk, a.kc + src);
        cp_async16(dv, a.vc + src);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };
  if (ntiles > 0) issue(0, 0);

  // the lane's chunk of each query head; padding lanes (ch >= CH) hold 0
  const int ch = lane % LPS;
  const bool live = ch < CH;
  float qf[GM][8];
  const __nv_bfloat16* qrow =
      a.q + ((long long)w * a.KV + kvh) * G * D + (live ? ch * 8 : 0);
#pragma unroll
  for (int g = 0; g < GM; ++g)
    unpack8(g < G && live ? *reinterpret_cast<const uint4*>(qrow + g * D)
                          : make_uint4(0, 0, 0, 0),
            qf[g]);
  if (t < GM) {
    s_m[t] = kNegInf;
    s_l[t] = 0.f;
  }
  // P.V: thread t takes pair t % PAIRS of subset t / PAIRS; threads past
  // J * PAIRS (D = 96) take none
  const int pair = t % PAIRS, js = t / PAIRS;
  const bool pv = js < J;
  float acc[GM][2];
#pragma unroll
  for (int g = 0; g < GM; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int ti = 0; ti < ntiles; ++ti) {
    const int st = ti & 1;
    if (ti + 1 < ntiles) {
      issue(ti + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = ti * kTile, cnt = min(kTile, n - j0);
    const __nv_bfloat16* tk = sk + st * kStage;
    const __nv_bfloat16* tv = sv + st * kStage;

    // scores of the whole tile
    for (int jj = warp * SPW; jj < cnt; jj += kWarps * SPW) {
      const int j = jj + lane / LPS;
      float kf[8];
      unpack8(j < cnt && live
                  ? *reinterpret_cast<const uint4*>(tk + j * D + ch * 8)
                  : make_uint4(0, 0, 0, 0),
              kf);
      const bool valid =
          j < cnt && slot_valid(lo + j0 + j, p, S, window, ring);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qf[g][e], kf[e], dot);
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (ch == 0 && j < cnt && g < G)
          sp[g][j] = valid ? dot * a.scale : kNegInf;
      }
    }
    __syncthreads();

    // one online-softmax step for the tile, a warp per query head
    for (int g = warp; g < G; g += kWarps) {
      const float sc = lane < cnt ? sp[g][lane] : kNegInf;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      const float e = sc > kNegInf ? expf(sc - m_new) : 0.f;
      sp[g][lane] = e;
      float sum = e;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_c[g] = corr;
        s_l[g] = s_l[g] * corr + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // P.V: a thread takes one bf16 pair of every head and 1/J of the slots
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        acc[g][0] *= s_c[g];
        acc[g][1] *= s_c[g];
      }
    }
    for (int j = js; pv && j < cnt; j += J) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(tv + j * D + 2 * pair));
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float pw = sp[g][j];
          acc[g][0] = fmaf(pw, v.x, acc[g][0]);
          acc[g][1] = fmaf(pw, v.y, acc[g][1]);
        }
      }
    }
    __syncthreads();   // the stage is refilled two tiles on
  }

  if (pv) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      reinterpret_cast<float2*>(red + (js * GM + g) * D)[pair] =
          make_float2(acc[g][0], acc[g][1]);
  }
  __syncthreads();

  const long long wk = (long long)w * a.KV + kvh;
  if (NS == 1) {
    for (int idx = t; idx < G * D; idx += kThreads) {
      const int g = idx / D, d = idx % D;
      float A = 0.f;
#pragma unroll
      for (int k = 0; k < J; ++k) A += red[(k * GM + g) * D + d];
      if (a.out_acc != nullptr) {
        a.out_acc[(wk * G + g) * D + d] = A;
        if (d == 0) {
          a.out_m[wk * G + g] = s_m[g];
          a.out_l[wk * G + g] = s_l[g];
        }
      } else {
        a.out[(wk * G + g) * D + d] =
            __float2bfloat16(A / fmaxf(s_l[g], 1e-20f));
      }
    }
    return;
  }
  const long long base = (wk * NS + split) * G;
  for (int idx = t; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float A = 0.f;
#pragma unroll
    for (int k = 0; k < J; ++k) A += red[(k * GM + g) * D + d];
    a.part_acc[(base + g) * D + d] = A;
    if (d == 0) {
      a.part_m[base + g] = s_m[g];
      a.part_l[base + g] = s_l[g];
    }
  }
  if (!last_block(a.counters + wk, NS)) return;

  // the last block of (w, kvh) merges the NS partials; a split that saw no
  // valid slot left l = 0 (and acc = 0) and weighs nothing
  for (int idx = t; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    const long long p0 = wk * NS * G + g;
    float M = kNegInf;
    for (int i = 0; i < NS; ++i) {
      const float li = __ldcg(a.part_l + p0 + (long long)i * G);
      const float mi = __ldcg(a.part_m + p0 + (long long)i * G);
      M = li > 0.f ? fmaxf(M, mi) : M;
    }
    float L = 0.f, A = 0.f;
    for (int i = 0; i < NS; ++i) {
      const long long pi = p0 + (long long)i * G;
      const float li = __ldcg(a.part_l + pi);
      const float c = li > 0.f ? expf(__ldcg(a.part_m + pi) - M) : 0.f;
      L += li * c;
      A += __ldcg(a.part_acc + pi * D + d) * c;
    }
    if (a.out_acc != nullptr) {
      a.out_acc[(wk * G + g) * D + d] = A;
      if (d == 0) {
        a.out_m[wk * G + g] = M;
        a.out_l[wk * G + g] = L;
      }
    } else {
      a.out[(wk * G + g) * D + d] = __float2bfloat16(A / fmaxf(L, 1e-20f));
    }
  }
}

template <int D, int GM>
cudaError_t launch(dim3 grid, cudaStream_t st, const Args& a) {
  constexpr int smem = Shape<D, GM>::kSmem;
  if (smem > 48 * 1024) {
    // above the static limit only after opting in (per device: set it
    // on every launch, it is cheap next to the kernel)
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<D, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  decode_attn_kernel<D, GM><<<grid, kThreads, smem, st>>>(a);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_d(dim3 grid, cudaStream_t st, const Args& a) {
  if (a.G <= 1) return launch<D, 1>(grid, st, a);
  if (a.G <= 2) return launch<D, 2>(grid, st, a);
  if (a.G <= 4) return launch<D, 4>(grid, st, a);
  if (a.G <= 8) return launch<D, 8>(grid, st, a);
  return launch<D, 16>(grid, st, a);
}

}  // namespace

// The launch of either mode over the grid (splits, KV, W).
static int run(const Args& a, int W, int D, void* stream) {
  if (a.G < 1 || a.G > 16 || a.split_len < 1 ||
      (long long)a.split_len * a.NS < a.S || a.S < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(a.NS, a.KV, W);
  cudaError_t e;
  switch (D) {
    case 16: e = launch_d<16>(grid, st, a); break;
    case 64: e = launch_d<64>(grid, st, a); break;
    case 96: e = launch_d<96>(grid, st, a); break;
    case 128: e = launch_d<128>(grid, st, a); break;
    case 256: e = launch_d<256>(grid, st, a); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// q [W, KV*G, D] bf16; kc/vc [P, S_pool, KV, D] bf16 (one layer of the
// pool); slots/pos [W] int32; the first S slots of each row are read in
// NS splits of split_len slots (split_len * NS >= S); part_m/part_l
// [W, KV, NS, G] f32 and part_acc [W, KV, NS, G, D] f32 scratch (unused
// when NS = 1); counters [W * KV] int32, zero; out [W, KV*G, D] bf16.
// D in {16, 64, 96, 128, 256}, 1 <= G <= 16.
RT_EXPORT int decode_attn_launch(const void* q, const void* kc, const void* vc,
                                 const void* slots, const void* pos,
                                 void* part_m, void* part_l, void* part_acc,
                                 void* counters, void* out, int W, int S_pool,
                                 int S, int KV, int G, int D, int window,
                                 int ring, int split_len, int NS, float scale,
                                 void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(kc),
               static_cast<const __nv_bfloat16*>(vc),
               static_cast<const int32_t*>(slots),
               static_cast<const int32_t*>(pos),
               static_cast<float*>(part_m),
               static_cast<float*>(part_l),
               static_cast<float*>(part_acc),
               static_cast<int*>(counters),
               static_cast<__nv_bfloat16*>(out),
               S_pool, S, KV, G, window, ring, split_len, NS, scale,
               0, nullptr, nullptr, nullptr};
  return run(a, W, D, stream);
}

// The partial mode: as above over a linear cache whose slot 0 holds
// absolute position slot_offset, writing out_m / out_l [W, KV*G] and
// out_acc [W, KV*G, D] float32 instead of a bf16 output.
RT_EXPORT int decode_attn_partial_launch(
    const void* q, const void* kc, const void* vc, const void* slots,
    const void* pos, void* part_m, void* part_l, void* part_acc,
    void* counters, void* out_m, void* out_l, void* out_acc, int W,
    int S_pool, int S, int KV, int G, int D, int slot_offset, int split_len,
    int NS, float scale, void* stream) {
  if (out_m == nullptr || out_l == nullptr || out_acc == nullptr)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(kc),
               static_cast<const __nv_bfloat16*>(vc),
               static_cast<const int32_t*>(slots),
               static_cast<const int32_t*>(pos),
               static_cast<float*>(part_m),
               static_cast<float*>(part_l),
               static_cast<float*>(part_acc),
               static_cast<int*>(counters),
               nullptr,
               S_pool, S, KV, G, 0, 0, split_len, NS, scale, slot_offset,
               static_cast<float*>(out_m), static_cast<float*>(out_l),
               static_cast<float*>(out_acc)};
  return run(a, W, D, stream);
}
