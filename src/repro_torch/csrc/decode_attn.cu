// Split-KV (flash-decoding) decode attention over the slotted KV pool.
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
// with a window); ring caches hold pos - ((pos - i) mod S). Each row
// visits only its own valid slot range, which is at least as fine as
// the reference's whole-block skip (block start > max position in the
// row tile), and skips nothing that contributes.
//
// Pass 1, grid (W, KV, NS): one block per (row, KV head, KV split of
// split_len slots). Four warps take slots round robin; a warp computes
// the G = H/KV query heads' scores of one slot (lanes split the head
// dim, a shuffle sum), and keeps a float32 online softmax (m, l, acc)
// per head. The warps' states merge in shared memory into one partial
// per block. Pass 2, grid (W, H): merge the NS partials of each head
// and write out / max(l, 1e-20) in bf16. Everything stays float32 until
// that final division, as in the reference kernel (kernel.py:101-104).
//
// Bound on the H100: memory. It must read K and V once,
// 2 * W * kv_len * KV * D * 2 bytes per layer, against ~4 flops per
// byte; the splits give W * KV * NS blocks so the read is spread over
// all SMs, and a warp reads one slot's D bf16 values as one coalesced
// 128-byte (D=64) row.
#include <cuda_bf16.h>

#include "common.cuh"

#define NEG_INF_F (-1e30f)

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 8;

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_split_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ kc,
                         const __nv_bfloat16* __restrict__ vc,
                         const int32_t* __restrict__ slots,
                         const int32_t* __restrict__ pos,
                         float* __restrict__ part_m,
                         float* __restrict__ part_l,
                         float* __restrict__ part_acc, int S_pool, int S,
                         int KV, int G, int window, int ring, int split_len,
                         int NS, float scale) {
  constexpr int E = D / 32;  // head-dim elements per lane
  __shared__ float sm_m[kWarps][kMaxG];
  __shared__ float sm_l[kWarps][kMaxG];
  __shared__ float sm_acc[kWarps][kMaxG][D];

  const int w = blockIdx.x, kvh = blockIdx.y, sp = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = pos[w];
  const long long row = slots[w];

  int lo = 0, hi = S - 1;
  if (!ring) {
    hi = min(hi, p);
    if (window > 0) lo = max(lo, p - window + 1);
  }
  const int s0 = max(lo, sp * split_len);
  const int s1 = min(hi, sp * split_len + split_len - 1);

  float qf[kMaxG][E], acc[kMaxG][E], m[kMaxG], l[kMaxG];
  const __nv_bfloat16* qrow = q + ((long long)w * KV * G + kvh * G) * D;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = NEG_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      float2 f = make_float2(0.f, 0.f);
      if (g < G)
        f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            qrow + g * D + lane * E + e));
      qf[g][e] = f.x;
      qf[g][e + 1] = f.y;
      acc[g][e] = 0.f;
      acc[g][e + 1] = 0.f;
    }
  }

  const long long slot_stride = (long long)KV * D;
  const __nv_bfloat16* kbase =
      kc + row * S_pool * slot_stride + (long long)kvh * D + lane * E;
  const __nv_bfloat16* vbase =
      vc + row * S_pool * slot_stride + (long long)kvh * D + lane * E;

  for (int s = s0 + warp; s <= s1; s += kWarps) {
    if (ring) {  // warp-uniform branch: every lane holds the same slot
      const int ps = p - floor_mod(p - s, S);
      if (ps < 0 || (window > 0 && ps <= p - window)) continue;
    }
    float kf[E], vf[E];
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      float2 k2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(kbase + s * slot_stride + e));
      float2 v2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vbase + s * slot_stride + e));
      kf[e] = k2.x;
      kf[e + 1] = k2.y;
      vf[e] = v2.x;
      vf[e + 1] = v2.y;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot += qf[g][e] * kf[e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float sc = dot * scale;
      const float m_new = fmaxf(m[g], sc);
      const float corr = expf(m[g] - m_new);
      const float pe = expf(sc - m_new);
      l[g] = l[g] * corr + pe;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * corr + pe * vf[e];
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();

  const long long base = (((long long)w * KV + kvh) * NS + sp) * G;
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float M = NEG_INF_F;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) M = fmaxf(M, sm_m[k][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const float c = expf(sm_m[k][g] - M);
      L += sm_l[k][g] * c;
      A += sm_acc[k][g][d] * c;
    }
    if (d == 0) {
      part_m[base + g] = M;
      part_l[base + g] = L;
    }
    part_acc[(base + g) * D + d] = A;
  }
}

__global__ void decode_attn_combine_kernel(const float* __restrict__ part_m,
                                           const float* __restrict__ part_l,
                                           const float* __restrict__ part_acc,
                                           __nv_bfloat16* __restrict__ out,
                                           int KV, int G, int D, int NS) {
  const int w = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const int kvh = h / G, g = h % G;
  const long long base = ((long long)w * KV + kvh) * NS * G + g;
  float M = NEG_INF_F;
  for (int sp = 0; sp < NS; ++sp) M = fmaxf(M, part_m[base + (long long)sp * G]);
  float L = 0.f, A = 0.f;
  for (int sp = 0; sp < NS; ++sp) {
    const long long i = base + (long long)sp * G;
    const float c = expf(part_m[i] - M);
    L += part_l[i] * c;
    A += part_acc[i * D + d] * c;
  }
  out[((long long)w * KV * G + h) * D + d] = __float2bfloat16(A / fmaxf(L, 1e-20f));
}

}  // namespace

// q [W, KV*G, D] bf16; kc/vc [P, S_pool, KV, D] bf16 (one layer of the
// pool); slots/pos [W] int32; part_m/part_l [W, KV, NS, G] f32 and
// part_acc [W, KV, NS, G, D] f32 scratch; out [W, KV*G, D] bf16.
RT_EXPORT int decode_attn_launch(const void* q, const void* kc, const void* vc,
                                 const void* slots, const void* pos,
                                 void* part_m, void* part_l, void* part_acc,
                                 void* out, int W, int S_pool, int S, int KV,
                                 int G, int D, int window, int ring,
                                 int split_len, int NS, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > kMaxG || (D != 64 && D != 128)) return cudaErrorInvalidValue;
  dim3 grid1(W, KV, NS);
  auto* qb = static_cast<const __nv_bfloat16*>(q);
  auto* kb = static_cast<const __nv_bfloat16*>(kc);
  auto* vb = static_cast<const __nv_bfloat16*>(vc);
  auto* sl = static_cast<const int32_t*>(slots);
  auto* ps = static_cast<const int32_t*>(pos);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  if (D == 64)
    decode_attn_split_kernel<64><<<grid1, kWarps * 32, 0, st>>>(
        qb, kb, vb, sl, ps, pm, pl, pa, S_pool, S, KV, G, window, ring,
        split_len, NS, scale);
  else
    decode_attn_split_kernel<128><<<grid1, kWarps * 32, 0, st>>>(
        qb, kb, vb, sl, ps, pm, pl, pa, S_pool, S, KV, G, window, ring,
        split_len, NS, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid2(W, KV * G);
  decode_attn_combine_kernel<<<grid2, D, 0, st>>>(
      pm, pl, pa, static_cast<__nv_bfloat16*>(out), KV, G, D, NS);
  return cudaGetLastError();
}
