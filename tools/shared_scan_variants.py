"""Which part of ``shared_scan`` sets its time, on the GPU.

    python3 tools/shared_scan_variants.py

Builds, into ``build/variants/``, one library that holds the shipped
``csrc/pq_adc.cu`` and the variants below, sets up the smoke's index
(``chip_smoke.setup`` at its full size), and times each variant with the
smoke's timer at the smoke's ``kernel.shared_scan`` shape: the wave's 32
non-residual LUTs against the valid code rows of the lists the wave
probes in shard 0 (about 2.06 M rows of m = 32 bytes).

  - ``old``: the kernel before its redesign (two queries' LUTs a block,
    laid out query by query, a thread a row, one 4-byte store a sum);
  - ``old_no_store``: the same, storing only sums that are NaN (none):
    no output traffic;
  - ``old_no_lookup``: the same, summing the code bytes in place of the
    lookups: code reads and output stores only;
  - ``new TxR``: the shipped kernel's template (four queries' LUTs laid
    out query fastest, one 16-byte load a lookup, one 16-byte store a
    row) at T threads a block and R rows a thread a round; the shipped
    choice is 512x2.

Every variant that computes the sums is held to the shipped wrapper's
output with ``torch.equal``. It needs a CUDA GPU and exits non-zero
without one.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = r'''
#include "pq_adc.cu"

namespace variants {

constexpr int kOldThreads = 256;
constexpr int kOldMaxTileQ = 8;

// The kernel before the redesign, with two switches: kStore false keeps
// only the stores of NaN sums (none); kLookup false adds the code bytes
// in place of the LUT terms.
template <bool kStore, bool kLookup>
__global__ void __launch_bounds__(kOldThreads)
old_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
           float* __restrict__ out, int n, int q, int m, int ksub, int tq,
           int rows_per_block) {
  extern __shared__ float lut[];
  const int q0 = blockIdx.x * tq, t = threadIdx.x;
  const int nq = min(tq, q - q0);
  const int tab = m * ksub;
  const float* lsrc = luts + (long long)q0 * tab;
  for (int i = t; i < nq * tab; i += kOldThreads) lut[i] = lsrc[i];
  __syncthreads();
  const long long r_end =
      min((long long)n, (long long)(blockIdx.y + 1) * rows_per_block);
  for (long long r = (long long)blockIdx.y * rows_per_block + t; r < r_end;
       r += kOldThreads) {
    const uint8_t* row = codes + r * m;
    float acc[kOldMaxTileQ];
#pragma unroll
    for (int qi = 0; qi < kOldMaxTileQ; ++qi) acc[qi] = 0.f;
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    for (int j16 = 0; j16 < m / 16; ++j16) {
      const uint4 v = rv[j16];
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int kw = 0; kw < 4; ++kw) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const unsigned code = (w[kw] >> (8 * b)) & 0xffu;
          const int off = (j16 * 16 + kw * 4 + b) * ksub + code;
#pragma unroll
          for (int qi = 0; qi < kOldMaxTileQ; ++qi) {
            if (qi < nq) acc[qi] += kLookup ? lut[qi * tab + off]
                                            : (float)code;
          }
        }
      }
    }
    float* o = out + r * q + q0;
#pragma unroll
    for (int qi = 0; qi < kOldMaxTileQ; ++qi) {
      if (qi < nq && (kStore || isnan(acc[qi]))) o[qi] = acc[qi];
    }
  }
}

template <bool kStore, bool kLookup>
int launch_old(const float* luts, const uint8_t* codes, float* out, int n,
               int q, int m, int ksub, int rows, cudaStream_t st) {
  const int tq = 2;
  const size_t smem = sizeof(float) * tq * m * ksub;
  cudaError_t err = cudaFuncSetAttribute(
      old_kernel<kStore, kLookup>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((q + tq - 1) / tq, (n + rows - 1) / rows);
  old_kernel<kStore, kLookup><<<grid, kOldThreads, smem, st>>>(
      luts, codes, out, n, q, m, ksub, tq, rows);
  return cudaGetLastError();
}

template <int kT, int kR>
int launch_new(const float* luts, const uint8_t* codes, float* out, int n,
               int q, int m, int ksub, int rows, cudaStream_t st) {
  const size_t smem = sizeof(float) * 4 * m * ksub;
  auto kernel = shared_scan_kernel<4, 2, kT, kR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((q + 3) / 4, (n + rows - 1) / rows);
  kernel<<<grid, kT, smem, st>>>(luts, codes, out, n, q, m, ksub, rows);
  return cudaGetLastError();
}

}  // namespace variants

// m = 32, ksub = 256, q % 4 == 0, 16-byte aligned rows only.
RT_EXPORT int variant_launch(int variant, const void* luts, const void* codes,
                             void* out, int n, int q, int m, int ksub,
                             int rows, void* stream) {
  using namespace variants;
  auto* l = static_cast<const float*>(luts);
  auto* c = static_cast<const uint8_t*>(codes);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_old<true, true>(l, c, o, n, q, m, ksub, rows, st);
    case 1: return launch_old<false, true>(l, c, o, n, q, m, ksub, rows, st);
    case 2: return launch_old<true, false>(l, c, o, n, q, m, ksub, rows, st);
    case 3: return launch_new<512, 2>(l, c, o, n, q, m, ksub, rows, st);
    case 4: return launch_new<1024, 1>(l, c, o, n, q, m, ksub, rows, st);
    case 5: return launch_new<256, 4>(l, c, o, n, q, m, ksub, rows, st);
    case 6: return launch_new<512, 1>(l, c, o, n, q, m, ksub, rows, st);
    case 7: return launch_new<1024, 2>(l, c, o, n, q, m, ksub, rows, st);
  }
  return cudaErrorInvalidValue;
}
'''
# (name, variant id, rows a block: None = the shipped grid, compared?)
VARIANTS = [("old", 0, 8192, True), ("old_no_store", 1, 8192, False),
            ("old_no_lookup", 2, 8192, False), ("new 512x2", 3, None, True),
            ("new 1024x1", 4, None, True), ("new 256x4", 5, None, True),
            ("new 512x1", 6, None, True), ("new 1024x2", 7, None, True)]


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "shared_scan_variants.cu"
    src.write_text(SOURCE)
    lib = out / "libvariants.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-shared", "-o", str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    for ln in (res.stdout + res.stderr).splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"  ptxas {ln.strip()}", flush=True)
    handle = ctypes.CDLL(str(lib))
    handle.variant_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    handle.variant_launch.restype = ctypes.c_int
    return handle


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("shared_scan_variants: needs a CUDA GPU")
    import chip_smoke as cs
    from repro_torch.core import ivfpq
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_scan import ops as iv
    from repro_torch.kernels.pq_adc import ops as pq

    print(cs.nvidia_smi(), flush=True)
    lib = build()
    dev = torch.device("cuda")
    sizes = dict(cs.FULL)
    _, _, _, _, keys, ds = cs.setup(dev, sizes)
    g = torch.Generator(device=dev).manual_seed(2)
    W = sizes["requests"] * sizes["rows"]
    pick = torch.randint(0, keys.shape[0], (W,), generator=g, device=dev)
    queries = (keys[pick] + 0.01 * torch.randn(
        (W, keys.shape[1]), generator=g, device=dev)).contiguous()
    del keys
    _, probe_ids = iv.ivf_index_scan(queries, ds.params.coarse_centroids,
                                     sizes["nprobe"])
    icfg, shard = ds.index_cfg, ds.shards[0]
    luts = ivfpq.compute_luts(ds.params, queries, probe_ids, icfg
                              )[:, 0].contiguous()
    q, m, ksub = luts.shape
    lists = torch.unique(probe_ids.long())
    valid = (torch.arange(icfg.list_cap, device=dev)[None, :]
             < shard.list_len[lists][:, None])
    codes = shard.codes[lists][valid].contiguous()
    n = codes.shape[0]
    want = pq.pq_shared_scan(luts, codes)
    waves = cs.lookup_wavefronts(torch, codes)
    clock_hz = float(cs.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sms = _build.sm_count(dev)
    floor_ms = n * q * m / 32 * waves / (sms * clock_hz) * 1e3
    print(f"shape q={q} n={n} m={m} ksub={ksub} "
          f"wavefronts_per_warp_lookup={waves:.3f} "
          f"lookup_floor_ms={floor_ms:.4f}", flush=True)
    timer = cs.Timer(torch)
    stream = _build.stream_ptr(luts)
    shipped_rows = pq.shared_rows(n, -(-q // 4), sms)
    for name, vid, rows, compared in VARIANTS:
        rows = rows or shipped_rows
        out = torch.full((n, q), float("nan"), device=dev)

        def run():
            err = lib.variant_launch(vid, luts.data_ptr(), codes.data_ptr(),
                                     out.data_ptr(), n, q, m, ksub, rows,
                                     stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        run()
        torch.cuda.synchronize()
        if compared and not torch.equal(out, want):
            raise AssertionError(f"{name} differs from the shipped kernel")
        ms = timer(run)
        print(f"[variant] {name:>14s} rows_per_block={rows} ms={ms:.4f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
