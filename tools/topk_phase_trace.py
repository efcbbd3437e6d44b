"""Where the hierarchical top-k kernel's time goes, on the GPU.

    python3 tools/topk_phase_trace.py

Runs ``approx_topk`` on 32 rows of 479 232 seeded distances laid out as
the smoke's staged ADC rows (32 lists of 14 976 columns a row, each
list's columns past a seeded length of 4 000-14 976 +inf; k = 100, 16
column blocks, k' = 15) and prints:

  - a phase timeline: a copy of ``topk.cu`` with the GPU's global timer
    read by thread 0 of each block at the phase boundaries of
    ``topk_select_kernel`` (block start, end of the scan, the warps' runs
    merged, the pieces merged by the column block's last piece, the
    row's result written by its last column block); for each phase, how
    many blocks reached it and the min / median / max microseconds since
    the first block started;
  - two yardsticks under ``chip_smoke.Timer``: ``torch.amin`` over the
    rows (a plain read of the same bytes) and ``torch.topk``;
  - the buffer merges (``flush_buffer``) a warp makes, counted by a copy
    with an atomic counter in it;
  - the time of the call with each column block cut into 1-4 pieces in
    place of ``topk_pieces``'s choice, for the shipped kernel and for
    copies with one change each: ``loads_only`` (the ring of staged steps
    and nothing else), ``no_precheck`` (every step walks its 512 entries
    through the ballot loop), ``stages3`` / ``stages4`` (a deeper ring).

Each copy builds only ``topk.cu`` and the runtime, under
``build/trace_topk/<name>/``. It needs a CUDA GPU and exits non-zero
without one.
"""
from __future__ import annotations

import ctypes
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHIPPED = ROOT / "src" / "repro_torch" / "csrc"
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

STAMP = ("#define STAMP(slot) do { if (threadIdx.x == 0) { "
         "unsigned long long v_; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v_)); "
         "g_stamp[blockIdx.x * 8 + (slot)] = v_; } } while (0)\n")
# (anchor in topk.cu, text put in its place)
EDITS = [
    ("namespace {\n\nconstexpr int kThreads",
     "__device__ unsigned long long g_stamp[1 << 16];\n" + STAMP +
     "namespace {\n\nconstexpr int kThreads"),
    ("  const int p = blockIdx.x % pieces, cb = blockIdx.x / pieces;\n",
     "  STAMP(0);\n"
     "  const int p = blockIdx.x % pieces, cb = blockIdx.x / pieces;\n"),
    ("  if (cnt > 0) flush_buffer<kWarps>(w, wbd, wba, cnt, vtd, vta, kp, "
     "fd, fa);\n",
     "  if (cnt > 0) flush_buffer<kWarps>(w, wbd, wba, cnt, vtd, vta, kp, "
     "fd, fa);\n  __syncthreads();\n  STAMP(1);\n"),
    ("  // the column block's last piece merges the other pieces' lists\n",
     "  __syncthreads();\n  STAMP(2);\n"
     "  // the column block's last piece merges the other pieces' lists\n"),
    ("  if (num_blocks == 1) {          // k' = k: the column block is the "
     "row\n    if (warp == 0) write_result(w[0]",
     "  __syncthreads();\n  STAMP(3);\n"
     "  if (num_blocks == 1) {          // k' = k: the column block is the "
     "row\n    if (warp == 0) write_result(w[0]"),
    ("  WarpKeys<R2> w2[1];\n",
     "  STAMP(4);\n  WarpKeys<R2> w2[1];\n"),
    ("    write_result(w2[0], out_d + (long long)row * k, "
     "out_i + (long long)row * k,\n                 k);\n",
     "    write_result(w2[0], out_d + (long long)row * k, "
     "out_i + (long long)row * k,\n                 k);\n    STAMP(5);\n"),
    ("RT_EXPORT int hierarchical_topk_launch(",
     "RT_EXPORT int topk_stamp_read(void* dst, int n) {\n"
     "  return cudaMemcpyFromSymbol(dst, g_stamp, (size_t)n * 8);\n}\n"
     "RT_EXPORT int topk_stamp_clear() {\n"
     "  static unsigned long long zero[1 << 16];\n"
     "  return cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));\n}\n"
     "RT_EXPORT int hierarchical_topk_launch("),
]
PHASES = {0: "start", 1: "scan_end", 2: "warps_merged",
          3: "pieces_merged", 4: "level2_start", 5: "row_written"}


def variant_library(name, topk_edits=(), header_edits=()):
    """Builds ``topk.cu`` (with the runtime and the headers) into
    ``build/trace_topk/<name>/`` with the text edits applied, and binds it
    in place of the shipped build (this process only)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk import ops as tk

    base = ROOT / "build" / "trace_topk" / name
    csrc = base / "csrc"
    if base.exists():
        shutil.rmtree(base)
    csrc.mkdir(parents=True)
    for f in ["topk.cu", "runtime.cu"] + [p.name for p in
                                          SHIPPED.glob("*.cuh")]:
        shutil.copy(SHIPPED / f, csrc / f)
    for fname, edits in (("topk.cu", topk_edits),
                         ("warp_select.cuh", header_edits)):
        path = csrc / fname
        text = path.read_text()
        for anchor, new_text in edits:
            if anchor not in text:
                raise RuntimeError(f"{fname} changed: {anchor[:50]!r}")
            text = text.replace(anchor, new_text)
        path.write_text(text)
    _build.CSRC, _build.BUILD = csrc, base / "lib"
    _build._lib = None
    tk.KERNEL._fn = None
    return _build.library()


# timed variants: (name, edits of topk.cu, edits of warp_select.cuh)
SINK = [("  for (int s = s0, j = 0; s < hi; s += stride, ++j) {\n",
         "  float sink = INFINITY;\n"
         "  for (int s = s0, j = 0; s < hi; s += stride, ++j) {\n"),
        ("  if (cnt > 0) flush_buffer<kWarps>(",
         "  if (sink == -1.f) out_d[0] = sink;\n"
         "  if (cnt > 0) flush_buffer<kWarps>(")]
LOADS_ONLY = SINK + [
    ("    const float* buf = ring + j % kStages * kStep;\n",
     "    const float* buf = ring + j % kStages * kStep;\n"
     "    if (s >= 0) {\n"
     "      for (int e = lane; e < kStep; e += 32)\n"
     "        if (s + e < hi) sink = fminf(sink, buf[e]);\n"
     "      __syncwarp();\n      continue;\n    }\n")]
NO_PRECHECK = [("    if (__any_sync(0xffffffffu, any)) {\n",
                "    if (__any_sync(0xffffffffu, any) || s >= 0) {\n")]
STAGES3 = [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]
STAGES4 = [("constexpr int kStages = 2;", "constexpr int kStages = 4;")]
COUNT = [("template <int kWarps, int R>\n__device__ __forceinline__ void "
          "flush_buffer(",
          "__device__ unsigned long long g_flushes;\n"
          "template <int kWarps, int R>\n__device__ __forceinline__ void "
          "flush_buffer("),
         ("  const int lane = threadIdx.x & 31;\n  __syncwarp();\n"
          "  float cd[1]",
          "  const int lane = threadIdx.x & 31;\n"
          "  if (lane == 0) atomicAdd(&g_flushes, 1ull);\n  __syncwarp();\n"
          "  float cd[1]")]
READ_COUNT = [("RT_EXPORT int hierarchical_topk_launch(",
               "RT_EXPORT unsigned long long topk_flushes() {\n"
               "  unsigned long long v = 0;\n"
               "  cudaMemcpyFromSymbol(&v, g_flushes, 8);\n"
               "  unsigned long long z = 0;\n"
               "  cudaMemcpyToSymbol(g_flushes, &z, 8);\n  return v;\n}\n"
               "RT_EXPORT int hierarchical_topk_launch(")]
VARIANTS = [("shipped", [], []), ("loads_only", LOADS_ONLY, []),
            ("no_precheck", NO_PRECHECK, []), ("stages3", STAGES3, []),
            ("stages4", STAGES4, [])]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("topk_phase_trace: needs a CUDA GPU")
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk import ops as tk

    lib = variant_library("stamped", EDITS)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, n, k, num_blocks = 32, 479232, 100, 16
    cap = 14976
    d = torch.rand((B, n), generator=g, device=dev) * 100.0
    lens = torch.randint(4000, cap + 1, (B, n // cap, 1), generator=g,
                         device=dev)
    pad = torch.arange(cap, device=dev) >= lens               # [B, 32, cap]
    d[pad.reshape(B, n)] = float("inf")
    pieces = tk.topk_pieces(B, num_blocks, n // num_blocks, k,
                            _build.sm_count(dev))
    blocks = B * num_blocks * pieces
    print(torch.cuda.get_device_name(0), flush=True)
    for _ in range(4):                      # the last run is read
        lib.topk_stamp_clear()
        torch.cuda.synchronize()
        tk.approx_topk(d, k, num_blocks=num_blocks)
        torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (blocks * 8))()
    lib.topk_stamp_read(buf, blocks * 8)
    a = np.array(buf, dtype=np.float64).reshape(blocks, 8)
    t0 = a[:, 0][a[:, 0] > 0].min()
    us = np.where(a > 0, (a - t0) / 1e3, np.nan)
    print(f"B={B} n={n} k={k} num_blocks={num_blocks}: {blocks} blocks "
          f"({pieces} pieces a column block)", flush=True)
    for slot, name in sorted(PHASES.items()):
        v = us[:, slot][np.isfinite(us[:, slot])]
        if v.size:
            print(f"  {name:>14s}  blocks={v.size:5d}  min={v.min():8.2f}"
                  f"  median={np.median(v):8.2f}  max={v.max():8.2f} us",
                  flush=True)
    dur = us[:, 1] - us[:, 0]
    print(f"  scan per block: median={np.nanmedian(dur):.2f} "
          f"max={np.nanmax(dur):.2f} us", flush=True)
    import chip_smoke

    timer = chip_smoke.Timer(torch)
    chosen = tk.topk_pieces

    def sweep(name, counts=(1, 2, 3, 4)):
        for p in counts:
            tk.topk_pieces = lambda *a, p=p: p
            ms = timer(lambda: tk.approx_topk(d, k, num_blocks=num_blocks))
            print(f"  {name} pieces={p} blocks={B * num_blocks * p} "
                  f"ms={ms:.4f}", flush=True)
        tk.topk_pieces = chosen

    for name, fn in (("torch.amin(d, dim=1)", lambda: torch.amin(d, dim=1)),
                     ("torch.topk", lambda: torch.topk(d, k, dim=1,
                                                       largest=False))):
        print(f"  yardstick {name}: ms={timer(fn):.4f}", flush=True)
    lib = variant_library("count", READ_COUNT, COUNT)
    lib.topk_flushes.restype = ctypes.c_ulonglong
    for p in sorted({1, 3, pieces}):
        tk.topk_pieces = lambda *a, p=p: p
        lib.topk_flushes()
        tk.approx_topk(d, k, num_blocks=num_blocks)
        torch.cuda.synchronize()
        warps = B * num_blocks * p * 8
        print(f"  pieces={p}: {lib.topk_flushes() / warps:.2f} buffer "
              f"merges a warp", flush=True)
    tk.topk_pieces = chosen
    for name, topk_edits, header_edits in VARIANTS:
        variant_library(name, topk_edits, header_edits)
        sweep(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
