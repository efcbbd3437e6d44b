"""Where the IVF probe kernel's time goes, phase by phase, on the GPU.

    python3 tools/ivf_phase_trace.py

Builds a copy of ``src/repro_torch/csrc`` into ``build/trace/`` with the
GPU's global timer read at the phase boundaries of
``csrc/ivf_scan.cu`` (block start, first chunk staged, each tile's
epilogue, end of the main loop, each merge level's win / staged lists /
merged lists, end), runs the probe at the serve shape (32 queries, 256
centroids of 512 floats) and at SYN-512's nlist (32 768), and prints,
for each phase, how many blocks reached it and the min / median / max
time since the first block started, in microseconds. The stamps are
read by thread 0 of each block; the copy's kernel is otherwise the
shipped one. It needs a CUDA GPU and exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STAMP = ("#define STAMP(slot) do { if (threadIdx.x == 0) { "
         "unsigned long long v_; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v_)); "
         "g_stamp[(blockIdx.x * gridDim.y + blockIdx.y) * 64 + (slot)] = v_; "
         "} } while (0)\n")
# (anchor in ivf_scan.cu, text put in its place)
EDITS = [
    ("namespace {\n\nconstexpr int kThreads",
     "__device__ unsigned long long g_stamp[1 << 16];\n" + STAMP +
     "namespace {\n\nconstexpr int kThreads"),
    ("  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n"
     "  const int qt",
     "  STAMP(0);\n  const int t = threadIdx.x, lane = t & 31, "
     "warp = t >> 5;\n  const int qt"),
    ("    if (++d_i < chunks) continue;\n    d_i = 0;\n",
     "    if (s == 0) STAMP(1);\n    if (++d_i < chunks) continue;\n"
     "    d_i = 0;\n    STAMP(2 + 2 * min(s / chunks, 13));\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();\n\n  // merge the splits'",
     "  cp_async_wait<0>();\n  __syncthreads();\n  STAMP(30);\n"
     "  int level_ = 0;\n\n  // merge the splits'"),
    ("      if (!last_block(counters + qt * n_counters + cnt0 + group, "
     "members))\n        return;",
     "      if (!last_block(counters + qt * n_counters + cnt0 + group, "
     "members))\n        return;\n      STAMP(31 + 3 * level_);"),
    ("        cp_async_wait<0>();\n        __syncthreads();\n"
     "        merge_lists",
     "        cp_async_wait<0>();\n        __syncthreads();\n"
     "        STAMP(32 + 3 * level_);\n        merge_lists"),
    ("    slot0 += n;\n",
     "    STAMP(33 + 3 * level_);\n    ++level_;\n    slot0 += n;\n"),
    ("  for (int i = t; i < kTQ * nprobe; i += kThreads) {\n"
     "    const int r = i / nprobe;\n    if (q0 + r >= nq) break;",
     "  STAMP(60);\n  for (int i = t; i < kTQ * nprobe; i += kThreads) {\n"
     "    const int r = i / nprobe;\n    if (q0 + r >= nq) break;"),
    ("RT_EXPORT int ivf_scan_launch(",
     "RT_EXPORT int ivf_stamp_read(void* dst, int n) {\n"
     "  return cudaMemcpyFromSymbol(dst, g_stamp, (size_t)n * 8);\n}\n"
     "RT_EXPORT int ivf_stamp_clear() {\n"
     "  static unsigned long long zero[1 << 16];\n"
     "  return cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero));\n}\n"
     "RT_EXPORT int ivf_scan_launch("),
]
PHASES = {0: "start", 1: "chunk0", 30: "main_end", 60: "end"}
PHASES.update({2 + 2 * i: f"tile{i}_end" for i in range(14)})
for lv in range(8):
    PHASES.update({31 + 3 * lv: f"L{lv}_won", 32 + 3 * lv: f"L{lv}_staged",
                   33 + 3 * lv: f"L{lv}_merged"})


def instrumented_library():
    """Builds the stamped copy of the kernels and binds it in place of the
    shipped build (this process only)."""
    from repro_torch.kernels import _build

    csrc = ROOT / "build" / "trace" / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(_build.CSRC, csrc)
    path = csrc / "ivf_scan.cu"
    text = path.read_text()
    for anchor, new in EDITS:
        if anchor not in text:
            raise RuntimeError(f"ivf_scan.cu changed: {anchor[:50]!r}")
        text = text.replace(anchor, new)
    path.write_text(text)
    _build.CSRC, _build.BUILD = csrc, ROOT / "build" / "trace" / "lib"
    return _build.library()


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("ivf_phase_trace: needs a CUDA GPU")
    from repro_torch.kernels import _build
    from repro_torch.kernels.ivf_scan import ops as iv

    lib = instrumented_library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sms = _build.sm_count(dev)
    print(torch.cuda.get_device_name(0), flush=True)
    for nlist in (256, 32768):
        queries = torch.randn((32, 512), generator=g, device=dev)
        cents = torch.randn((nlist, 512), generator=g, device=dev)
        tq, _, splits = iv.probe_grid(32, nlist, sms)
        blocks = -(-32 // tq) * splits
        for _ in range(4):                  # the last run is read
            lib.ivf_stamp_clear()
            torch.cuda.synchronize()
            iv.ivf_index_scan(queries, cents, 32)
            torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (blocks * 64))()
        lib.ivf_stamp_read(buf, blocks * 64)
        a = np.array(buf, dtype=np.float64).reshape(blocks, 64)
        t0 = a[:, 0][a[:, 0] > 0].min()
        us = np.where(a > 0, (a - t0) / 1e3, np.nan)
        print(f"nq=32 nlist={nlist} D=512 nprobe=32: {blocks} blocks of "
              f"{tq} queries", flush=True)
        for slot, name in sorted(PHASES.items()):
            v = us[:, slot][np.isfinite(us[:, slot])]
            if v.size:
                print(f"  {name:>10s}  blocks={v.size:4d}  min={v.min():8.2f}"
                      f"  median={np.median(v):8.2f}  max={v.max():8.2f} us",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
