"""The paper-model phases of chip_smoke.py alone, on the GPU.

    python3 tools/paper_phases.py [dec_l] [encdec_s] [encdec_l]

Builds the CUDA kernels and runs ``chip_smoke.paper_phases`` (Dec-L,
EncDec-S and EncDec-L at full width and depth, each with its own index
over the smoke's corpus, served fused and staged; RETRO against runs
without retrieval and beside its per-sequence twin), without Dec-S's
phases before them: a quicker loop for work on these models. Names on
the command line restrict it to those models. Prints each phase's line
and, last, the report keys the phases add to the smoke's kernel rows, as
JSON. It needs a CUDA GPU and exits non-zero without one.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        sys.exit("paper_phases: needs a CUDA GPU")
    import chip_smoke as cs
    from repro_torch.kernels import _build

    unknown = set(argv) - {name for name, _ in cs.PAPER}
    if unknown:
        sys.exit(f"paper_phases: unknown models {sorted(unknown)}")
    if argv:
        cs.PAPER = tuple(p for p in cs.PAPER if p[0] in argv)
    t0 = time.perf_counter()
    print(cs.nvidia_smi(), flush=True)
    _build.library()
    cs.log("device", t0, torch=torch.__version__, cuda=torch.version.cuda)
    report = {k: {} for k in ("decode_attn", "ivf_scan", "fused_scan",
                              "adc_scan")}
    cs.paper_phases(torch, torch.device("cuda"), dict(cs.FULL), report)
    cs.log("total", t0,
           peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
