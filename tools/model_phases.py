"""The per-model phases of chip_smoke.py alone, on the GPU.

    python3 tools/model_phases.py [dec_l] [encdec_s] [encdec_l] [heads]
                                  [qwen2_0_5b] [phi3_mini_3_8b] [gemma3_4b]
                                  [dbrx_132b] [hymba_1_5b] [rwkv6_3b]
                                  [phi3_5_moe_42b] [seamless_m4t_medium]
                                  [train.dec_s] [train.encdec_s] [train.dp]
                                  [train.tp] [train.flash_attn]

Builds the CUDA kernels and runs ``chip_smoke.paper_phases`` (Dec-L,
EncDec-S and EncDec-L at full width and depth, each with its own index
over the smoke's corpus, served fused and staged; RETRO against runs
without retrieval and beside its per-sequence twin),
``chip_smoke.assigned_phases`` (``heads``: decode attention at
Llama-3-405B's and Qwen2-VL-72B's head layouts; then Qwen2-0.5B,
Phi-3-mini and Gemma-3-4B at full width and depth, each with its own
corpus and index, served fused and staged) and
``chip_smoke.nondense_phases`` (``dbrx_132b``: DBRX's head layout and one
full-width MoE layer; Hymba-1.5B, RWKV-6-3B and Phi-3.5-MoE at 16
layers served fused and staged; SeamlessM4T-medium through RETRO),
and ``chip_smoke.train_phases`` (``train.dec_s``: Dec-S trained at full
width, straight and crashed and resumed; ``train.encdec_s``: the RETRO
training example at full width; ``train.dp``: two data-parallel ranks on
the card against one; ``train.tp``: a 2 x 2 mesh of sharded ranks on the
card against one; ``train.flash_attn``: the FA2 backward at the
training shapes), without Dec-S's serving phases before them: a quicker
loop for work on these models. Names on the command line restrict it to
those models and training phases (none: all of them). Prints each
phase's line and, last, the report keys the phases add to the smoke's
kernel rows, as JSON. It needs a CUDA GPU and exits non-zero without
one.
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
        sys.exit("model_phases: needs a CUDA GPU")
    import chip_smoke as cs
    from repro_torch.kernels import _build

    paper = {name for name, _ in cs.PAPER}
    served = {name for name, _ in cs.ASSIGNED_SERVED + cs.NONDENSE_SERVED
              + cs.SEAMLESS}
    train = {f"train.{name}" for name in cs.TRAIN_PHASES}
    unknown = set(argv) - paper - served - train - {"heads", cs.DBRX}
    if unknown:
        sys.exit(f"model_phases: unknown models {sorted(unknown)}")
    if argv:
        cs.TRAIN_PHASES = tuple(name for name in cs.TRAIN_PHASES
                                if f"train.{name}" in argv)
        cs.PAPER = tuple(p for p in cs.PAPER if p[0] in argv)
        cs.ASSIGNED_SERVED = tuple(p for p in cs.ASSIGNED_SERVED
                                   if p[0] in argv)
        cs.NONDENSE_SERVED = tuple(p for p in cs.NONDENSE_SERVED
                                   if p[0] in argv)
        cs.SEAMLESS = tuple(p for p in cs.SEAMLESS if p[0] in argv)
        if "heads" not in argv:
            cs.HEAD_LAYOUTS = ()
        if cs.DBRX not in argv:
            cs.DBRX = None
    t0 = time.perf_counter()
    print(cs.nvidia_smi(), flush=True)
    _build.library()
    cs.log("device", t0, torch=torch.__version__, cuda=torch.version.cuda)
    report = {k: {} for k in ("decode_attn", "ivf_scan", "fused_scan",
                              "adc_scan")}
    dev = torch.device("cuda")
    if cs.PAPER:
        cs.paper_phases(torch, dev, dict(cs.FULL), report)
    cs.assigned_phases(torch, dev, dict(cs.FULL), report)
    cs.nondense_phases(torch, dev, dict(cs.FULL), report)
    if cs.TRAIN_PHASES:
        cs.train_phases(torch, dev)
    cs.log("total", t0,
           peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
