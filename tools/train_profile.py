"""Where a training step's time goes, on the GPU.

    python3 tools/train_profile.py [dec_s|encdec_s] [--steps N]

Trains the model at full width from seeded weights on synthetic tokens
(Dec-S: ``chip_smoke.TRAIN_DEC_S``'s step, 16 x 512 in 2 micro-batches;
EncDec-S: ``examples/train_retro.py --full``'s, 64 x 512 with 640
encoder rows), two warm-up steps, then ``N`` steps (default 3) under
``torch.profiler``: wall ms a step, device busy ms a step (the summed
time of the events that ran on the card over the window) and its share
of the wall time, kernels launched a step, and the device's top
kernels. The card's name and power limit lead the output. It needs a
CUDA GPU and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_profile: needs a CUDA GPU")
    import numpy as np

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.examples.train_retro import RetroData
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw

    ap = argparse.ArgumentParser()
    ap.add_argument("model", nargs="?", default="dec_s",
                    choices=("dec_s", "encdec_s"))
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    spec = get_arch(args.model)
    cfg = spec.model
    if args.model == "dec_s":
        o = cs.TRAIN_DEC_S
        B, T, micro = o["batch"], o["seq_len"], o["microbatches"]
        data = SyntheticTokens(DataConfig(T, B, cfg.vocab_size))
    else:
        B, T, micro = 64, 512, 1
        data = RetroData(SyntheticTokens(DataConfig(T, B, cfg.vocab_size)),
                         spec.rag.k * spec.rag.chunk_len, cfg.d_model)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100)
    step = build_train_step(cfg, ocfg, remat=True, microbatches=micro)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = adamw.init_opt_state(params, ocfg)

    def batch(s):
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
               for k, v in data.host_batch(s).items()}
        if "enc_embeds" in out:
            out["enc_embeds"] = out["enc_embeds"].to(cfg.torch_dtype)
        return out
    batches = [batch(s) for s in range(2 + args.steps)]
    for s in range(2):
        params, opt, m = step(params, opt, batches[s])
        float(m["loss"])
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for s in range(2, 2 + args.steps):
            params, opt, m = step(params, opt, batches[s])
            float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    rows = sorted(((getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0.0)), e.count,
                   e.key) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)[::-1]
    busy_us = sum(r[0] for r in rows)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx"))
    n = args.steps
    cs.log(f"train_profile.{args.model}", t0, steps=n, batch=B, seq=T,
           microbatches=micro, wall_ms_per_step=f"{wall * 1e3 / n:.1f}",
           device_busy_ms_per_step=f"{busy_us / 1e3 / n:.1f}",
           device_busy_share=f"{busy_us / 1e6 / wall:.3f}",
           kernel_launches_per_step=launches // n)
    for us, count, key in rows[:20]:
        print(f"  device {us / 1e3 / n:9.3f} ms/step  x{count // n:<6d} "
              f"{key[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
