"""The sharded train step of Phi-3.5-MoE at full width on a mesh of ranks
sharing one card, from the ``repro_torch`` of a given source tree: a
one-time measurement that puts a tree whose sharded step gathers the
experts over "data" beside one that keeps them on their owners (expert
parallelism), in one call on one card.

    python3 docs/measurements/moe_step_cost.py --src PATH/src
        [--layers 1] [--steps 2] [--data 2] [--model 2] [--seq-len 512]
        [--batch 8]

Phi-3.5-MoE (d 4096, 32:8 heads of 128, 16 experts top-2, d_ff 6400,
vocab 32 064, bf16, bf16 moments) cut to ``--layers`` layers, seeded
weights on the card, each rank keeping its shards (``put_named`` of the
step's specs, the moments made on the shards), batches of seeded ids
below 4 (the routing piles up, as in ``chip_smoke.py``'s ``train.ep``).
Rank 0 prints one JSON line: each step's ms, loss and each axis's
collective MB and ms (``data_mb`` / ``model_mb``), and every rank's
resident and peak memory. It needs a CUDA card.
"""
import argparse
import json
import os
import pathlib
import sys
import time


def rank(group, argv):
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import put_named
    from repro_torch.optim import adamw

    layers, steps, T, B = (int(a) for a in argv)
    dev = group.device
    cfg = dataclasses.replace(get_arch("phi3_5_moe_42b").model,
                              n_layers=layers)
    ocfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=steps,
                             state_dtype="bfloat16")
    step = build_train_step(cfg, ocfg, group=group)
    whole = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    params = put_named(whole, step.layout.specs, group.mesh, group)
    del whole
    opt = adamw.init_opt_state(params, ocfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = sum(t.numel() * t.element_size()
               for t in tree_lib.leaves((params, opt)))
    D, d = group.shape["data"], group.coords["data"]
    toks = np.random.default_rng(0).integers(0, 4, size=(steps, B, T + 1))
    out = []
    for s in range(steps):
        rows = toks[s, d * B // D:(d + 1) * B // D]
        batch = {"tokens": torch.from_numpy(rows[:, :-1]).int().to(dev),
                 "labels": torch.from_numpy(rows[:, 1:]).int().to(dev)}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize(dev)
        out.append(dict({k: float(v) for k, v in m.items()},
                        step_ms=(time.perf_counter() - t0) * 1e3))
    mem = torch.tensor([[held, torch.cuda.max_memory_allocated(dev)]],
                       dtype=torch.int64, device=dev)
    mem = group.all_gather(mem).cpu().tolist()
    if group.rank == 0:
        print("[moe_step_cost] " + json.dumps(dict(
            layers=layers, mesh=group.shape, seq=T, global_batch=B,
            steps=out, resident_bytes=[m[0] for m in mem],
            peak_bytes=[m[1] for m in mem])), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="the src directory of the tree to measure")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    here = pathlib.Path(__file__).resolve().parent
    src = str(pathlib.Path(args.src).resolve())
    sys.path.insert(0, src)
    os.environ["PYTHONPATH"] = os.pathsep.join([src, str(here)])
    import torch
    if not torch.cuda.is_available():
        sys.exit("moe_step_cost: needs a CUDA card")
    from repro_torch.launch import dp
    t0 = time.perf_counter()
    dp.launch(args.data * args.model, "moe_step_cost:rank",
              [str(args.layers), str(args.steps), str(args.seq_len),
               str(args.batch)], device="cuda", timeout_s=1200,
              model=args.model)
    print(f"[moe_step_cost] launch {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
