"""Training launcher (twin of ``repro.launch.train``):

    python -m repro_torch.launch.train --arch <id> [--reduced] [--steps N]
        [--seq-len T] [--batch B] [--lr LR] [--ckpt-dir DIR]
        [--ckpt-every N] [--data D] [--model M] [--dtype DTYPE]
        [--state-dtype DTYPE] [--device cuda|cpu]

Seeded weights, ``SyntheticTokens``, AdamW and the fault-tolerant
``TrainController`` (periodic async checkpoints, deterministic resume,
straggler monitoring). It runs on the card unless ``--device cpu`` is
given (and refuses to run without CUDA otherwise). ``--data D --model
M`` runs D x M ranks (``launch.dp``), rank r at mesh coordinates
(r // M, r % M) reading ``host_batch(step, r // M, D)``. With M = 1 the
D ranks are data-parallel, each holding every parameter; with M > 1 the
step is sharded as the reference's ``sanitize(param_specs(...))`` lays
it out (FSDP over "data", tensor parallelism over "model";
``launch.steps``). A run resumes from the newest checkpoint in
``--ckpt-dir`` (whole leaves), whatever mesh wrote it. ``--dtype`` /
``--state-dtype`` override the model's parameter dtype and AdamW's
moment dtype (float32 for parity runs against the reference).

Rank 0 prints the bytes of parameters and optimiser state each rank
holds (``[train] resident {...}``, rank order), one ``[train] step ...``
line per step (its metrics and wall ms as JSON) and, last, the
reference's ``[train] <arch>: step0 loss ... -> final ...`` line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional, Sequence

import torch

from repro_torch import device as device_lib
from repro_torch import tree as tree_lib
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch import dp as dp_lib
from repro_torch.launch.steps import build_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (StragglerMonitor,
                                                 TrainController)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-size config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--data", type=int, default=1, help="data-parallel size")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel size")
    ap.add_argument("--dtype", default=None,
                    help="parameter dtype (default: the model's)")
    ap.add_argument("--state-dtype", default="bfloat16",
                    help="AdamW moment dtype")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def setup(args):
    """(cfg, opt config, data source) of a run."""
    cfg = get_arch(args.arch)
    cfg = cfg.reduced if args.reduced else cfg.model
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    ocfg = adamw.AdamWConfig(lr=args.lr,
                             warmup_steps=min(20, args.steps // 5),
                             total_steps=args.steps,
                             state_dtype=args.state_dtype)
    data = SyntheticTokens(DataConfig(seq_len=args.seq_len,
                                      global_batch=args.batch,
                                      vocab_size=cfg.vocab_size))
    return cfg, ocfg, data


def init_state(cfg, ocfg, device):
    """Seeded whole params and their optimiser state on ``device``."""
    params = tf.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg)
    return params, adamw.init_opt_state(params, ocfg)


def build(args, device):
    """(cfg, opt config, seeded params, optimiser state, data source) of a
    run: the same on every rank and in a one-rank replay."""
    cfg, ocfg, data = setup(args)
    return (cfg, ocfg) + init_state(cfg, ocfg, device) + (data,)


def run(group: dp_lib.Group, argv: Sequence[str]) -> TrainController:
    """Train on this rank of ``group``; returns the controller (its
    ``metrics_log`` holds every step's metrics). The whole initial trees
    go straight to the controller, so a sharded rank keeps only its
    shards."""
    args = parser().parse_args(argv)
    cfg, ocfg, data = setup(args)
    step = build_train_step(cfg, ocfg,
                            group=group if group.size > 1 else None)
    mon = StragglerMonitor(on_straggler=lambda ev: print(
        f"[straggler] step {ev.step}: {ev.ratio:.1f}x median", flush=True))
    ctl = TrainController(step, data, args.ckpt_dir,
                          ckpt_every=args.ckpt_every, monitor=mon,
                          group=group)
    params, opt = ctl.run(*init_state(cfg, ocfg, group.device),
                          total_steps=args.steps)
    held = torch.tensor([[sum(t.numel() * t.element_size()
                              for t in tree_lib.leaves(tree))
                          for tree in (params, opt)]], dtype=torch.int64)
    held = group.all_gather(held.to(group.device)).cpu()
    if group.rank == 0:
        print(f"[train] resident " + json.dumps(dict(
            param_bytes=held[:, 0].tolist(),
            moment_bytes=held[:, 1].tolist())), flush=True)
        for m, d in zip(ctl.metrics_log, ctl.monitor.durations):
            m = dict(m, step_ms=d * 1e3)
            print(f"[train] step {m['step']} {json.dumps(m)}", flush=True)
        losses = [m["loss"] for m in ctl.metrics_log]
        print(f"[train] {args.arch}: step0 loss {losses[0]:.4f} -> "
              f"final {losses[-1]:.4f} over {len(losses)} steps", flush=True)
    return ctl


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    dev = device_lib.resolve(args.device)
    if args.data * args.model > 1:
        dp_lib.launch(args.data * args.model, "repro_torch.launch.train:run",
                      argv + ["--device", dev.type], device=dev.type,
                      model=args.model)
    else:
        run(dp_lib.Group.single(dev), argv)


if __name__ == "__main__":
    main()
