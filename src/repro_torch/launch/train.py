"""Training launcher (twin of ``repro.launch.train``):

    python -m repro_torch.launch.train --arch <id> [--reduced] [--steps N]
        [--seq-len T] [--batch B] [--lr LR] [--ckpt-dir DIR]
        [--ckpt-every N] [--data N] [--device cuda|cpu]

Seeded weights, ``SyntheticTokens``, AdamW and the fault-tolerant
``TrainController`` (periodic async checkpoints, deterministic resume,
straggler monitoring). It runs on the card unless ``--device cpu`` is
given (and refuses to run without CUDA otherwise). ``--data N`` runs N
data-parallel ranks (``launch.dp``), rank r on ``host_batch(step, r,
N)``. ``--model`` > 1 (tensor / FSDP sharding) is refused: the sharding
rules are not ported (ROADMAP Queue 1 item 20).

Rank 0 prints one ``[train] step ...`` line per step (its metrics as
JSON) and, last, the reference's ``[train] <arch>: step0 loss ... ->
final ...`` line.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from repro_torch import device as device_lib
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch import dp as dp_lib
from repro_torch.launch.steps import build_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (StragglerMonitor,
                                                 TrainController)

MODEL_PARALLEL_REFUSAL = (
    "--model > 1 needs tensor / FSDP sharding of the parameters, which the "
    "port does not have yet (models/sharding.py, ROADMAP Queue 1 item 20)")


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
                    help="tensor-parallel size (only 1)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def build(args, device):
    """(cfg, opt config, seeded params, optimiser state, data source) of a
    run: the same on every rank and in a one-rank replay."""
    cfg = get_arch(args.arch)
    cfg = cfg.reduced if args.reduced else cfg.model
    ocfg = adamw.AdamWConfig(lr=args.lr,
                             warmup_steps=min(20, args.steps // 5),
                             total_steps=args.steps)
    params = tf.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg)
    opt = adamw.init_opt_state(params, ocfg)
    data = SyntheticTokens(DataConfig(seq_len=args.seq_len,
                                      global_batch=args.batch,
                                      vocab_size=cfg.vocab_size))
    return cfg, ocfg, params, opt, data


def run(group: dp_lib.Group, argv: Sequence[str]) -> TrainController:
    """Train on this rank of ``group``; returns the controller (its
    ``metrics_log`` holds every step's metrics)."""
    args = parser().parse_args(argv)
    cfg, ocfg, params, opt, data = build(args, group.device)
    step = build_train_step(cfg, ocfg,
                            group=group if group.size > 1 else None)
    mon = StragglerMonitor(on_straggler=lambda ev: print(
        f"[straggler] step {ev.step}: {ev.ratio:.1f}x median", flush=True))
    ctl = TrainController(step, data, args.ckpt_dir,
                          ckpt_every=args.ckpt_every, monitor=mon,
                          group=group)
    ctl.run(params, opt, total_steps=args.steps)
    if group.rank == 0:
        for m in ctl.metrics_log:
            print(f"[train] step {m['step']} {json.dumps(m)}", flush=True)
        losses = [m["loss"] for m in ctl.metrics_log]
        print(f"[train] {args.arch}: step0 loss {losses[0]:.4f} -> "
              f"final {losses[-1]:.4f} over {len(losses)} steps", flush=True)
    return ctl


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    if args.model > 1:
        sys.exit(f"train: {MODEL_PARALLEL_REFUSAL}")
    dev = device_lib.resolve(args.device)
    if args.data > 1:
        dp_lib.launch(args.data, "repro_torch.launch.train:run",
                      argv + ["--device", dev.type], device=dev.type)
    else:
        run(dp_lib.Group.single(dev), argv)


if __name__ == "__main__":
    main()
