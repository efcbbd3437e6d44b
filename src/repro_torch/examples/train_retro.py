"""Train a retrieval-augmented encoder-decoder (RETRO-style, the paper's
EncDec family) end to end (twin of ``examples/train_retro.py``): each
training batch carries retrieved-chunk embeddings for the shallow
encoder, and the decoder cross-attends to them.

    python -m repro_torch.examples.train_retro [--full] [--steps N]
        [--ckpt-dir DIR] [--device cuda|cpu]

By default EncDec-S at its reduced size (sequences of 32, batch 4,
16 encoder rows); ``--full`` is the exact Table-2 config at sequences
of 512, batch 64 and K x chunk_len = 640 encoder rows. Checkpoints every
50 steps through the crash-safe ``TrainController``; raises if the loss
did not fall. Runs on the card unless ``--device cpu`` is given.

The chunk embeddings are derived from the labels (an informative
retrieval oracle, so that the cross-attention learns to use the
encoder): encoder row i carries label i's class. With more encoder rows
than labels (``--full``: 640 rows, 512 labels) row i reads label
i mod seq_len; the reference's script reads ``labels[:, :enc_len]``
and cannot build that batch.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch.steps import build_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import TrainController


class RetroData:
    """The token stream with label-correlated chunk embeddings
    ([B, enc_len, d_model] float32)."""

    def __init__(self, src: SyntheticTokens, enc_len: int, d_model: int):
        self.src, self.enc_len, self.d_model = src, enc_len, d_model

    def host_batch(self, step, host_id=0, num_hosts=1):
        b = self.src.host_batch(step, host_id, num_hosts)
        rng = np.random.Generator(np.random.Philox(key=99, counter=step))
        B, T = b["labels"].shape
        sig = b["labels"][:, np.arange(self.enc_len) % T] % 31
        emb = (np.take(np.eye(32, self.d_model, dtype=np.float32), sig, 0)
               + 0.1 * rng.normal(size=(B, self.enc_len, self.d_model)))
        b["enc_embeds"] = emb.astype(np.float32)
        return b


def main(argv: Optional[Sequence[str]] = None) -> TrainController:
    """Train; returns the controller (every step's metrics in
    ``metrics_log``, its wall time in ``monitor.durations``)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                 "train_retro")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default="build/retro_ckpt")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    spec = get_arch("encdec_s")
    cfg = spec.model if args.full else spec.reduced
    rag = spec.rag
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.2f}M params, "
          f"{cfg.n_enc_layers}-layer encoder + {cfg.n_layers}-layer decoder, "
          f"retrieval interval {rag.interval}, K={rag.k})", flush=True)

    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = adamw.init_opt_state(params, ocfg)
    base = SyntheticTokens(DataConfig(seq_len=512 if args.full else 32,
                                      global_batch=64 if args.full else 4,
                                      vocab_size=cfg.vocab_size))
    enc_len = rag.k * rag.chunk_len if args.full else 16
    step = build_train_step(cfg, ocfg)

    def train_step(params, opt_state, batch):
        batch = dict(batch,
                     enc_embeds=batch["enc_embeds"].to(cfg.torch_dtype))
        return step(params, opt_state, batch)

    ctl = TrainController(train_step, RetroData(base, enc_len, cfg.d_model),
                          args.ckpt_dir, ckpt_every=50)
    ctl.run(params, opt, total_steps=args.steps)
    losses = [m["loss"] for m in ctl.metrics_log]
    k = max(len(losses) // 10, 1)
    first, last = np.mean(losses[:k]), np.mean(losses[-k:])
    print(f"loss: {first:.4f} (first {k}) -> {last:.4f} (last {k})",
          flush=True)
    if not last < first:
        raise RuntimeError(f"did not learn: loss {first} -> {last}")
    print("checkpoints in", args.ckpt_dir, flush=True)
    return ctl


if __name__ == "__main__":
    main(sys.argv[1:])
