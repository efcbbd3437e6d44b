"""Rank entry of the sharding tests (``launch.dp.launch(...,
"torch_sharding_ranks:run", ...)``; the tests put this directory on the
ranks' ``PYTHONPATH``), and the same training run in one process.

``train(group, argv)`` is ``launch.train.run`` with float32 parameters
and moments and, for an encoder-decoder, seeded ``enc_embeds`` beside
each batch (so that the encoder and the cross-attention train): argv is
the launcher's, plus ``--enc-len S``, ``--microbatches m`` (the step's
accumulation factor) and ``--few-ids n`` (n > 0: every token and label
id taken mod n, so that a MoE's routing piles up). ``run(group,
[out_dir, *argv])`` trains on a rank and writes ``rank<r>.json`` (its
metrics, the local shape of every leaf of its final trees, their bytes)
and, on rank 0, ``gathered/`` (``gather_named`` of the final shards,
saved as a checkpoint).
"""
import json
import pathlib

import numpy as np

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.launch import train as train_lib
from repro_torch.launch.steps import build_train_step
from repro_torch.runtime.fault_tolerance import TrainController


class WithEncoder:
    """A data source whose batches carry seeded ``enc_embeds`` [B, S, d]
    (the global batch's rows, sliced as the tokens are)."""

    def __init__(self, data, enc_len: int, d_model: int):
        self.data, self.enc_len, self.d = data, enc_len, d_model

    def host_batch(self, step, host_id=0, num_hosts=1):
        b = self.data.host_batch(step, host_id, num_hosts)
        B = self.data.cfg.global_batch
        rng = np.random.default_rng(1000 + step)
        enc = rng.normal(size=(B, self.enc_len, self.d)).astype(np.float32)
        per = B // num_hosts
        b["enc_embeds"] = enc[host_id * per:(host_id + 1) * per]
        return b


class FewIds:
    """A data source whose token and label ids are taken mod ``n``."""

    def __init__(self, data, n: int):
        self.data, self.n = data, n

    def host_batch(self, step, host_id=0, num_hosts=1):
        b = self.data.host_batch(step, host_id, num_hosts)
        return {k: v % self.n for k, v in b.items()}


def parser():
    ap = train_lib.parser()
    ap.add_argument("--enc-len", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--few-ids", type=int, default=0)
    return ap


def train(group, argv):
    """(controller, final trees of this rank) of the launcher's run."""
    args = parser().parse_args(argv)
    cfg, ocfg, data = train_lib.setup(args)
    if args.enc_len:
        data = WithEncoder(data, args.enc_len, cfg.d_model)
    if args.few_ids:
        data = FewIds(data, args.few_ids)
    step = build_train_step(cfg, ocfg, microbatches=args.microbatches,
                            group=group if group.size > 1 else None)
    ctl = TrainController(step, data, args.ckpt_dir,
                          ckpt_every=args.ckpt_every, group=group)
    trees = ctl.run(*train_lib.init_state(cfg, ocfg, group.device),
                    total_steps=args.steps)
    return ctl, trees, step.layout


def run(group, argv):
    out = pathlib.Path(argv[0])
    ctl, (params, opt), layout = train(group, argv[1:])
    record = dict(
        metrics=ctl.metrics_log,
        shapes={k: list(t.shape)
                for k, t in tree_lib.keyed((params, opt)).items()},
        param_bytes=sum(t.numel() * t.element_size()
                        for t in tree_lib.leaves(params)),
        moment_bytes=sum(t.numel() * t.element_size()
                         for t in tree_lib.leaves(opt)))
    (out / f"rank{group.rank}.json").write_text(json.dumps(record))
    if layout is not None:
        whole = layout.gather((params, opt))
        if group.rank == 0:
            ckpt_lib.save(out / "gathered", int(opt.step), whole)
