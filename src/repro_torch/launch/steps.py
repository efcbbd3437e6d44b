"""Step builders (twin of ``repro.launch.steps``): the training step.

``build_train_step`` returns ``train_step(params, opt_state, batch)``:
forward, backward through ``transformer.lm_loss`` (the FA2 attention
backward, ``remat`` per layer cycle), gradient accumulation over
micro-batches, and AdamW, updating the parameter and moment tensors in
place. The reference's step is one jitted, GSPMD-sharded program; here
it runs eagerly, and data parallelism is explicit: with a ``group``
(``launch.dp.Group``) of more than one rank the step all-reduces the
summed loss, the valid-token count and every gradient, so the mean is
the global batch's mean even where labels are masked.

``build_prefill_step`` and ``build_serve_step`` belong to the dry run,
which is not ported.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import SHAPES, ArchSpec
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


def default_microbatches(spec: ArchSpec, shape_name: str,
                         world_size: int) -> int:
    """Gradient-accumulation factor so that each micro-batch's saved
    activations (n_layers x [B_loc, T, d] bf16 under remat) stay within
    6 GB beside the parameters, moments and gradients."""
    cfg = spec.model
    sh = SHAPES[shape_name]
    b_loc = max(sh["global_batch"] // max(world_size, 1), 1)
    save_bytes = cfg.n_layers * b_loc * sh["seq_len"] * cfg.d_model * 2
    budget = 6e9
    micro = 1
    while save_bytes / micro > budget and micro < b_loc:
        micro *= 2
    return micro


def _split(batch: Dict[str, torch.Tensor], n: int):
    """``n`` micro-batches of consecutive rows ([3, B, T] positions split
    on their batch axis)."""
    parts = {k: torch.chunk(v, n, dim=1 if k == "positions" and v.ndim == 3
                            else 0) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def _grad(loss: torch.Tensor, leaves):
    """d loss / d leaves; zeros for a leaf the loss does not read (the
    token table under a batch of ``embeds``), as JAX gives."""
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def build_train_step(cfg: ModelConfig,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     remat: bool = True, microbatches: int = 1,
                     group=None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``. Metrics: ``loss``, ``grad_norm``, ``lr``, and
    with a group of more than one rank ``allreduce_ms`` /
    ``allreduce_bytes`` (the staged all-reduce, host wall time).

    One rank follows the reference: the loss is the mean of the
    micro-batches' means, the gradients their mean, accumulated in
    float32 (micro-batches of 1: the parameters' dtype)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    dp = group is not None and group.size > 1

    def train_step(params, opt_state, batch):
        leaves = tree_lib.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        metrics = {}
        if dp:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            total = torch.zeros((), dtype=torch.float32,
                                device=leaves[0].device)
            count = torch.zeros_like(total)
            for mb in _split(batch, microbatches):
                s, n = tf.nll_sum(params, cfg, mb, remat=remat)
                for a, g in zip(acc, _grad(s, leaves)):
                    a += g.float()
                total += s.detach()
                count += n
            flat = torch.cat([total.reshape(1), count.reshape(1)]
                             + [a.reshape(-1) for a in acc])
            _sync(flat)
            t0 = time.perf_counter()
            group.all_reduce(flat, "sum")
            _sync(flat)
            metrics["allreduce_ms"] = (time.perf_counter() - t0) * 1e3
            metrics["allreduce_bytes"] = flat.numel() * flat.element_size()
            denom = flat[1].clamp(min=1)
            loss = flat[0] / denom
            grads, off = [], 2
            for a in acc:
                grads.append((flat[off:off + a.numel()] / denom).view(a.shape))
                off += a.numel()
        elif microbatches <= 1:
            loss = tf.lm_loss(params, cfg, batch, remat=remat)
            grads = _grad(loss, leaves)
            loss = loss.detach()
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb in _split(batch, microbatches):
                mloss = tf.lm_loss(params, cfg, mb, remat=remat)
                for a, g in zip(grads, _grad(mloss, leaves)):
                    a += g.float()
                loss = loss + mloss.detach()
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        grads = tree_lib.unflatten_like(params, iter(grads))
        params, opt_state, m = adamw.apply_updates(params, grads, opt_state,
                                                   opt_cfg)
        metrics.update(m, loss=loss)
        return params, opt_state, metrics

    return train_step
