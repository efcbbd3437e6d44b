"""AdamW (twin of ``repro.optim.adamw``).

The update math runs in float32 whatever the leaves' dtypes;
``state_dtype="bfloat16"`` (the default) keeps the moments in bf16.
Decoupled weight decay applies to matrices (``ndim >= 2``) only.

The reference's ``apply_updates`` returns new trees, and its train step
donates the old ones; here ``apply_updates`` writes the new values into
the parameter and moment tensors in place (under ``no_grad``) and
returns the same trees. Parameters and states are trees of tensors:
dicts and the models' NamedTuples (``repro_torch.tree``).

Sharded over a mesh of ranks (``launch.steps``' sharded step), each rank
updates its shards: the update is elementwise, and only the clipping
norm needs the whole tree. ``global_norm`` then sums each rank's
``counted`` leaves' squares and all-reduces the sum over the mesh: a
leaf replicated over an axis is counted on that axis's coordinate 0
only, so every element counts once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "bfloat16"   # "float32" for exact Adam moments
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor      # scalar int32
    m: Any                  # like params
    v: Any                  # like params


def init_opt_state(params, cfg: AdamWConfig) -> OptState:
    dt = getattr(torch, cfg.state_dtype)
    first = tree_lib.leaves(params)[0]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_lib.map(lambda p: torch.zeros(p.shape, dtype=dt,
                                             device=p.device), params),
        v=tree_lib.map(lambda p: torch.zeros(p.shape, dtype=dt,
                                             device=p.device), params))


def lr_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (float32, on the
    step's device)."""
    s = torch.as_tensor(step).float()
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree, group=None, counted=None) -> torch.Tensor:
    """The L2 norm of every leaf. Over a mesh ``group``: of the leaves
    flagged in ``counted`` (a bool per leaf, in leaf order) on each rank,
    summed over the group."""
    if group is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree_lib.leaves(tree)))
    leaves = tree_lib.leaves(tree)
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x, c in zip(leaves, counted):
        if c:
            sq = sq + torch.sum(torch.square(x.float()))
    return torch.sqrt(group.all_reduce(sq, "sum"))


def clip_by_global_norm(grads, max_norm: float, group=None, counted=None
                        ) -> Tuple[Any, torch.Tensor]:
    """(grads scaled to at most ``max_norm`` in global norm, each in its
    own dtype; the norm before)."""
    g = global_norm(grads, group, counted)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_lib.map(lambda x: (x.float() * scale).to(x.dtype),
                        grads), g


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: AdamWConfig,
                  group=None, counted=None) -> Tuple[Any, OptState, dict]:
    """One AdamW step, in place. Returns (params, state, metrics). With a
    mesh ``group`` the trees are this rank's shards (``global_norm``)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, group, counted)
    state.step.add_(1)
    lr = lr_schedule(state.step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    t = state.step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=t.device), t)
    sdt = getattr(torch, cfg.state_dtype)

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + torch.square(g32) * (1 - b2)
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        p32 = p.float()
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
        m.copy_(m32.to(sdt))
        v.copy_(v32.to(sdt))

    tree_lib.map(upd, params, grads, state.m, state.v)
    return params, state, dict(grad_norm=gnorm, lr=lr)
