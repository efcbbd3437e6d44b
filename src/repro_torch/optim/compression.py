"""Gradient compression (twin of ``repro.optim.compression``).

Symmetric per-tensor int8 with optional stochastic rounding, and an
int8 all-reduce over a data-parallel group: each leaf's |max| is
max-reduced first so every rank quantises against one shared scale,
the int8 values are summed as int32, and the sum is dequantised.
Stochastic rounding draws from an explicit ``torch.Generator`` (the
reference splits a JAX key per leaf).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as tree_lib


def _round(y: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
    if gen is None:
        return torch.round(y)
    u = torch.rand(y.shape, generator=gen, device=gen.device)
    return torch.floor(y + u.to(y.device))


def quantize_int8(x: torch.Tensor, gen: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32) with x ~= q * scale; ``gen`` draws the
    stochastic rounding's uniforms (None: round to nearest)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    y = _round(x32 / scale, gen)
    return torch.clamp(y, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_all_reduce(tree: Any, group, gen: Optional[torch.Generator]
                          = None) -> Any:
    """All-reduce a gradient tree over ``group`` (``launch.dp.Group``) in
    int8; the twin of ``compressed_psum``. Returns a new tree, each leaf
    in its own dtype."""
    def reduce(leaf):
        x32 = leaf.float()
        amax = group.all_reduce(x32.abs().max().reshape(1), "max")[0]
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(_round(x32 / scale, gen), -127, 127).to(torch.int8)
        s = group.all_reduce(q.to(torch.int32), "sum")
        return (s.float() * scale).to(leaf.dtype)
    return tree_lib.map(reduce, tree)
