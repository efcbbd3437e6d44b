"""Plain PyTorch versions of the hierarchical top-k (twin of
``repro.kernels.topk.ref``). Ties go to the lower column, as
``lax.top_k`` and the Pallas argmin order them; +inf entries come back
as id -1."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import topk_smallest


def _columns(d: torch.Tensor) -> torch.Tensor:
    return torch.arange(d.shape[-1], device=d.device,
                        dtype=torch.int32).expand_as(d)


def ref_exact_topk(d: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k smallest per row: d [B, n] -> (dists [B, k], idx [B, k])
    ascending."""
    return topk_smallest(d, _columns(d), k)


def ref_hierarchical_topk(d: torch.Tensor, k: int, num_blocks: int,
                          k_prime: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The approximate semantics (paper §4.2.2): each of ``num_blocks``
    column blocks keeps its k' smallest, then an exact merge of the
    survivors. Returns what the kernel must return, including rows where
    truncation drops true members."""
    B, n = d.shape
    if n % num_blocks:
        raise ValueError(f"n={n} % num_blocks={num_blocks} != 0")
    l1_d, l1_i = topk_smallest(d.reshape(B, num_blocks, n // num_blocks),
                               _columns(d).reshape(B, num_blocks, -1),
                               k_prime)
    return topk_smallest(l1_d.reshape(B, -1), l1_i.reshape(B, -1), k)
