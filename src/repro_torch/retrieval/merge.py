"""K-selection merge of the shards' candidate lists (twin of
``repro.retrieval.merge``, paper §4.2 steps 7-8).

Both merges are exact and keep the reference's tie order: candidates
are laid out shard-major (``flat_merge``) or group-major
(``hierarchical_merge``) exactly as the reference lays them out, and
each selection is a stable sort, so equal distances keep their
lower-index-first order. Absent candidates are ``(+inf, -1)``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import topk_smallest


def _pad_to_k(dists: torch.Tensor, ids: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad [..., c] candidate lists with (+inf, -1) up to k columns."""
    c = dists.shape[-1]
    if c >= k:
        return dists[..., :k], ids[..., :k]
    pad = list(dists.shape[:-1]) + [k - c]
    return (torch.cat([dists, dists.new_full(pad, float("inf"))], dim=-1),
            torch.cat([ids, ids.new_full(pad, -1)], dim=-1))


def _select(dists: torch.Tensor, ids: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k smallest along the last axis, ascending, stable."""
    return topk_smallest(dists, ids, min(k, dists.shape[-1]))


def flat_merge(dists: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[S, nq, k'] -> ([nq, K], [nq, K]) in one K-selection."""
    S, nq, c = dists.shape
    d = dists.permute(1, 0, 2).reshape(nq, S * c)
    i = ids.permute(1, 0, 2).reshape(nq, S * c)
    return _pad_to_k(*_select(d, i, k), k)


def hierarchical_merge(dists: torch.Tensor, ids: torch.Tensor, k: int,
                       fanout: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tree merge with ``fanout`` producers per node, exact at every
    level. [S, nq, k'] -> ([nq, K], [nq, K])."""
    if fanout < 2:
        raise ValueError(f"fanout must be >= 2, got {fanout}")
    d, i = dists, ids
    while d.shape[0] > 1:
        S, nq, c = d.shape
        pad = (-S) % fanout
        if pad:
            d = torch.cat([d, d.new_full((pad, nq, c), float("inf"))])
            i = torch.cat([i, i.new_full((pad, nq, c), -1)])
        groups = d.shape[0] // fanout
        d = d.reshape(groups, fanout, nq, c).permute(0, 2, 1, 3) \
             .reshape(groups, nq, fanout * c)
        i = i.reshape(groups, fanout, nq, c).permute(0, 2, 1, 3) \
             .reshape(groups, nq, fanout * c)
        d, i = _select(d, i, k)
    return _pad_to_k(*_select(d[0], i[0], k), k)

