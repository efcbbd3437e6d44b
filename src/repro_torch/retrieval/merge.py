"""K-selection merge of the shards' candidate lists (twin of
``repro.retrieval.merge``, paper §4.2 steps 7-8).

Both merges are exact and keep the reference's tie order: candidates
are laid out shard-major (``flat_merge``) or group-major
(``hierarchical_merge``) exactly as the reference lays them out, and
each selection is a stable sort, so equal distances keep their
lower-index-first order. Absent candidates are ``(+inf, -1)``, and
``mask_producers`` turns a dead producer's lists into exactly that, so a
partial-result flush stays an exact search over the live producers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

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



def merge_topk(dists: torch.Tensor, ids: torch.Tensor, k: int,
               fanout: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The service's merge entry point: flat (``fanout=None``, the
    default) or hierarchical with ``fanout`` producers per node."""
    if fanout is None or dists.shape[0] <= 1:
        return flat_merge(dists, ids, k)
    return hierarchical_merge(dists, ids, k, fanout=fanout)


def mask_producers(dists: torch.Tensor, ids: torch.Tensor, live: np.ndarray
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask dead producers' candidate lists [S, nq, k'] to ``(+inf, -1)``
    before a merge; ``live`` is a host bool array [S]. The mask crosses
    to the candidates' device from pinned memory without a host sync,
    and the downstream K-selection is then exactly the global top-k over
    the surviving producers' candidates."""
    mask = torch.from_numpy(np.ascontiguousarray(live, dtype=bool))
    if dists.is_cuda:
        mask = mask.pin_memory().to(dists.device, non_blocking=True)
    mask = mask.reshape((-1,) + (1,) * (dists.ndim - 1))
    return (torch.where(mask, dists, torch.full_like(dists, float("inf"))),
            torch.where(mask, ids, torch.full_like(ids, -1)))
