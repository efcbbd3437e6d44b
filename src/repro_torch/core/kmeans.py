"""Lloyd's k-means (twin of ``repro.core.kmeans``) for the IVF coarse
quantizer and the PQ codebooks.

The reference materializes an ``[n, k]`` distance matrix and an
``[n, k]`` one-hot per iteration (``kmeans.py:53-57``); at index-build
scale that is tens of GB. Here the assignment runs over chunks of
``chunk`` points and the cluster sums use ``index_add_``. Same algorithm
otherwise: distance-weighted seeding, then ``iters`` Lloyd steps, with
empty clusters re-seeded at the worst-represented points.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _pairwise_sq_l2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[n, d] x [k, d] -> [n, k] squared L2 (matmul form)."""
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (c * c).sum(-1)
    return x2 - 2.0 * (x @ c.T) + c2[None, :]


def _init_centroids(gen: torch.Generator, x: torch.Tensor, k: int
                    ) -> torch.Tensor:
    """Distance-weighted seeding: one uniform seed, then k-1 points
    sampled without replacement with probability ∝ distance to it
    (Gumbel-top-k). Random numbers come from ``gen`` on the host."""
    n = x.shape[0]
    first = int(torch.randint(0, n, (), generator=gen))
    d = ((x - x[first]) ** 2).sum(-1)
    u = torch.rand(n, generator=gen, dtype=torch.float32).to(x.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    idx = torch.topk(torch.log(d + 1e-12) + gumbel, k - 1).indices
    return torch.cat([x[first][None], x[idx]], dim=0)


def assign_nearest(x: torch.Tensor, cent: torch.Tensor, chunk: int = 65536
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid of every row, ``chunk`` rows at a time:
    (assignment [n] int64, squared distance to it [n])."""
    assign = torch.empty(x.shape[0], dtype=torch.long, device=x.device)
    dmin = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], chunk):
        d = _pairwise_sq_l2(x[s:s + chunk], cent)
        v, i = d.min(dim=-1)
        dmin[s:s + chunk] = v
        assign[s:s + chunk] = i
    return assign, dmin


def kmeans(x: torch.Tensor, k: int, iters: int = 20,
           generator: Optional[torch.Generator] = None,
           init: Optional[torch.Tensor] = None, chunk: int = 65536
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm. Returns (centroids [k, d], assignment [n]).

    ``init`` replaces the seeding (tests inject the reference's initial
    centroids); otherwise the seeds come from ``generator``."""
    x = x.float()
    n, dim = x.shape
    if init is not None:
        cent = init.to(device=x.device, dtype=torch.float32)
    else:
        gen = generator if generator is not None else torch.Generator()
        cent = _init_centroids(gen, x, k)
    for _ in range(iters):
        assign, point_loss = assign_nearest(x, cent, chunk)
        counts = torch.bincount(assign, minlength=k).float()
        sums = torch.zeros((k, dim), device=x.device).index_add_(0, assign, x)
        new_cent = sums / torch.clamp(counts, min=1.0)[:, None]
        # empty-cluster repair: empty slots move onto the globally
        # worst-represented points, one per empty slot by rank (a stable
        # descending sort keeps the reference's lower-index-first ties)
        worst = torch.sort(point_loss, descending=True, stable=True
                           ).indices[:k]
        empty = counts < 0.5
        rank = torch.cumsum(empty.int(), 0) - 1
        repair = x[worst[torch.clamp(rank, 0, k - 1)]]
        cent = torch.where(empty[:, None], repair, new_cent)
    assign, _ = assign_nearest(x, cent, chunk)
    return cent, assign
