"""Plain IVF-PQ search and kNN-LM mix: the reference for the retrieval
side of every cell.

The index is the benchmark's own (``inputs.Index``): coarse centroids,
PQ codebooks, and per shard the codes of every list padded to ``cap``
rows, ``lens`` valid. A search takes, per query, the ``nprobe`` nearest
centroids (squared L2, ties to the lower list), the lookup tables (``m``
sub-spaces x ``2 ** nbits`` codewords: one a query, or for a residual
index one a query and probed list, of the query less the list's
centroid), the ADC distance of every valid row of the probed lists (the
``m`` table entries summed in sub-space order), and per shard the ``k'``
nearest (the
truncated queue of the paper's section 4.2.2, ``k_prime``); the shards'
lists are merged to the ``K`` nearest. Every sort is stable, so equal
distances keep candidate order.

``knn_mix`` is the kNN-LM distribution: log((1 - lam) softmax(logits)
+ lam p_knn) with p_knn(w) proportional to the sum of exp(-d / T) over
the neighbours whose payload token is w.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _binom_tail(n: int, p: float, k: int) -> float:
    """P[Binomial(n, p) > k]."""
    head = sum(math.comb(n, i) * p ** i * (1 - p) ** (n - i)
               for i in range(k + 1))
    return max(0.0, 1.0 - head)


def k_prime(K: int, shards: int, eps: float) -> int:
    """The smallest per-shard queue length for which the union bound on
    any shard holding more than it of the top K is at most ``eps``."""
    if shards <= 1:
        return K
    for kk in range(1, K + 1):
        if min(1.0, shards * _binom_tail(K, 1.0 / shards, kk)) <= eps:
            return kk
    return K


def _first_k(d: torch.Tensor, i: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``k`` of a stable ascending sort of each row; +inf
    distances report id -1."""
    ds, order = torch.sort(d, dim=-1, stable=True)
    ds, ids = ds[..., :k], torch.gather(i, -1, order[..., :k])
    return ds, torch.where(torch.isinf(ds), torch.full_like(ids, -1), ids)


def probe(centroids: torch.Tensor, q: torch.Tensor, nprobe: int,
          block: int = 8) -> torch.Tensor:
    """[Q, d] float32 queries -> the ``nprobe`` nearest lists [Q, nprobe]."""
    out = []
    cols = torch.arange(centroids.shape[0], device=q.device)
    for s in range(0, q.shape[0], block):
        d = ((q[s:s + block, None, :] - centroids[None]) ** 2).sum(-1)
        out.append(_first_k(d, cols.expand_as(d), nprobe)[1])
    return torch.cat(out)


def luts(codebooks: torch.Tensor, q: torch.Tensor,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[Q, d] -> the lookup tables [Q, m, ksub]: the squared distance of each
    query sub-vector to each codeword, computed in ``dtype`` (float32; the
    control's bfloat16) and returned in float32."""
    m, ksub, dsub = codebooks.shape
    sub = q.to(dtype).view(q.shape[0], m, 1, dsub)
    return ((sub - codebooks.to(dtype)[None]) ** 2).sum(-1).float()


def adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut [Q, m, ksub], codes [Q, n, m] uint8 -> distances [Q, n]: the m
    entries summed in sub-space order."""
    d = None
    for j in range(codes.shape[-1]):
        t = torch.gather(lut[:, j], 1, codes[..., j].long())
        d = t if d is None else d + t
    return d


def search(index, q: torch.Tensor, nprobe: int, K: int, eps: float,
           lut_dtype: torch.dtype = torch.float32, block: int = 8
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Q, d] float32 queries -> (distances [Q, K], global ids [Q, K])."""
    S = index.codes.shape[0]
    kk = k_prime(K, S, eps)
    lists = probe(index.centroids, q, nprobe)
    cap = index.codes.shape[2]
    rows = torch.arange(cap, device=q.device)
    out_d, out_i = [], []
    for s in range(0, q.shape[0], block):
        lb = lists[s:s + block].long()                     # [b, nprobe]
        b = lb.shape[0]
        if index.residual:
            res = q[s:s + block, None, :] - index.centroids[lb]
            lut = luts(index.codebooks, res.flatten(0, 1), lut_dtype)
        else:
            lut = luts(index.codebooks, q[s:s + block], lut_dtype)
        shard_d, shard_i = [], []
        for sh in range(S):
            codes = index.codes[sh][lb]                    # [b, np, cap, m]
            if index.residual:
                d = adc(lut, codes.flatten(0, 1)).view(b, -1)
            else:
                d = adc(lut, codes.flatten(1, 2))
            valid = rows[None, None] < index.lens[sh][lb][..., None]
            d = torch.where(valid.flatten(1), d, float("inf"))
            ids = index.ids[sh][lb].flatten(1)
            kd, ki = _first_k(d, ids, kk)
            shard_d.append(kd)
            shard_i.append(ki)
        d, i = _first_k(torch.cat(shard_d, 1), torch.cat(shard_i, 1), K)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def distances_of(index, q: torch.Tensor, ids: torch.Tensor,
                 lut_dtype: torch.dtype = torch.float32, block: int = 16
                 ) -> torch.Tensor:
    """The ADC distance of [Q] queries to their ids [Q, K] (+inf at -1)."""
    valid = ids.clamp(min=0)
    codes = index.codes_of(valid)                          # [Q, K, m]
    if not index.residual:
        d = adc(luts(index.codebooks, q, lut_dtype), codes)
    else:
        parts = []
        for s in range(0, q.shape[0], block):
            z = slice(s, s + block)
            res = q[z, None, :] - index.centroids[index.lists_of(valid[z])]
            lut = luts(index.codebooks, res.flatten(0, 1), lut_dtype)
            parts.append(adc(lut, codes[z].flatten(0, 1)[:, None])
                         .view(res.shape[:2]))
        d = torch.cat(parts)
    return torch.where(ids >= 0, d, float("inf"))


def knn_mix(lm_logits: torch.Tensor, dists: torch.Tensor,
            tokens: torch.Tensor, lam: float, temperature: float
            ) -> torch.Tensor:
    """[Q, V] logits, [Q, K] distances and payload tokens (-1 absent) ->
    the mixed log-probabilities [Q, V] float32."""
    valid = (tokens >= 0) & torch.isfinite(dists)
    logw = torch.where(valid, -dists / temperature, float("-inf"))
    top = logw.amax(-1, keepdim=True)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.where(valid, torch.exp(logw - top), 0.0)
    total = w.sum(-1, keepdim=True)
    p_knn = torch.zeros_like(lm_logits, dtype=torch.float32)
    p_knn.scatter_add_(1, tokens.clamp(min=0).long(),
                       w / total.clamp(min=1e-30))
    lam_row = torch.where(total > 0, lam, 0.0)
    p = (1 - lam_row) * torch.softmax(lm_logits.float(), -1) + \
        lam_row * p_knn
    return torch.log(p.clamp(min=1e-30))


def payload(index, ids: torch.Tensor) -> torch.Tensor:
    """Next-token payload of ids [..] (-1 where the id is -1)."""
    t = index.payload[ids.clamp(min=0).long()]
    return torch.where(ids >= 0, t, torch.full_like(t, -1))


def gap(mixed: torch.Tensor, token: torch.Tensor,
        best: Optional[torch.Tensor] = None) -> torch.Tensor:
    """How far each row's ``token`` lies below the row's best entry."""
    best = mixed.amax(-1) if best is None else best
    return best - mixed.gather(1, token.long()[:, None])[:, 0]
