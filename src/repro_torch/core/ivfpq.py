"""IVF-PQ (twin of ``repro.core.ivfpq``): training, encoding, the
padded-list layout the scan reads, the search-time LUT/ADC pieces, and
the search tools: the per-shard oracle (``search_shard_ref``), the
shards' merge, exact brute-force search and recall@K.

Index construction is host-driven like the reference's (the bucketing
into per-shard list slices is numpy); the heavy arithmetic (k-means,
assignment, encoding) runs on whatever device the vectors live on.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.kmeans import _pairwise_sq_l2, assign_nearest, kmeans
from repro_torch.kernels.common import topk_smallest
from repro_torch.kernels.ivf_scan.ref import ref_ivf_scan


@dataclasses.dataclass(frozen=True)
class IVFPQConfig:
    """Static description of an IVF-PQ index (paper Table 1 symbols)."""

    dim: int
    nlist: int
    m: int
    nbits: int = 8
    residual: bool = True
    list_cap: int = 128

    @property
    def ksub(self) -> int:
        return 1 << self.nbits

    @property
    def dsub(self) -> int:
        if self.dim % self.m:
            raise ValueError(f"dim {self.dim} % m {self.m} != 0")
        return self.dim // self.m

    def db_bytes_per_vector(self) -> float:
        """PQ code + vector-ID footprint (paper Table 3 'PQ and vec ID')."""
        return self.m * self.nbits / 8 + 4


class IVFPQParams(NamedTuple):
    coarse_centroids: torch.Tensor   # [nlist, D] f32
    codebooks: torch.Tensor          # [m, ksub, dsub] f32


class IVFPQShard(NamedTuple):
    """One memory node's slice of the database, every list padded to
    ``list_cap`` rows (``list_len`` holds the valid prefix)."""

    codes: torch.Tensor      # [nlist, cap, m] uint8
    ids: torch.Tensor        # [nlist, cap] int32 (global ids, -1 = pad)
    list_len: torch.Tensor   # [nlist] int32


def train_ivfpq(generator: torch.Generator, train_vecs: torch.Tensor,
                cfg: IVFPQConfig, kmeans_iters: int = 15) -> IVFPQParams:
    """Coarse quantizer + one k-means per PQ sub-space."""
    x = train_vecs.float()
    coarse, assign = kmeans(x, cfg.nlist, iters=kmeans_iters,
                            generator=generator)
    target = x - coarse[assign] if cfg.residual else x
    sub = target.reshape(-1, cfg.m, cfg.dsub)
    cbs = [kmeans(sub[:, j].contiguous(), cfg.ksub, iters=kmeans_iters,
                  generator=generator)[0] for j in range(cfg.m)]
    return IVFPQParams(coarse_centroids=coarse, codebooks=torch.stack(cbs))


def assign_coarse(params: IVFPQParams, vecs: torch.Tensor) -> torch.Tensor:
    """Nearest coarse centroid of every vector, [n] int64."""
    return assign_nearest(vecs.float(), params.coarse_centroids)[0]


def encode(params: IVFPQParams, vecs: torch.Tensor, cfg: IVFPQConfig,
           assign: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PQ-encode vectors -> (codes [n, m] uint8, coarse assignment [n])."""
    vecs = vecs.float()
    if assign is None:
        assign = assign_coarse(params, vecs)
    target = vecs - params.coarse_centroids[assign] if cfg.residual else vecs
    sub = target.reshape(-1, cfg.m, cfg.dsub)
    codes = torch.stack(
        [_pairwise_sq_l2(sub[:, j], params.codebooks[j]).argmin(dim=-1)
         for j in range(cfg.m)], dim=1)
    return codes.to(torch.uint8), assign


def build_shards(params: IVFPQParams, vecs: torch.Tensor, cfg: IVFPQConfig,
                 num_shards: int, start_id: int = 0,
                 encode_batch: int = 65536) -> List[IVFPQShard]:
    """Encode, bucket by list, stripe each list evenly across shards
    (shard ``sh`` takes a list's elements sh, sh + num_shards, ...), pad
    to ``cfg.list_cap``. Raises if a per-shard slice exceeds the cap."""
    n = vecs.shape[0]
    device = vecs.device
    all_codes = np.empty((n, cfg.m), np.uint8)
    all_assign = np.empty((n,), np.int64)
    for s in range(0, n, encode_batch):
        c, a = encode(params, vecs[s:s + encode_batch], cfg)
        all_codes[s:s + encode_batch] = c.cpu().numpy()
        all_assign[s:s + encode_batch] = a.cpu().numpy()
    ids = np.arange(start_id, start_id + n, dtype=np.int32)

    order = np.argsort(all_assign, kind="stable")
    sorted_codes, sorted_ids = all_codes[order], ids[order]
    sorted_assign = all_assign[order]
    list_starts = np.searchsorted(sorted_assign, np.arange(cfg.nlist))
    list_ends = np.searchsorted(sorted_assign, np.arange(cfg.nlist) + 1)

    shards = []
    for sh in range(num_shards):
        codes = np.zeros((cfg.nlist, cfg.list_cap, cfg.m), np.uint8)
        sids = np.full((cfg.nlist, cfg.list_cap), -1, np.int32)
        lens = np.zeros((cfg.nlist,), np.int32)
        for li in range(cfg.nlist):
            sl = slice(list_starts[li] + sh, list_ends[li], num_shards)
            chunk_ids = sorted_ids[sl]
            ln = len(chunk_ids)
            if ln > cfg.list_cap:
                raise ValueError(
                    f"list {li} shard {sh}: {ln} codes > cap {cfg.list_cap}; "
                    f"raise IVFPQConfig.list_cap")
            codes[li, :ln] = sorted_codes[sl]
            sids[li, :ln] = chunk_ids
            lens[li] = ln
        shards.append(IVFPQShard(torch.from_numpy(codes).to(device),
                                 torch.from_numpy(sids).to(device),
                                 torch.from_numpy(lens).to(device)))
    return shards


def scan_ivf_index(params: IVFPQParams, queries: torch.Tensor, nprobe: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ChamVS.idx — brute-force centroid scan + top-nprobe:
    (probe dists [nq, nprobe], probe ids [nq, nprobe] int32)."""
    return ref_ivf_scan(queries, params.coarse_centroids, nprobe)


def compute_luts(params: IVFPQParams, queries: torch.Tensor,
                 probe_ids: torch.Tensor, cfg: IVFPQConfig) -> torch.Tensor:
    """Distance lookup tables [nq, nprobe, m, ksub] f32.

    Residual PQ: one LUT per (query, probed list). Non-residual: one LUT
    per query, *expanded* (a stride-0 view) over the probe axis."""
    nq, nprobe = probe_ids.shape
    cb = params.codebooks                                     # [m, ksub, dsub]
    cb2 = (cb * cb).sum(-1)                                   # [m, ksub]
    if cfg.residual:
        res = queries[:, None, :] - params.coarse_centroids[probe_ids.long()]
        sub = res.reshape(nq, nprobe, cfg.m, cfg.dsub)
        x2 = (sub * sub).sum(-1)                              # [nq, np, m]
        xc = torch.einsum("qpmd,mkd->qpmk", sub, cb)
        return x2[..., None] - 2.0 * xc + cb2[None, None]
    sub = queries.reshape(nq, cfg.m, cfg.dsub)
    x2 = (sub * sub).sum(-1)                                  # [nq, m]
    xc = torch.einsum("qmd,mkd->qmk", sub, cb)
    lut = x2[..., None] - 2.0 * xc + cb2[None]                # [nq, m, ksub]
    return lut[:, None].expand(nq, nprobe, cfg.m, cfg.ksub)


def adc_scan_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Asymmetric distance computation, gather formulation.

    lut [..., m, ksub] f32, codes [..., n, m] uint8 -> [..., n] f32: per
    byte, the code addresses its sub-space's LUT row; the m terms are
    summed in index order 0..m-1 in float32 (the CUDA scan's order)."""
    m = codes.shape[-1]
    d = None
    for j in range(m):
        term = torch.gather(lut[..., j, :], -1, codes[..., j].long())
        d = term if d is None else d + term
    return d


def search_shard_ref(params: IVFPQParams, shard: IVFPQShard,
                     queries: torch.Tensor, probe_ids: torch.Tensor,
                     cfg: IVFPQConfig, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-shard oracle: LUTs -> gather the probed lists -> ADC ->
    top-k over the concatenated lists (probe by probe, row by row; ties
    to the earlier candidate). Returns this shard's (dists [nq, k], ids
    [nq, k]), (+inf, -1) past the valid rows."""
    nq = probe_ids.shape[0]
    p = probe_ids.long()
    lut = compute_luts(params, queries, probe_ids, cfg)      # [nq,np,m,ksub]
    d = adc_scan_ref(lut, shard.codes[p])                     # [nq,np,cap]
    valid = (torch.arange(cfg.list_cap, device=d.device)[None, None, :]
             < shard.list_len[p][..., None])
    d = torch.where(valid, d, torch.full_like(d, float("inf")))
    return topk_smallest(d.reshape(nq, -1), shard.ids[p].reshape(nq, -1), k)


def merge_topk(dists: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K-way merge of per-shard candidates (paper step 8): [S, nq, kk]
    -> ([nq, k], [nq, k]); delegates to ``retrieval.merge.flat_merge``."""
    from repro_torch.retrieval.merge import flat_merge
    return flat_merge(dists, ids, k)


def exact_search(vecs: torch.Tensor, queries: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact brute-force nearest neighbours, the ground truth for
    recall@K: (dists [nq, k] f32, ids [nq, k] int32) ascending. Equal
    distances take the lower index first, as the reference's
    ``lax.top_k`` on ``-d`` does: the first k of a stable ascending
    sort (``first_k_stable``)."""
    d = _pairwise_sq_l2(queries.float(), vecs.float())
    return first_k_stable(d, k)


def first_k_stable(d: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_smallest`` of each row of ``d`` [nq, n] against its column
    ids, without sorting the whole row: every column below the row's
    k-th smallest value (``kthvalue``, which is one value whatever the
    order of equal ones), then the lowest-indexed columns equal to it,
    and a stable sort of those k in column order."""
    nq, n = d.shape
    cols = torch.arange(n, device=d.device, dtype=torch.int32)
    if k >= n:
        return topk_smallest(d, cols.expand_as(d), k)
    thr = torch.kthvalue(d, k, dim=-1, keepdim=True).values
    below, tie = d < thr, d == thr
    need = k - below.sum(-1, keepdim=True)
    keep = below | (tie & (torch.cumsum(tie, -1) <= need))
    picked = keep.nonzero()[:, 1].reshape(nq, k)     # ascending per row
    return topk_smallest(torch.gather(d, -1, picked), picked.int(), k)


def recall_at_k(found_ids: torch.Tensor, true_ids: torch.Tensor) -> float:
    """R@K: the share of the exact top-K that the search returned,
    averaged over the queries (paper §2.2), as a Python float (averaged
    in float64; the reference averages in float32)."""
    hits = (found_ids[:, :, None] == true_ids[:, None, :]).any(-1).sum(-1)
    return float((hits.double() / true_ids.shape[-1]).mean())


#: relative distance gap within which two devices' searches may swap ids
NEAR_TIE_REL = 1e-5


def id_swaps(d_a: torch.Tensor, i_a: torch.Tensor, d_b: torch.Tensor,
             i_b: torch.Tensor,
             terms: Optional[torch.Tensor] = None) -> int:
    """Two searches of the same queries (say the card's kernels and the
    plain versions on the CPU, whose LUT and distance GEMMs round
    differently): the slots whose ids differ, all of them near ties.
    Raises ``ValueError`` where the distances differ by more than
    ``NEAR_TIE_REL`` of their magnitude, or where an id differs outside
    a near tie: a differing id must sit in the other list at a distance within
    that of its own, or fall at the k-th boundary. ``terms`` [nq] is the
    magnitude a row's distances are computed from (exact search's
    |q|^2 + |k|^2, which cancel down to a small distance); by default
    the distances' own."""
    d_a, d_b = d_a.float().cpu(), d_b.float().cpu()
    i_a, i_b = i_a.cpu().long(), i_b.cpu().long()
    mag = d_b.abs() if terms is None else \
        terms.float().cpu()[:, None].expand_as(d_b)
    tol = NEAR_TIE_REL * mag + 1e-6
    finite = torch.isfinite(d_b)
    if not torch.equal(finite, torch.isfinite(d_a)) or \
            bool(((d_a - d_b).abs() > tol)[finite].any()):
        raise ValueError(f"distances differ beyond {NEAR_TIE_REL} of "
                         "their magnitude")
    diff = (i_a != i_b).nonzero().tolist()
    for r, c in diff:
        at = (i_b[r] == i_a[r, c]).nonzero()
        other = d_b[r, at[0, 0]] if len(at) else d_b[r, -1]
        own = d_b[r, c] if len(at) else d_a[r, c]
        if abs(float(other) - float(own)) > float(tol[r, c]):
            raise ValueError(f"row {r} slot {c}: ids {int(i_a[r, c])} / "
                             f"{int(i_b[r, c])} differ outside a near tie")
    return len(diff)
