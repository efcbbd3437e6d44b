"""ChamVS search configuration and the per-shard scan (twin of
``repro.core.chamvs``).

The serving default is the fused scan (``kernels/chamvs_scan``): one
launch covers ADC + top-k' for every shard of a retrieval wave.
``shard_search`` is the reference's *staged* per-shard pipeline
(``ChamVSConfig.fused=False``): each memory node gathers its probed
lists and scans them with ``kernels/pq_adc`` — the kernel on the card,
the plain version on the CPU. Both give the fused scan's ids and
distances.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.core import ivfpq
from repro_torch.core.approx_topk_math import truncated_queue_len
from repro_torch.core.ivfpq import IVFPQConfig, IVFPQParams, IVFPQShard
from repro_torch.kernels.common import topk_smallest
from repro_torch.kernels.pq_adc.ops import pq_adc_topk


@dataclasses.dataclass(frozen=True)
class ChamVSConfig:
    """Serve-time configuration of the search engine."""

    ivfpq: IVFPQConfig
    nprobe: int = 32
    k: int = 100
    eps: float = 0.01             # approx-queue failure budget (paper: 1%)
    fused: bool = True            # one fused scan over all shards per wave;
    #                               False = one staged scan per shard

    def k_prime(self, num_shards: int) -> int:
        """Truncated per-shard queue length (paper §4.2.2): each shard
        ships k' << K candidates; k' > K/num_shards always holds, so the
        merge can always fill K slots."""
        return min(self.k, truncated_queue_len(self.k, max(1, num_shards),
                                               self.eps))


def shard_search(params: IVFPQParams, shard: IVFPQShard,
                 queries: torch.Tensor, probe_ids: torch.Tensor,
                 cfg: ChamVSConfig, kk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One memory node's work, staged: LUTs -> gather the probed lists ->
    ADC + local top-k per (query, probe) -> global ids -> top-kk.
    Returns (dists [nq, kk], global ids [nq, kk])."""
    icfg = cfg.ivfpq
    nq, nprobe = probe_ids.shape
    B, cap = nq * nprobe, icfg.list_cap
    p = probe_ids.long()
    luts = ivfpq.compute_luts(params, queries, probe_ids, icfg)
    d_l, i_l = pq_adc_topk(luts.reshape(B, icfg.m, icfg.ksub),
                           shard.codes[p].reshape(B, cap, icfg.m),
                           shard.list_len[p].reshape(B), k=min(kk, cap))
    # local row -> global id through the probed lists' id tables
    gid = torch.gather(shard.ids[p].reshape(B, cap), 1,
                       i_l.clamp(min=0).long())
    gid = torch.where(i_l < 0, torch.full_like(gid, -1), gid)
    return topk_smallest(d_l.reshape(nq, -1), gid.reshape(nq, -1), kk)


def stack_shards(shards: List[IVFPQShard]) -> IVFPQShard:
    """[S] shards -> one IVFPQShard with a leading shard axis (the fused
    scan's physical layout)."""
    return IVFPQShard(
        codes=torch.stack([s.codes for s in shards]),
        ids=torch.stack([s.ids for s in shards]),
        list_len=torch.stack([s.list_len for s in shards]),
    )
