"""ChamVS search configuration and the per-shard scan (twin of
``repro.core.chamvs``).

The serving path is the fused scan (``kernels/chamvs_scan``): one launch
covers ADC + top-k' for every shard of a retrieval wave.
``shard_search`` is the reference's *staged* per-shard pipeline in its
plain form, kept as the CPU oracle of the fused path; its kernel leg
needs the ``adc_scan`` kernel, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.core import ivfpq
from repro_torch.core.approx_topk_math import truncated_queue_len
from repro_torch.core.ivfpq import IVFPQConfig, IVFPQParams, IVFPQShard
from repro_torch.kernels.common import topk_smallest


@dataclasses.dataclass(frozen=True)
class ChamVSConfig:
    """Serve-time configuration of the search engine."""

    ivfpq: IVFPQConfig
    nprobe: int = 32
    k: int = 100
    eps: float = 0.01             # approx-queue failure budget (paper: 1%)
    fused: bool = True            # one fused scan over all shards per wave;
    #                               False = the staged per-shard oracle

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
    """One memory node's work, staged: LUTs -> gather probed lists -> ADC
    -> mask -> top-kk. Returns (dists [nq, kk], global ids [nq, kk])."""
    icfg = cfg.ivfpq
    nq, nprobe = probe_ids.shape
    p = probe_ids.long()
    luts = ivfpq.compute_luts(params, queries, probe_ids, icfg)
    codes, ids, lens = shard.codes[p], shard.ids[p], shard.list_len[p]
    valid = (torch.arange(icfg.list_cap, device=lens.device)[None, None, :]
             < lens[..., None])
    d = ivfpq.adc_scan_ref(luts, codes)
    d = torch.where(valid, d, torch.full_like(d, float("inf")))
    return topk_smallest(d.reshape(nq, -1), ids.reshape(nq, -1), kk)


def stack_shards(shards: List[IVFPQShard]) -> IVFPQShard:
    """[S] shards -> one IVFPQShard with a leading shard axis (the fused
    scan's physical layout)."""
    return IVFPQShard(
        codes=torch.stack([s.codes for s in shards]),
        ids=torch.stack([s.ids for s in shards]),
        list_len=torch.stack([s.list_len for s in shards]),
    )
