"""ChamVS search configuration and the per-shard scan (twin of
``repro.core.chamvs``).

The serving default is the fused scan (``kernels/chamvs_scan``): one
launch covers ADC + top-k' for every shard of a retrieval wave.
``shard_search`` is the reference's *staged* per-shard pipeline
(``ChamVSConfig.fused=False``): each memory node scans its probed lists
with ``kernels/pq_adc`` — the kernel on the card, which reads the lists
in place, the plain version on the CPU. Both give the fused scan's ids
and distances.

``search_single`` is the reference's one-shot search over a list of
shards: a ``RetrievalService`` memoised per (index, config).

``make_distributed_search`` / ``make_distributed_gather`` are the
reference's deprecated wrappers: they warn and delegate to
``repro_torch.retrieval.router``.
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import List, Optional, Tuple

import torch

from repro_torch.core import ivfpq
from repro_torch.core.approx_topk_math import truncated_queue_len
from repro_torch.core.ivfpq import IVFPQConfig, IVFPQParams, IVFPQShard
from repro_torch.kernels.common import topk_smallest
from repro_torch.kernels.pq_adc.ops import probed_adc_topk


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
    """One memory node's work, staged: LUTs -> ADC + local top-k per
    (query, probe) over the probed lists -> global ids -> top-kk.
    Returns (dists [nq, kk], global ids [nq, kk]).

    The reference gathers the probed lists' codes and ids and reshapes
    the LUTs per entry (``repro/core/chamvs.py``); here the scan reads
    the lists and the LUTs where they lie, and only the B x k winning
    rows' ids are gathered."""
    icfg = cfg.ivfpq
    nq = probe_ids.shape[0]
    luts = ivfpq.compute_luts(params, queries, probe_ids, icfg)
    d_l, i_l = probed_adc_topk(luts, shard.codes, shard.list_len, probe_ids,
                               k=min(kk, icfg.list_cap))
    # local row -> global id: entry (q, p)'s row r is id slot
    # probe_ids[q, p] * cap + r of the shard's flat id table
    flat = probe_ids.long()[..., None] * icfg.list_cap + \
        i_l.clamp(min=0).long()
    gid = torch.where(i_l < 0, torch.full_like(i_l, -1),
                      shard.ids.reshape(-1)[flat])
    return topk_smallest(d_l.reshape(nq, -1), gid.reshape(nq, -1), kk)


def stack_shards(shards: List[IVFPQShard]) -> IVFPQShard:
    """[S] shards -> one IVFPQShard with a leading shard axis (the fused
    scan's physical layout)."""
    return IVFPQShard(
        codes=torch.stack([s.codes for s in shards]),
        ids=torch.stack([s.ids for s in shards]),
        list_len=torch.stack([s.list_len for s in shards]),
    )


# LRU memo of the last few (params, shards, cfg) -> RetrievalService, so
# that repeated one-shot searches neither re-stack the shards (the fused
# scan's layout) nor rebuild the service. Keyed, as the reference keys
# it, on the identities of the index's tensors and on the config: the
# service holds those tensors, so a live key cannot alias another index.
# Up to ``_SERVICE_MEMO_CAP`` indexes (and their stacks) stay pinned;
# ``_SERVICE_MEMO.clear()`` releases them.
_SERVICE_MEMO: "collections.OrderedDict" = collections.OrderedDict()
_SERVICE_MEMO_CAP = 4


def search_single(params: IVFPQParams, shards: List[IVFPQShard],
                  queries: torch.Tensor, cfg: ChamVSConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-process search over a list of shards: (dists [nq, k], ids
    [nq, k]). A one-shot ``RetrievalService`` call with
    ``ServiceConfig(measure=False, bucket_pow2=False)``: no stage
    timings, no padding of the batch. On CUDA tensors it launches the
    IVF probe and the fused scan (``cfg.fused``) or one ``adc_scan`` per
    shard; on the CPU it runs their plain versions."""
    from repro_torch.retrieval.service import RetrievalService, ServiceConfig
    key = (tuple(id(leaf) for s in shards for leaf in s),
           id(params.coarse_centroids), id(params.codebooks), cfg)
    svc = _SERVICE_MEMO.get(key)
    if svc is None:
        svc = RetrievalService.local(params, shards, cfg,
                                     ServiceConfig(measure=False,
                                                   bucket_pow2=False))
        while len(_SERVICE_MEMO) >= _SERVICE_MEMO_CAP:
            _SERVICE_MEMO.popitem(last=False)    # the least recent
        _SERVICE_MEMO[key] = svc
    else:
        _SERVICE_MEMO.move_to_end(key)
    return svc.search(queries)


# ---------------------------------------------------------------------------
# deprecated wrappers (moved to repro_torch.retrieval.router)
# ---------------------------------------------------------------------------

def make_distributed_search(mesh, cfg: ChamVSConfig,
                            db_axes: Tuple[str, ...] = ("data",),
                            query_axis: Optional[str] = "model",
                            nq: Optional[int] = None):
    """Deprecated: use ``repro_torch.retrieval.router.build_search`` (or a
    ``ShardRouter``, which also owns placement)."""
    warnings.warn(
        "chamvs.make_distributed_search moved to "
        "repro.retrieval.router.build_search", DeprecationWarning,
        stacklevel=2)
    from repro_torch.retrieval.router import build_search
    return build_search(mesh, cfg, db_axes=db_axes, query_axis=query_axis,
                        nq=nq)


def make_distributed_gather(mesh, table_axes: Tuple[str, ...]):
    """Deprecated: use ``repro_torch.retrieval.router.build_gather`` (or a
    ``ShardRouter``)."""
    warnings.warn(
        "chamvs.make_distributed_gather moved to "
        "repro.retrieval.router.build_gather", DeprecationWarning,
        stacklevel=2)
    from repro_torch.retrieval.router import build_gather
    return build_gather(mesh, table_axes)
