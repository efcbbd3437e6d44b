"""``RetrievalService`` — ChamVS as a vector-search service (twin of
``repro.retrieval.service``, local pipeline only).

Queries from many sequences are submitted as they arise; each
``submit`` returns a ``SearchHandle`` future, and pending rows coalesce
into one batched probe + scan + merge per flush (``max_batch`` rows or
an explicit ``flush()`` at the end of a scheduler wave). Batches are padded to powers of two, as in the
reference, so the kernels see O(log max_batch) shapes.

Everything runs synchronously on the caller's CUDA stream (or the CPU);
the result cache, replica failover, chaos injection and the mesh
``RouterPipeline`` are later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.chamvs import ChamVSConfig, shard_search, stack_shards
from repro_torch.core.ivfpq import IVFPQParams, IVFPQShard
from repro_torch.kernels.chamvs_scan.ops import fused_shard_scan
from repro_torch.kernels.ivf_scan.ops import ivf_index_scan
from repro_torch.retrieval import merge as merge_lib
from repro_torch.retrieval.stats import RetrievalStats


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Batching knobs of one service instance."""
    max_batch: int = 64           # flush when this many rows are pending
    bucket_pow2: bool = True      # pad batches to powers of two
    measure: bool = True          # synchronize per stage to time it


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (the service's and the KV pool's
    shape bucket)."""
    b = 1
    while b < n:
        b *= 2
    return b


def sync(t: torch.Tensor) -> None:
    """Wait for the device work producing ``t`` (no-op on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


# ---------------------------------------------------------------------------
# the pipeline stages
# ---------------------------------------------------------------------------

def _probe_stage(params: IVFPQParams, queries: torch.Tensor,
                 cfg: ChamVSConfig) -> torch.Tensor:
    """ChamVS.idx: the nprobe closest IVF lists per query, through the
    IVF probe kernel's wrapper (shared by the fused and staged scans)."""
    _, probe_ids = ivf_index_scan(queries, params.coarse_centroids,
                                  cfg.nprobe)
    return probe_ids


def _scan_stage(params: IVFPQParams, shards: Tuple[IVFPQShard, ...],
                queries: torch.Tensor, *, cfg: ChamVSConfig, kk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """STAGED scan, the paper's layout: the IVF probe, then one
    ``shard_search`` (gather + ADC/top-k launch) per shard.
    Returns stacked candidates (dists [S, nq, kk], ids [S, nq, kk])."""
    probe_ids = _probe_stage(params, queries, cfg)
    per = [shard_search(params, s, queries, probe_ids, cfg, kk)
           for s in shards]
    return (torch.stack([p[0] for p in per]),
            torch.stack([p[1] for p in per]))


def _scan_stage_fused(params: IVFPQParams, stacked: IVFPQShard,
                      queries: torch.Tensor, *, cfg: ChamVSConfig, kk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FUSED scan (the serving default): the IVF probe + one fused scan
    over every shard of the stack. Same return contract as
    ``_scan_stage``."""
    probe_ids = _probe_stage(params, queries, cfg)
    return fused_shard_scan(params, stacked, queries, probe_ids, cfg, kk)


def _merge_stage(dists: torch.Tensor, ids: torch.Tensor, *, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    return merge_lib.flat_merge(dists, ids, k)


class LocalPipeline:
    """Single-process scan/merge over a list of shards; ``cfg.fused``
    picks the fused scan over a ``stack_shards`` stack (default) or the
    staged per-shard scans (one launch per shard)."""

    def __init__(self, params: IVFPQParams, shards: List[IVFPQShard],
                 cfg: ChamVSConfig):
        self.params = params
        self.shards = tuple(shards)
        self.stacked = stack_shards(list(shards)) if cfg.fused else None
        self.cfg = cfg
        self.kk = cfg.k_prime(len(self.shards))

    @property
    def k(self) -> int:
        return self.cfg.k

    @property
    def scan_dispatches(self) -> int:
        """Scan launches per flush: one for the fused path whatever the
        shard count, one per shard when staged."""
        return 1 if self.cfg.fused else max(1, len(self.shards))

    def scan(self, queries: torch.Tensor):
        if self.cfg.fused:
            return _scan_stage_fused(self.params, self.stacked, queries,
                                     cfg=self.cfg, kk=self.kk)
        return _scan_stage(self.params, self.shards, queries,
                           cfg=self.cfg, kk=self.kk)

    def merge(self, candidates):
        d, i = candidates
        return _merge_stage(d, i, k=self.cfg.k)


# ---------------------------------------------------------------------------
# futures + the service
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _InFlight:
    """One row range of the in-flight request table."""
    ticket: int
    nrows: int
    submit_t: float
    result_d: Optional[torch.Tensor] = None   # [nrows, K] once complete
    result_i: Optional[torch.Tensor] = None


class SearchHandle:
    """Future for one submitted query batch; ``result()`` flushes if the
    batch is still queued."""

    def __init__(self, service: "RetrievalService", entry: _InFlight):
        self._service = service
        self._entry = entry

    def done(self) -> bool:
        return self._entry.result_d is not None

    def result(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.done():
            self._service.flush()
        self._service._retire(self._entry)
        return self._entry.result_d, self._entry.result_i


class RetrievalService:
    """Batched, instrumented front door to ChamVS."""

    def __init__(self, pipeline: LocalPipeline,
                 config: Optional[ServiceConfig] = None):
        self.pipeline = pipeline
        self.config = config or ServiceConfig()
        self.stats = RetrievalStats()
        self._inflight: Dict[int, _InFlight] = {}
        self._pending: List[Tuple[_InFlight, torch.Tensor]] = []
        self._pending_rows = 0
        self._next_ticket = 0

    @classmethod
    def local(cls, params: IVFPQParams, shards: List[IVFPQShard],
              cfg: ChamVSConfig, config: Optional[ServiceConfig] = None
              ) -> "RetrievalService":
        return cls(LocalPipeline(params, shards, cfg), config=config)

    @property
    def num_inflight(self) -> int:
        return len(self._inflight)

    def _retire(self, entry: _InFlight) -> None:
        self._inflight.pop(entry.ticket, None)

    def submit(self, queries: torch.Tensor) -> SearchHandle:
        """Enqueue a [B, d] query batch; returns a future."""
        q = queries.float()
        if q.ndim != 2:
            raise ValueError(f"queries must be [B, d], got {tuple(q.shape)}")
        entry = _InFlight(ticket=self._next_ticket, nrows=q.shape[0],
                          submit_t=time.perf_counter())
        self._next_ticket += 1
        self._inflight[entry.ticket] = entry
        self.stats.record_submit(entry.nrows)
        self._pending.append((entry, q))
        self._pending_rows += entry.nrows
        if self._pending_rows >= self.config.max_batch:
            self.flush()
        return SearchHandle(self, entry)

    def _bucket(self, n: int) -> int:
        return next_pow2(n) if self.config.bucket_pow2 else n

    def flush(self) -> None:
        """Coalesce every pending row into one scan + merge and complete
        the corresponding in-flight entries."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        nrows, self._pending_rows = self._pending_rows, 0
        batch = (pending[0][1] if len(pending) == 1
                 else torch.cat([q for _, q in pending], dim=0))
        pad = self._bucket(nrows) - nrows
        if pad:
            batch = torch.cat([batch, batch.new_zeros((pad, batch.shape[1]))])
        batch = batch.contiguous()
        measure = self.config.measure
        t0 = time.perf_counter()
        for entry, _ in pending:
            self.stats.queue_wait.add(t0 - entry.submit_t)
        candidates = self.pipeline.scan(batch)
        if measure:
            sync(candidates[0])
        t1 = time.perf_counter()
        dists, ids = self.pipeline.merge(candidates)
        if measure:
            sync(dists)
            self.stats.scan.add(t1 - t0)
            self.stats.merge.add(time.perf_counter() - t1)
        self.stats.record_batch(nrows,
                                dispatches=self.pipeline.scan_dispatches)
        offset = 0
        for entry, _ in pending:
            entry.result_d = dists[offset:offset + entry.nrows]
            entry.result_i = ids[offset:offset + entry.nrows]
            offset += entry.nrows

    def search(self, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Blocking search: submit + flush + result."""
        return self.submit(queries).result()
