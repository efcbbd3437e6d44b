"""``RetrievalService`` — ChamVS as a vector-search service (twin of
``repro.retrieval.service``, local pipeline only).

Queries from many sequences are submitted as they arise; each
``submit`` returns a ``SearchHandle`` future, and pending rows coalesce
into one batched probe + scan + merge per flush (``max_batch`` rows or
an explicit ``flush()`` at the end of a scheduler wave). Batches are
padded to powers of two, as in the reference, so the kernels see
O(log max_batch) shapes.

An LRU result cache on quantized query rows (``cache_entries``) answers
a repeated query without the kernel: a full hit completes at submit, a
partial hit sends only the missed rows to the scan and the flush
stitches the batch back in submit order. Its generations keep stale
entries as speculation seeds (``stale_lookup``). A flush that raises
completes its entries with the missing-neighbour sentinel, flagged
partial, and re-raises.

Everything runs on the caller's CUDA stream (or the CPU); each flushed
entry carries an event recorded after its results were enqueued, so the
engine can tell whether a search has landed without waiting for later
work. Replica failover, deadlines, chaos injection and the mesh
``RouterPipeline`` are later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chamvs import ChamVSConfig, shard_search, stack_shards
from repro_torch.core.ivfpq import IVFPQParams, IVFPQShard
from repro_torch.kernels.chamvs_scan.ops import fused_shard_scan
from repro_torch.kernels.ivf_scan.ops import ivf_index_scan
from repro_torch.retrieval import merge as merge_lib
from repro_torch.retrieval.cache import QueryCache
from repro_torch.retrieval.stats import RetrievalStats


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Batching and caching knobs of one service instance."""
    max_batch: int = 64           # flush when this many rows are pending
    bucket_pow2: bool = True      # pad batches to powers of two
    cache_entries: int = 0        # LRU result-cache entries (0 = off).
    #                               NOTE: the cache keys on host-side
    #                               query values, so enabling it syncs
    #                               each submit (and each flush, for the
    #                               insert): it trades async overlap for
    #                               skipping whole kernel dispatches
    cache_quant: float = 1e-3     # query quantization step for cache keys
    cache_partial: bool = True    # per-row cache hits: cached rows are
    #                               served at once and ONLY the missed
    #                               rows go to the kernel (the flush
    #                               stitches the batch back together).
    #                               False: all-or-nothing batch lookup
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
    kernel_rows: int = -1                     # rows the kernel must serve
    #                                           (< nrows on a partial cache
    #                                           hit); -1 = nrows
    stitch: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    #                                           (dists, ids, hit mask) of
    #                                           the cached rows to merge
    #                                           with the kernel rows
    partial: bool = False                     # served from a live subset
    #                                           of the fault domains (only
    #                                           a failed flush sets it:
    #                                           no domain contributed)
    live_frac: float = 1.0                    # share of fault domains
    #                                           that contributed
    landed: Optional[torch.cuda.Event] = None  # recorded on the stream
    #                                           after the flush enqueued
    #                                           this entry's results (CUDA
    #                                           only: CPU results are
    #                                           there when assigned)


class SearchHandle:
    """Future for one submitted query batch; ``result()`` flushes if the
    batch is still queued, so a handle can always be resolved."""

    def __init__(self, service: "RetrievalService", entry: _InFlight):
        self._service = service
        self._entry = entry

    @property
    def ticket(self) -> int:
        return self._entry.ticket

    @property
    def partial(self) -> bool:
        """True when the result does not cover every fault domain (a
        failed flush fills the missing-neighbour sentinel). Meaningful
        once ``done()``; the engine counts it and never seeds
        speculation with such a result."""
        return self._entry.partial

    @property
    def live_fraction(self) -> float:
        return self._entry.live_frac

    def done(self) -> bool:
        return self._entry.result_d is not None

    def is_ready(self) -> bool:
        """Whether the flushed result has landed on the device, without
        waiting (True on the CPU and for cache hits)."""
        ev = self._entry.landed
        return ev is None or ev.query()

    def wait(self) -> None:
        """Block the host until the result has landed, and no longer:
        work enqueued after the flush on the same stream is not waited
        for."""
        if self._entry.landed is not None:
            self._entry.landed.synchronize()

    def result(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.done():
            self._service.flush()
        assert self._entry.result_d is not None
        self._service._retire(self._entry)
        return self._entry.result_d, self._entry.result_i

    def cancel(self) -> None:
        """Drop the handle without consuming its result (speculation
        points discarded by a rollback). A still-pending batch is
        computed and thrown away at the next flush: abandoned results
        must not wedge the in-flight table."""
        self._service._retire(self._entry)


class RetrievalService:
    """Batched, cached, instrumented front door to ChamVS."""

    def __init__(self, pipeline: LocalPipeline,
                 config: Optional[ServiceConfig] = None):
        self.pipeline = pipeline
        self.config = config or ServiceConfig()
        self.stats = RetrievalStats()
        self.cache: Optional[QueryCache] = (
            QueryCache(self.config.cache_entries,
                       quant=self.config.cache_quant,
                       partial=self.config.cache_partial)
            if self.config.cache_entries > 0 else None)
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

    @property
    def num_pending_rows(self) -> int:
        return self._pending_rows

    def _retire(self, entry: _InFlight) -> None:
        self._inflight.pop(entry.ticket, None)

    def submit(self, queries: torch.Tensor) -> SearchHandle:
        """Enqueue a [B, d] query batch; returns a future.

        A full cache hit completes the handle at once (no kernel); on a
        partial hit only the missed rows join the pending batch, and the
        flush stitches the cached rows back in."""
        q = queries.float()
        if q.ndim != 2:
            raise ValueError(f"queries must be [B, d], got {tuple(q.shape)}")
        entry = _InFlight(ticket=self._next_ticket, nrows=q.shape[0],
                          submit_t=time.perf_counter())
        self._next_ticket += 1
        self._inflight[entry.ticket] = entry
        self.stats.record_submit(entry.nrows)

        q_kernel = q
        if self.cache is not None:
            stale0 = self.cache.stale
            hit = self.cache.get_batch(q.cpu().numpy())
            self.stats.cache_stale += self.cache.stale - stale0
            if hit is not None and (len(hit) == 2 or hit[2].all()):
                # a full hit, in either cache mode
                entry.result_d = torch.from_numpy(hit[0]).to(q.device)
                entry.result_i = torch.from_numpy(hit[1]).to(q.device)
                self.stats.cache_hits += entry.nrows
                self.stats.queue_wait.add(0.0)
                return SearchHandle(self, entry)
            if hit is not None:
                # a partial hit: only the missed rows go to the kernel
                mask = hit[2]
                entry.stitch = hit
                entry.kernel_rows = entry.nrows - int(mask.sum())
                q_kernel = q[torch.from_numpy(np.flatnonzero(~mask)).to(
                    q.device)]
                self.stats.cache_hits += entry.nrows - entry.kernel_rows
                self.stats.cache_misses += entry.kernel_rows
            else:
                self.stats.cache_misses += entry.nrows
        if entry.kernel_rows < 0:
            entry.kernel_rows = entry.nrows

        self._pending.append((entry, q_kernel))
        self._pending_rows += entry.kernel_rows
        if self._pending_rows >= self.config.max_batch:
            self.flush()
        return SearchHandle(self, entry)

    def _bucket(self, n: int) -> int:
        return next_pow2(n) if self.config.bucket_pow2 else n

    def _fail_pending(self, pending: List[Tuple[_InFlight, torch.Tensor]]
                      ) -> None:
        """A flush that raises must still complete its entries: fill the
        missing-neighbour sentinel (``knnlm_interpolate`` falls back to
        the bare LM on it), in the kernels' dtypes on the queries'
        device, and flag them partial, so handles stay resolvable and
        the in-flight table cannot wedge."""
        k = self.pipeline.k
        for entry, q in pending:
            if entry.result_d is None:
                entry.result_d = torch.full((entry.nrows, k), float("inf"),
                                            dtype=torch.float32,
                                            device=q.device)
                entry.result_i = torch.full((entry.nrows, k), -1,
                                            dtype=torch.int32,
                                            device=q.device)
                entry.partial = True
                entry.live_frac = 0.0

    def flush(self) -> None:
        """Coalesce every pending row into one scan + merge and complete
        the corresponding in-flight entries. A failure completes them
        with the sentinel and re-raises."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        nrows, self._pending_rows = self._pending_rows, 0
        try:
            self._flush_batch(pending, nrows)
        except Exception:
            self._fail_pending(pending)
            raise

    def _flush_batch(self, pending: List[Tuple[_InFlight, torch.Tensor]],
                     nrows: int) -> None:
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
        for entry, q in pending:
            kd = dists[offset:offset + entry.kernel_rows]
            ki = ids[offset:offset + entry.kernel_rows]
            offset += entry.kernel_rows
            if self.cache is None:
                entry.result_d, entry.result_i = kd, ki
                continue
            # the cache keys on host values: this syncs the stream
            kd_h, ki_h = kd.cpu().numpy(), ki.cpu().numpy()
            self.cache.put_batch(q.cpu().numpy(), kd_h, ki_h)
            if entry.stitch is None:
                entry.result_d, entry.result_i = kd, ki
                continue
            # cached and kernel rows back into submit order
            cd, ci, mask = entry.stitch
            full_d, full_i = cd.copy(), ci.copy()
            miss = np.flatnonzero(~mask)
            full_d[miss], full_i[miss] = kd_h, ki_h
            entry.result_d = torch.from_numpy(full_d).to(q.device)
            entry.result_i = torch.from_numpy(full_i).to(q.device)
        if dists.is_cuda:
            landed = torch.cuda.Event()
            landed.record()
            for entry, _ in pending:
                entry.landed = landed

    # -- speculation support ------------------------------------------------

    def stale_lookup(self, queries: torch.Tensor
                     ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Any-generation cache lookup feeding speculative decode: the
        caller continues on these possibly stale neighbours while the
        real search runs, so freshness is a quality hint, not a
        correctness requirement. None when any row is absent (or the
        cache is off)."""
        if self.cache is None:
            return None
        hit = self.cache.get_stale(queries.float().cpu().numpy())
        if hit is None:
            return None
        return (torch.from_numpy(hit[0]).to(queries.device),
                torch.from_numpy(hit[1]).to(queries.device))

    def mark_cache_stale(self) -> None:
        """Generation-bump the result cache (a quality knob changed):
        entries stop serving fresh lookups but remain speculation seeds.
        No-op without a cache."""
        if self.cache is not None:
            self.cache.mark_stale()

    def search(self, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Blocking search: submit + flush + result."""
        return self.submit(queries).result()
