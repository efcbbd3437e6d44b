"""``RetrievalService`` — ChamVS as a vector-search service (twin of
``repro.retrieval.service``, local pipeline only).

Queries from many sequences are submitted as they arise; each
``submit`` returns a ``SearchHandle`` future, and pending rows coalesce
into one batched probe + scan + merge per flush (``max_batch`` rows,
the oldest row's ``deadline_s`` checked at submit and ``poll``, or an
explicit ``flush()`` at the end of a scheduler wave). Batches are
padded to powers of two, as in the reference, so the kernels see
O(log max_batch) shapes. The merge is flat, or hierarchical with
``merge_fanout`` producers per node.

An LRU result cache on quantized query rows (``cache_entries``) answers
a repeated query without the kernel: a full hit completes at submit, a
partial hit sends only the missed rows to the scan and the flush
stitches the batch back in submit order. Its generations keep stale
entries as speculation seeds (``stale_lookup``). A flush that raises
completes its entries with the missing-neighbour sentinel, flagged
partial, and re-raises.

Fault tolerance (``ServiceConfig.failover``, or ``install_chaos``):
each shard is a fault domain with a group of dispatch-target replicas
(``retrieval/replica.py``), and ``_dispatch_scan`` models hedged
dispatch over them — a hang waits out the latency-quantile hedge delay
and re-dispatches, a transient error retries with backoff, a crash
fails over and ejects — under a seeded ``FaultPlan`` injected at the
scan boundary (``retrieval/chaos.py``). All replicas answer from the
same arrays, so the scan runs at most once a flush, and not at all when
no domain has a target. A domain still unresolved at the deadline, or
with every replica ejected, is masked to ``(+inf, -1)`` before the
merge: the flush serves the exact top-k over the live domains, flagged
partial, and never enters the cache. Losing every domain serves the
missing-neighbour sentinel. The armed layer waits for the scan on the
card every flush, because the hedge delay and the deadline need its
real latency: speculation's overlap of search and decode is gone while
it is armed.

Everything runs on the caller's CUDA stream (or the CPU); each flushed
entry carries an event recorded after its results were enqueued, so the
engine can tell whether a search has landed without waiting for later
work. Spans of the ``tracer`` are host wall time. The mesh
``RouterPipeline`` is a later slice.
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
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.retrieval import merge as merge_lib
from repro_torch.retrieval.cache import QueryCache
from repro_torch.retrieval.chaos import ChaosInjector, FaultPlan, ScanHang
from repro_torch.retrieval.replica import (EJECTED, HEALTHY, PROBATION,
                                           FailoverConfig, ReplicaGroup)
from repro_torch.retrieval.stats import RetrievalStats


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Batching, caching and fault-tolerance knobs of one service."""
    max_batch: int = 64           # flush when this many rows are pending
    deadline_s: float = 0.0       # flush when the oldest row waited this
    #                               long (checked at submit/poll; 0 = only
    #                               max_batch or an explicit flush())
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
    merge_fanout: Optional[int] = None  # None = flat K-selection;
    #                               >= 2 = hierarchical tree merge
    measure: bool = True          # synchronize per stage to time it
    failover: Optional[FailoverConfig] = None  # fault-tolerant dispatch:
    #                               replica groups + per-dispatch
    #                               deadlines + hedged re-dispatch +
    #                               partial results. None = the direct
    #                               dispatch. NOTE: the armed layer
    #                               synchronizes every flush (the hedge
    #                               delay and the deadline need the scan's
    #                               real latency)


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

    @property
    def fault_domains(self) -> int:
        """Independent failure domains: each shard can fail on its own
        (candidates stay per shard, [S, nq, k'], until the merge)."""
        return max(1, len(self.shards))

    def scan(self, queries: torch.Tensor):
        if self.cfg.fused:
            return _scan_stage_fused(self.params, self.stacked, queries,
                                     cfg=self.cfg, kk=self.kk)
        return _scan_stage(self.params, self.shards, queries,
                           cfg=self.cfg, kk=self.kk)

    def merge(self, candidates, fanout: Optional[int] = None):
        """Flat K-selection, or hierarchical with ``fanout`` per node."""
        d, i = candidates
        return merge_lib.merge_topk(d, i, self.cfg.k, fanout=fanout)


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
    #                                           of the fault domains (a
    #                                           domain was down past the
    #                                           deadline, or the flush
    #                                           failed): exact top-k over
    #                                           the survivors only
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
        """True when the result covers only the surviving fault domains
        (exact top-k over the live subset; none of them after a total
        loss or a failed flush). Meaningful once ``done()``; the engine
        counts it and never seeds speculation with such a result."""
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
    """Deadline-batched, cached, fault-tolerant, instrumented front door
    to ChamVS."""

    def __init__(self, pipeline: LocalPipeline,
                 config: Optional[ServiceConfig] = None):
        self.pipeline = pipeline
        self.config = config or ServiceConfig()
        self.stats = RetrievalStats()
        self.tracer = NULL_TRACER   # engine.set_tracer swaps a live one in
        self.cache: Optional[QueryCache] = (
            QueryCache(self.config.cache_entries,
                       quant=self.config.cache_quant,
                       partial=self.config.cache_partial)
            if self.config.cache_entries > 0 else None)
        self._inflight: Dict[int, _InFlight] = {}
        self._pending: List[Tuple[_InFlight, torch.Tensor]] = []
        self._pending_rows = 0
        self._next_ticket = 0
        # -- fault tolerance (replica failover / deadlines / chaos) ----
        self.replicas: Optional[ReplicaGroup] = None
        self.chaos: Optional[ChaosInjector] = None
        self._degraded_partial = False    # serve the live subset at once:
        #                                   no hedging or retries
        if self.config.failover is not None:
            self.replicas = ReplicaGroup(
                getattr(pipeline, "fault_domains", 1), self.config.failover,
                on_transition=self._on_replica_transition)

    # -- fault tolerance ----------------------------------------------------

    def _on_replica_transition(self, shard: int, replica: int,
                               old: str, new: str) -> None:
        if new == EJECTED:
            self.stats.ft_ejections += 1
            if self.tracer.enabled:
                self.tracer.instant("retrieval.eject", "retrieval",
                                    args={"shard": shard,
                                          "replica": replica, "from": old})
        elif old == PROBATION and new == HEALTHY:
            self.stats.ft_recoveries += 1
            if self.tracer.enabled:
                self.tracer.instant("retrieval.recover", "retrieval",
                                    args={"shard": shard,
                                          "replica": replica})

    def install_chaos(self, plan) -> ChaosInjector:
        """Arm a ``FaultPlan`` (or a path to its JSON, or an injector) at
        this service's scan boundary. Chaos needs the fault-tolerant
        dispatch loop, so a single-replica group is created on demand
        (every fault beyond retries then degrades to partial results)."""
        if isinstance(plan, str):
            plan = FaultPlan.load(plan)
        injector = ChaosInjector(plan) if isinstance(plan, FaultPlan) \
            else plan
        if self.replicas is None:
            self.replicas = ReplicaGroup(
                getattr(self.pipeline, "fault_domains", 1),
                FailoverConfig(replicas=1),
                on_transition=self._on_replica_transition)
        self.chaos = injector
        return injector

    def set_degraded_partial(self, flag: bool) -> None:
        """The degrade ladder's partial-retrieval rung: when set, the
        dispatch loop gives every domain ONE attempt and serves whatever
        subset answered, shedding hedges, retries and tail waits. A
        no-op unless the fault-tolerant layer is armed."""
        self._degraded_partial = bool(flag)

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
        now = time.perf_counter()
        entry = _InFlight(ticket=self._next_ticket, nrows=q.shape[0],
                          submit_t=now)
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
        else:
            self.poll(now)
        return SearchHandle(self, entry)

    def poll(self, now: Optional[float] = None) -> None:
        """Deadline check: flush if the oldest pending row has waited
        ``deadline_s`` or longer. Call from any serving loop tick."""
        if not self._pending or self.config.deadline_s <= 0.0:
            return
        now = time.perf_counter() if now is None else now
        if now - self._pending[0][0].submit_t >= self.config.deadline_s:
            self.flush()

    def _bucket(self, n: int) -> int:
        return next_pow2(n) if self.config.bucket_pow2 else n

    def _dispatch_scan(self, batch: torch.Tensor
                       ) -> Tuple[Optional[Tuple[torch.Tensor, torch.Tensor]],
                                  Optional[np.ndarray]]:
        """Fault-tolerant scan dispatch. Returns ``(candidates, live)``:
        ``live`` is ``None`` when the layer is not armed (the direct
        dispatch), else a host bool array [S] over the pipeline's fault
        domains; False domains are masked before the merge.

        The loop is a synchronous, deterministic model of hedged
        dispatch, the reference's step for step: per round, every
        unresolved domain is assigned a replica by the health-aware
        ``ReplicaGroup.pick``; the chaos injector (if armed) decides its
        fate. A hang costs the quantile-based hedge delay, then
        re-dispatches to the next replica (a *hedge*); a transient error
        retries with backoff up to ``max_retries`` before failing over; a
        crash fails over at once and ejects. The scan runs at most ONCE
        a flush (every replica answers from the same arrays), and not
        at all when no domain has a target. Domains still unresolved
        when the deadline is spent, or with every replica ejected, are
        reported dead in ``live``."""
        group = self.replicas
        if group is None:
            return self.pipeline.scan(batch), None
        cfg = group.cfg
        clock = group.clock
        realtime = self.chaos is not None and self.chaos.plan.realtime
        S = group.num_shards
        flush_idx = self.stats.num_batches   # the plan's flush index
        stats = self.stats
        tr = self.tracer
        live = np.zeros(S, dtype=bool)
        candidates = None
        scan_s = 0.0
        spent = 0.0                     # modelled elapsed across rounds
        pending = set(range(S))
        tried: List[set] = [set() for _ in range(S)]
        retries = [0] * S
        attempts = [0] * S
        t_wall = clock()
        # bounded by construction; a guard against plan bugs
        guard = S * cfg.replicas * (cfg.max_retries + 2) + 4
        while pending and guard > 0:
            guard -= 1
            assign = [(s, group.pick(s, exclude=tried[s]))
                      for s in sorted(pending)]
            assign = [(s, r) for s, r in assign if r is not None]
            for s in pending - {s for s, _ in assign}:
                tried[s] = set(range(cfg.replicas))   # no target: dead
            pending = {s for s, _ in assign}
            if not assign:
                break
            if candidates is None:
                t0 = clock()
                candidates = self.pipeline.scan(batch)
                # the hedge reservoir and the deadline need the scan's
                # real latency, not its enqueue time: wait for the card
                sync(candidates[0])
                scan_s = clock() - t0
            hedge = group.hedge_delay_s()
            round_cost = 0.0
            for s, rid in assign:
                attempts[s] += 1
                fault = (self.chaos.outcome(flush_idx, s, rid, attempts[s])
                         if self.chaos is not None else None)
                kind = fault.kind if fault is not None else None
                if kind is None or kind == "slow":
                    lat = scan_s + (fault.slow_s if fault else 0.0)
                    if realtime and fault is not None:
                        group.sleep(min(fault.slow_s, cfg.sleep_cap_s))
                    late = (cfg.dispatch_deadline_s > 0.0 and
                            spent + lat > cfg.dispatch_deadline_s)
                    group.report(s, rid, "slow" if late else "ok",
                                 latency_s=lat)
                    if late:
                        stats.ft_timeouts += 1   # late success: result
                        #                          used, replica charged
                    live[s] = True
                    pending.discard(s)
                elif kind == "hang":
                    lat = hedge
                    stats.ft_timeouts += 1
                    stats.ft_hedges += 1
                    group.report(s, rid, "timeout")
                    tried[s].add(rid)
                    if tr.enabled:
                        tr.instant("retrieval.hedge", "retrieval",
                                   args={"shard": s, "replica": rid,
                                         "delay_us": hedge * 1e6})
                    if realtime:
                        group.sleep(min(hedge, cfg.sleep_cap_s))
                elif kind == "error":
                    lat = cfg.backoff_s * (2 ** retries[s])
                    stats.ft_retries += 1
                    group.report(s, rid, "error")
                    retries[s] += 1
                    if retries[s] > cfg.max_retries:
                        tried[s].add(rid)
                        retries[s] = 0
                    if realtime and lat > 0:
                        group.sleep(min(lat, cfg.sleep_cap_s))
                else:  # crash: fail fast, eject, fail over
                    lat = 0.0
                    stats.ft_crashes += 1
                    group.report(s, rid, "crash")
                    tried[s].add(rid)
                round_cost = max(round_cost, lat)
            spent += round_cost
            if self._degraded_partial:
                break   # partial-retrieval rung: one attempt per domain
            if cfg.dispatch_deadline_s > 0.0 and \
                    spent >= cfg.dispatch_deadline_s:
                break   # deadline spent: survivors only
        stats.ft_dispatch.add(clock() - t_wall)
        if not live.all() and not cfg.allow_partial:
            dead = [int(s) for s in np.flatnonzero(~live)]
            raise ScanHang(
                f"fault domains {dead} unresolved past the deadline and "
                "ServiceConfig.failover.allow_partial is False")
        return candidates, live

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
        tr = self.tracer
        t0 = time.perf_counter()
        for entry, _ in pending:
            self.stats.queue_wait.add(t0 - entry.submit_t)
        if tr.enabled:
            # retroactive span: the wait started when the OLDEST pending
            # row was submitted
            oldest = pending[0][0].submit_t
            tr.complete("retrieval.queue_wait", "retrieval", oldest,
                        t0 - oldest, args={"rows": nrows,
                                           "entries": len(pending)})
        with tr.span("retrieval.scan", "retrieval",
                     args={"rows": nrows} if tr.enabled else None):
            candidates, live = self._dispatch_scan(batch)
            if measure and candidates is not None:
                sync(candidates[0])
        t1 = time.perf_counter()
        partial = live is not None and not bool(live.all())
        live_frac = float(live.mean()) if live is not None else 1.0
        with tr.span("retrieval.merge", "retrieval"):
            if not partial:
                dists, ids = self.pipeline.merge(candidates,
                                                 self.config.merge_fanout)
            elif candidates is not None and bool(live.any()) and \
                    candidates[0].ndim == 3 and \
                    candidates[0].shape[0] == live.shape[0]:
                # per-shard candidate lists: mask the dead domains to the
                # (+inf, -1) padding, then the ordinary K-selection IS
                # the exact top-k over the live subset
                dists, ids = self.pipeline.merge(
                    merge_lib.mask_producers(*candidates, live),
                    self.config.merge_fanout)
            else:
                # total loss: every row gets the missing-neighbour
                # sentinel, in the kernels' dtypes on the queries' device
                # (knnlm_interpolate falls back to the bare LM on it)
                n, k = batch.shape[0], self.pipeline.k
                dists = torch.full((n, k), float("inf"),
                                   dtype=torch.float32, device=batch.device)
                ids = torch.full((n, k), -1, dtype=torch.int32,
                                 device=batch.device)
            if measure:
                sync(dists)
        if measure:
            self.stats.scan.add(t1 - t0)
            self.stats.merge.add(time.perf_counter() - t1)
        self.stats.record_batch(
            nrows, dispatches=(self.pipeline.scan_dispatches
                               if candidates is not None else 0))
        if partial:
            self.stats.ft_partial_flushes += 1
            self.stats.ft_partial_rows += nrows
            if tr.enabled:
                tr.instant("retrieval.partial", "retrieval",
                           args={"rows": nrows, "live": int(live.sum()),
                                 "domains": int(live.shape[0])})
        offset = 0
        for entry, q in pending:
            entry.partial = partial
            entry.live_frac = live_frac
            kd = dists[offset:offset + entry.kernel_rows]
            ki = ids[offset:offset + entry.kernel_rows]
            offset += entry.kernel_rows
            if self.cache is None:
                entry.result_d, entry.result_i = kd, ki
                continue
            # the cache keys on host values: this syncs the stream
            kd_h, ki_h = kd.cpu().numpy(), ki.cpu().numpy()
            if not partial:
                # partial results never enter the cache: they would
                # outlive the fault and serve degraded neighbours to
                # full-quality lookups
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
