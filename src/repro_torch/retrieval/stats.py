"""Per-stage accounting for the retrieval service (twin of
``repro.retrieval.stats``, paper Fig. 9/10 axes).

ChamVS latency decomposes into queue wait (micro-batching delay), the
per-shard IVF/PQ scan, the K-selection merge, and the payload gather.
``RetrievalStats`` accumulates each stage plus the service-level
counters: queries, flushes, scan dispatches (coalescing factor), the
cache split, the speculation plane (the engine's counters, mirrored
here so one snapshot covers the retrieval plane) and the fault-
tolerance plane (``ft_*``: timeouts, hedges, retries, crashes,
ejections, recoveries, partial flushes and rows, dispatch-loop time).
On the card, stage times are host wall time and cover the device work
only where the flush waits for it (``measure`` on, or the fault-
tolerant layer armed).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

from repro_torch.obs.metrics import Reservoir


@dataclasses.dataclass
class StageStat:
    """Accumulated wall time for one pipeline stage.

    Besides mean/max, a bounded reservoir (``repro_torch.obs.metrics.
    Reservoir``, algorithm R) keeps a uniform sample of the per-event
    durations so ``summary()`` can report p50/p99 — micro-batching
    makes the stage distributions bimodal (deadline flushes vs full
    flushes), and a mean+max pair hides exactly that tail."""
    total_s: float = 0.0
    count: int = 0
    max_s: float = 0.0
    reservoir: Reservoir = dataclasses.field(
        default_factory=lambda: Reservoir(cap=1024))

    def add(self, dt: float) -> None:
        self.total_s += dt
        self.count += 1
        if dt > self.max_s:
            self.max_s = dt
        self.reservoir.add(dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def p50_s(self) -> float:
        return self.reservoir.quantile(0.50)

    def p99_s(self) -> float:
        return self.reservoir.quantile(0.99)

    def summary(self) -> Dict[str, float]:
        return dict(mean_us=self.mean_s * 1e6, max_us=self.max_s * 1e6,
                    p50_us=self.p50_s() * 1e6, p99_us=self.p99_s() * 1e6,
                    total_s=self.total_s, count=self.count)


class RetrievalStats:
    """Counters + stage timings for one ``RetrievalService``.

    ``num_batches`` counts flushes (one batched scan+merge per flush);
    dividing ``num_queries`` by it gives the achieved coalescing factor.
    ``scan_dispatches`` counts the scan launches behind them: one per
    flush on the fused path whatever the shard count, one per shard
    staged (``LocalPipeline.scan_dispatches``) — the number the kernels'
    launch counters are held to on the card. Cache hits never reach a
    dispatch, and neither does a flush in which no fault domain had a
    dispatch target (the fault-tolerant layer's total loss: the scan
    does not run, so it counts 0 here where the reference counts the
    pipeline's dispatches regardless). ``num_batches`` at dispatch time is also the flush index
    a ``FaultPlan`` keys on, so it must count exactly as the
    reference's does.
    """

    #: gaps between consecutive recorded events larger than this are
    #: treated as idle time and excluded from the QPS window
    idle_gap_s: float = 1.0

    def __init__(self, clock: Callable[[], float] = time.perf_counter
                 ) -> None:
        self._clock = clock
        self.reset()

    def reset(self) -> None:
        self.num_queries = 0          # query rows submitted
        self.num_batches = 0          # flushes (batched scan+merge runs)
        self.scan_dispatches = 0      # ChamVS scan kernel dispatches: the
        #                               fused path issues ONE per flush
        #                               regardless of shard count, the
        #                               staged oracle one per shard
        self.batched_rows = 0         # query rows that reached a dispatch
        self.cache_hits = 0           # query rows answered from cache
        self.cache_misses = 0         # query rows that went to the kernel
        self.cache_stale = 0          # rows present but generation-stale
        #                               at a fresh lookup (missed)
        self.max_coalesced = 0        # largest rows-per-dispatch seen
        self.queue_wait = StageStat()
        self.scan = StageStat()
        self.merge = StageStat()
        self.gather = StageStat()
        # -- speculative retrieval (engine-side, mirrored here so one
        #    snapshot covers the whole retrieval plane) ----------------
        self.spec_issued = 0          # speculative dispatches: due steps
        #                               that decoded ahead on stale
        #                               neighbors while the real search
        #                               ran async
        self.spec_verified = 0        # speculation points verified
        self.spec_landed = 0          # points whose search results were
        #                               already materialized when the
        #                               harvest asked — latency fully
        #                               hidden behind the decode wave(s)
        self.spec_accepted = 0        # ... whose emitted token matched
        self.spec_rollbacks = 0       # ... that mismatched -> rollback
        self.spec_discarded = 0       # points dropped unverified (later
        #                               points of a rolled-back sequence,
        #                               cancelled requests, flushes)
        self.spec_replayed_steps = 0  # decode steps redone during
        #                               rollback replay
        self.spec_wait = StageStat()  # host block at verification: the
        #                               residual retrieval time NOT
        #                               hidden behind decode
        self.spec_replay = StageStat()  # rollback + replay cost per event
        # -- fault tolerance (replica failover / deadlines / chaos) ----
        self.ft_timeouts = 0          # dispatches past the deadline: hung
        #                               replicas AND late-but-used results
        self.ft_hedges = 0            # hedged re-dispatches after a hang
        #                               outlived the hedge delay
        self.ft_retries = 0           # transient-error re-dispatches
        #                               (retry-with-backoff)
        self.ft_crashes = 0           # replica-crash outcomes observed
        self.ft_ejections = 0         # health transitions into `ejected`
        self.ft_recoveries = 0        # probation -> healthy transitions
        self.ft_partial_flushes = 0   # flushes that served a live subset
        self.ft_partial_rows = 0      # query rows in those flushes (the
        #                               recall-proxy accounting: each row's
        #                               top-k covered only live domains)
        self.ft_spec_flushed = 0      # speculation points settled against
        #                               a partial (timed-out) real search
        self.ft_dispatch = StageStat()  # wall time of the fault-tolerant
        #                               dispatch loop per flush (scan +
        #                               failover + hedging)
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._active_s = 0.0          # accumulated busy window (gaps
        #                               clipped to idle_gap_s)

    # ------------------------------------------------------------------
    def _touch(self, now: float) -> None:
        """Advance the active-time window: accumulate the gap since the
        previous event, clipped to ``idle_gap_s`` so a long idle pause
        between bursts doesn't deflate the rate."""
        if self._t_first is None:
            self._t_first = now
        else:
            self._active_s += min(max(0.0, now - self._t_last),
                                  self.idle_gap_s)
        self._t_last = now

    def record_submit(self, nrows: int) -> None:
        self._touch(self._clock())
        self.num_queries += nrows

    def record_batch(self, nrows: int, dispatches: int = 1) -> None:
        self.num_batches += 1
        self.scan_dispatches += dispatches
        self.batched_rows += nrows
        self._touch(self._clock())
        if nrows > self.max_coalesced:
            self.max_coalesced = nrows

    def coalescing_factor(self) -> float:
        """Rows per kernel dispatch, over the rows that actually reached
        a dispatch — cache-hit rows never produce one, so they are
        excluded (else a cached run would overstate batching)."""
        return self.batched_rows / self.num_batches if self.num_batches \
            else 0.0

    def qps(self) -> float:
        """Queries per second over the *active* window.

        The old first-to-last-timestamp window had two failure modes:
        a single flush (submit and batch at nearly the same instant)
        reported ~0 or wildly inflated rates, and any idle gap between
        bursts deflated the rate toward zero. The active window sums
        inter-event gaps clipped to ``idle_gap_s``, so bursts separated
        by idle time report the rate *within* the bursts."""
        if self.num_queries == 0 or self._t_first is None:
            return 0.0
        window = self._active_s
        if window <= 0.0:
            # only one recorded instant so far: measure to "now",
            # clipped to the idle gap, so a single flush reports a
            # finite rate instead of 0.0
            window = min(max(self._clock() - self._t_first, 1e-9),
                         self.idle_gap_s)
        return self.num_queries / window

    def spec_acceptance_rate(self) -> float:
        """Fraction of verified speculation points whose speculated
        token matched the real neighbors' (RaLMSpec's headline metric)."""
        return (self.spec_accepted / self.spec_verified
                if self.spec_verified else 0.0)

    def spec_rollback_rate(self) -> float:
        return (self.spec_rollbacks / self.spec_verified
                if self.spec_verified else 0.0)

    def snapshot(self) -> Dict[str, object]:
        """The Fig. 9/10-style breakdown the benchmark emits."""
        return dict(
            num_queries=self.num_queries,
            num_batches=self.num_batches,
            scan_dispatches=self.scan_dispatches,
            batched_rows=self.batched_rows,
            coalescing_factor=self.coalescing_factor(),
            cache_hits=self.cache_hits,
            cache_misses=self.cache_misses,
            cache_stale=self.cache_stale,
            max_coalesced=self.max_coalesced,
            qps=self.qps(),
            queue_wait=self.queue_wait.summary(),
            scan=self.scan.summary(),
            merge=self.merge.summary(),
            gather=self.gather.summary(),
            speculation=dict(
                issued=self.spec_issued,
                verified=self.spec_verified,
                landed=self.spec_landed,
                accepted=self.spec_accepted,
                rollbacks=self.spec_rollbacks,
                discarded=self.spec_discarded,
                replayed_steps=self.spec_replayed_steps,
                acceptance_rate=self.spec_acceptance_rate(),
                rollback_rate=self.spec_rollback_rate(),
                spec_wait=self.spec_wait.summary(),
                spec_replay=self.spec_replay.summary(),
            ),
            fault=dict(
                timeouts=self.ft_timeouts,
                hedges=self.ft_hedges,
                retries=self.ft_retries,
                crashes=self.ft_crashes,
                ejections=self.ft_ejections,
                recoveries=self.ft_recoveries,
                partial_flushes=self.ft_partial_flushes,
                partial_rows=self.ft_partial_rows,
                spec_flushed=self.ft_spec_flushed,
                dispatch=self.ft_dispatch.summary(),
            ),
        )
