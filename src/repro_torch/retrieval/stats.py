"""Per-stage accounting for the retrieval service (twin of
``repro.retrieval.stats``).

``num_batches`` counts flushes; ``scan_dispatches`` counts the scan
launches behind them (one per flush on the fused path, whatever the
shard count) — the number the kernels' launch counters are held to.
Cache hits never reach a dispatch. The speculation counters are the
engine's, mirrored here so one snapshot covers the retrieval plane.

The reference's p50/p99 reservoir per stage and its ``qps`` window come
with the port's ``obs/`` package; ``summary()`` gives mean, max, total
and count until then.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class StageStat:
    """Accumulated wall time of one pipeline stage."""
    total_s: float = 0.0
    count: int = 0
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.total_s += dt
        self.count += 1
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        return dict(mean_us=self.mean_s * 1e6, max_us=self.max_s * 1e6,
                    total_s=self.total_s, count=self.count)


class RetrievalStats:
    """Counters + stage timings for one ``RetrievalService``."""

    def __init__(self) -> None:
        self.num_queries = 0          # query rows submitted
        self.num_batches = 0          # flushes (batched scan + merge runs)
        self.scan_dispatches = 0      # scan launches behind the flushes
        self.batched_rows = 0         # query rows that reached a dispatch
        self.cache_hits = 0           # query rows answered from the cache
        self.cache_misses = 0         # query rows that went to the kernel
        self.cache_stale = 0          # rows present but generation-stale
        #                               at a fresh lookup (missed)
        self.max_coalesced = 0        # largest rows-per-dispatch seen
        self.queue_wait = StageStat()
        self.scan = StageStat()
        self.merge = StageStat()
        self.gather = StageStat()
        # -- speculative retrieval (engine-side) ------------------------
        self.spec_issued = 0          # due steps that decoded ahead on
        #                               stale neighbours while the real
        #                               search ran
        self.spec_verified = 0        # speculation points verified
        self.spec_landed = 0          # points whose search results had
        #                               already landed on the device when
        #                               the harvest asked: latency fully
        #                               hidden behind the decode wave(s)
        self.spec_accepted = 0        # ... whose emitted token matched
        self.spec_rollbacks = 0       # ... that mismatched -> rollback
        self.spec_discarded = 0       # points dropped unverified (later
        #                               points of a rolled-back sequence,
        #                               released sequences)
        self.spec_replayed_steps = 0  # decode steps redone in rollbacks
        self.spec_wait = StageStat()  # host block at verification: the
        #                               retrieval time NOT hidden behind
        #                               decode
        self.spec_replay = StageStat()  # rollback + replay cost per event
        self.ft_spec_flushed = 0      # points settled against a partial
        #                               (failed) real search

    def record_submit(self, nrows: int) -> None:
        self.num_queries += nrows

    def record_batch(self, nrows: int, dispatches: int = 1) -> None:
        self.num_batches += 1
        self.scan_dispatches += dispatches
        self.batched_rows += nrows
        self.max_coalesced = max(self.max_coalesced, nrows)

    def coalescing_factor(self) -> float:
        """Rows per scan dispatch, over the rows that reached one."""
        return self.batched_rows / self.num_batches if self.num_batches \
            else 0.0

    def spec_acceptance_rate(self) -> float:
        """Share of verified speculation points whose speculated token
        matched the real neighbours' (RaLMSpec's headline metric)."""
        return (self.spec_accepted / self.spec_verified
                if self.spec_verified else 0.0)

    def spec_rollback_rate(self) -> float:
        return (self.spec_rollbacks / self.spec_verified
                if self.spec_verified else 0.0)

    def snapshot(self) -> Dict[str, object]:
        """Every counter and stage summary, keyed as the reference's."""
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
            fault=dict(spec_flushed=self.ft_spec_flushed),
        )
