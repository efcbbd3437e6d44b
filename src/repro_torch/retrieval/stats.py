"""Per-stage accounting for the retrieval service (twin of the counters
of ``repro.retrieval.stats`` that the local service uses).

``num_batches`` counts flushes; ``scan_dispatches`` counts the scan
launches behind them (one per flush on the fused path, whatever the
shard count) — the number the kernels' launch counters are held to.
"""
from __future__ import annotations

import dataclasses


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


class RetrievalStats:
    """Counters + stage timings for one ``RetrievalService``."""

    def __init__(self) -> None:
        self.num_queries = 0          # query rows submitted
        self.num_batches = 0          # flushes (batched scan + merge runs)
        self.scan_dispatches = 0      # scan launches behind the flushes
        self.batched_rows = 0         # query rows that reached a dispatch
        self.max_coalesced = 0        # largest rows-per-dispatch seen
        self.queue_wait = StageStat()
        self.scan = StageStat()
        self.merge = StageStat()
        self.gather = StageStat()

    def record_submit(self, nrows: int) -> None:
        self.num_queries += nrows

    def record_batch(self, nrows: int, dispatches: int = 1) -> None:
        self.num_batches += 1
        self.scan_dispatches += dispatches
        self.batched_rows += nrows
        self.max_coalesced = max(self.max_coalesced, nrows)

    def coalescing_factor(self) -> float:
        """Rows per scan dispatch."""
        return self.batched_rows / self.num_batches if self.num_batches \
            else 0.0
