"""LRU query-result cache for the retrieval service (twin of
``repro.retrieval.cache``; host-side numpy, so the same code).

RALM decode queries are hidden states, so exact-match caching never
fires; instead keys are the query vectors quantized to a grid
(``round(q / quant)``) — queries within the quantization radius share a
key, which is the regime where their top-K lists agree anyway. Entries
are per query *row*.

Batch lookups come in two flavors, selected at construction:

  * ``partial=False``: all-or-nothing — a batched submission either
    skips the kernel entirely or runs as one batch.
  * ``partial=True``: per-row lookup returning a hit mask alongside the
    result arrays, so the service can send ONLY the missed rows to the
    kernel and stitch the batch back together at flush.

Entries also carry a **generation**: ``mark_stale()`` bumps the cache's
current generation without dropping entries, so a quality-knob change
(such as an nprobe swap) invalidates them for *fresh* lookups while
``get_stale`` can still serve them as speculation seeds — stale
neighbors are exactly what speculative retrieval decodes ahead with,
and verification catches any divergence.

Hit/miss/stale counters live here (mirrored into ``RetrievalStats`` by
the service); eviction is least-recently-*used* — both hits and inserts
refresh recency.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np


class QueryCache:
    """LRU map: quantized query vector -> (dists [K], ids [K], gen)."""

    def __init__(self, capacity: int, quant: float = 1e-3,
                 partial: bool = False):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self.capacity = capacity
        self.quant = quant
        self.partial = partial
        self.generation = 0      # bumped by mark_stale(); entries written
        #                          at an older generation only serve
        #                          through get_stale()
        self.hits = 0            # fresh rows served by get_batch
        self.misses = 0          # rows get_batch could not serve fresh
        self.stale = 0           # of those misses: present but outdated
        self.stale_served = 0    # stale rows served via get_stale()
        self._data: "OrderedDict[bytes, Tuple[np.ndarray, np.ndarray, int]]" \
            = OrderedDict()

    def __len__(self) -> int:
        return len(self._data)

    def key(self, row: np.ndarray) -> bytes:
        q = np.asarray(row, np.float32)
        return np.round(q / self.quant).astype(np.int64).tobytes()

    def mark_stale(self) -> None:
        """Invalidate every current entry for fresh lookups WITHOUT
        dropping it, so stale neighbours stay available as speculation
        seeds after a quality change."""
        self.generation += 1

    # ------------------------------------------------------------------
    def get_batch(self, queries: np.ndarray):
        """Fresh lookup of a [B, d] query batch.

        All-or-nothing mode (``partial=False``): every row present at
        the current generation -> (dists [B, K], ids [B, K]), counted
        as B hits with recency refreshed; otherwise None, counted as B
        misses (rows found but stale additionally bump ``stale``).

        Partial mode (``partial=True``): returns (dists [B, K],
        ids [B, K], hit [B] bool) with missed rows zero-filled, or None
        when no row hits at all; per-row hit/miss/stale counting."""
        queries = np.asarray(queries, np.float32)
        keys = [self.key(row) for row in queries]
        fresh = [kb in self._data and self._data[kb][2] == self.generation
                 for kb in keys]
        if not self.partial:
            if not all(fresh):
                self.misses += len(keys)
                self.stale += sum(1 for kb, f in zip(keys, fresh)
                                  if not f and kb in self._data)
                return None
            self.hits += len(keys)
            rows = []
            for kb in keys:
                self._data.move_to_end(kb)
                rows.append(self._data[kb])
            return (np.stack([r[0] for r in rows]),
                    np.stack([r[1] for r in rows]))
        nhit = sum(fresh)
        self.hits += nhit
        self.misses += len(keys) - nhit
        self.stale += sum(1 for kb, f in zip(keys, fresh)
                          if not f and kb in self._data)
        if nhit == 0:
            return None
        first = next(self._data[kb] for kb, f in zip(keys, fresh) if f)
        dists = np.zeros((len(keys),) + first[0].shape, first[0].dtype)
        ids = np.full((len(keys),) + first[1].shape, -1, first[1].dtype)
        for j, (kb, f) in enumerate(zip(keys, fresh)):
            if f:
                self._data.move_to_end(kb)
                d, i, _ = self._data[kb]
                dists[j], ids[j] = d, i
        return dists, ids, np.asarray(fresh, bool)

    def get_stale(self, queries: np.ndarray
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Stale-tolerant all-or-nothing lookup: serve ANY generation.

        Feeds speculation (the caller decodes ahead on these and
        verifies against the real search), so correctness never depends
        on freshness here. No hit/miss accounting — only
        ``stale_served`` for rows whose entry is outdated — and no
        recency refresh (a speculation seed is not a demand hit)."""
        queries = np.asarray(queries, np.float32)
        keys = [self.key(row) for row in queries]
        if any(kb not in self._data for kb in keys):
            return None
        rows = [self._data[kb] for kb in keys]
        self.stale_served += sum(1 for r in rows
                                 if r[2] != self.generation)
        return (np.stack([r[0] for r in rows]),
                np.stack([r[1] for r in rows]))

    def put_batch(self, queries: np.ndarray, dists: np.ndarray,
                  ids: np.ndarray) -> None:
        """Insert per-row results at the current generation, evicting
        least-recently-used entries beyond capacity."""
        queries = np.asarray(queries, np.float32)
        for row, d, i in zip(queries, np.asarray(dists), np.asarray(ids)):
            kb = self.key(row)
            self._data[kb] = (d, i, self.generation)
            self._data.move_to_end(kb)
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)

    def contains(self, row: np.ndarray, any_generation: bool = False
                 ) -> bool:
        """Membership probe without touching counters or recency."""
        kb = self.key(row)
        if kb not in self._data:
            return False
        return any_generation or self._data[kb][2] == self.generation

    def clear(self) -> None:
        self._data.clear()
