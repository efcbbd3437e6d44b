"""Token data pipeline (twin of ``repro.data.pipeline``, numpy only, so
the port keeps its own copy): deterministic, stateless, resumable. For
every ``(seed, step, host_id, num_hosts)`` its batches are the
reference's, bit for bit.

Design goals (fault tolerance): the batch for step `s` is a
pure function of (seed, s) — no iterator state to checkpoint; a restarted
job that resumes at step s sees exactly the batches it would have seen.
Both sources implement that contract:

  * ``SyntheticTokens`` — hash-derived tokens, zero I/O (smoke tests,
    dry-run-adjacent examples).
  * ``MemmapTokens``    — flat binary token shards + np.memmap, the
    production path (pack once, stream forever).

Host sharding: every data-parallel host calls ``host_batch`` with its own
(host_id, num_hosts) and gets its slice; slices are disjoint and cover the
global batch.
"""
from __future__ import annotations

import dataclasses
import pathlib
import threading
import queue as queue_mod
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 1234


class SyntheticTokens:
    """Deterministic pseudo-corpus. Token stream = philox(seed, position);
    sequences are consecutive windows, batches are strided across the stream
    so every (step, row) maps to a unique document position."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.Generator(np.random.Philox(key=c.seed, counter=step))
        toks = rng.integers(0, c.vocab_size,
                            size=(c.global_batch, c.seq_len + 1),
                            dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def host_batch(self, step: int, host_id: int = 0, num_hosts: int = 1
                   ) -> Dict[str, np.ndarray]:
        b = self.batch(step)
        per = self.cfg.global_batch // num_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in b.items()}


class MemmapTokens:
    """Flat int32 token file; batch rows are deterministic strided windows."""

    def __init__(self, path: str | pathlib.Path, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len
        if self.n_windows < cfg.global_batch:
            raise ValueError("corpus too small for one global batch")

    @staticmethod
    def write_corpus(path: str | pathlib.Path, tokens: np.ndarray) -> None:
        np.asarray(tokens, np.int32).tofile(path)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        # deterministic shuffled window order per epoch
        epoch, within = divmod(step * c.global_batch, self.n_windows)
        rng = np.random.Generator(np.random.Philox(key=c.seed, counter=epoch))
        perm = rng.permutation(self.n_windows)
        idx = perm[(within + np.arange(c.global_batch)) % self.n_windows]
        rows = np.stack([self.data[i * c.seq_len: i * c.seq_len + c.seq_len + 1]
                         for i in idx])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def host_batch(self, step: int, host_id: int = 0, num_hosts: int = 1
                   ) -> Dict[str, np.ndarray]:
        b = self.batch(step)
        per = self.cfg.global_batch // num_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in b.items()}


class Prefetcher:
    """Background-thread prefetch of the deterministic stream (overlaps host
    data work with device steps; depth 2 is enough since batches are cheap)."""

    def __init__(self, source, start_step: int, depth: int = 2,
                 host_id: int = 0, num_hosts: int = 1):
        self.source = source
        self.q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self.host_id, self.num_hosts = host_id, num_hosts
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        s = self._step
        while not self._stop.is_set():
            batch = self.source.host_batch(s, self.host_id, self.num_hosts)
            while not self._stop.is_set():
                try:
                    self.q.put((s, batch), timeout=0.1)
                    break
                except queue_mod.Full:
                    continue
            s += 1

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
