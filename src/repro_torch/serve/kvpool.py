"""``KVCachePool`` — one preallocated, slotted KV cache for every active
sequence (twin of ``repro.serve.kvpool``).

Every cache leaf carries a pooled batch axis of ``capacity + 1`` slot
rows (the extra row is a scratch slot that absorbs wave padding).
Admission assigns a request's prompt rows to free slots, prefill writes
its KV into them, completion frees them. ``transformer.decode_wave``
advances any subset of slots in one step, writing the new K/V into the
pool in place.

Wave sizes are bucketed to powers of two, and attention reads are
cropped to the wave's seq-block aligned valid prefix (``attn_len``).
A speculation rollback rewinds a sequence's slots (``rewind``), which is
bookkeeping only: validity comes from each row's position. Alloc,
release and rewind drop ``kvpool.*`` instants on the ``tracer``.

An encoder-decoder (RETRO) also keeps each slot's encoder states in one
pooled buffer ``enc`` [capacity + 1, S_enc, d], created at the first
``write_enc``; ``gather_enc`` hands a padded wave its rows (pad rows
read the scratch row).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.retrieval.service import next_pow2

__all__ = ["KVCachePool", "PoolStats", "next_pow2"]


@dataclasses.dataclass
class PoolStats:
    """Slot-lifecycle accounting (benchmarks + tests)."""
    allocs: int = 0              # slot rows handed out
    releases: int = 0            # slot rows returned
    high_water: int = 0          # max slot rows in use at once
    slot_grows: int = 0          # capacity doublings
    seq_grows: int = 0           # sequence-axis extensions
    waves: int = 0               # decode waves dispatched
    wave_rows: int = 0           # live rows across all waves
    rewinds: int = 0             # speculation rollbacks (slot-row groups)
    rewound_tokens: int = 0      # KV positions logically discarded
    buckets: set = dataclasses.field(default_factory=set)   # wave buckets
    blocks_total: int = 0        # seq blocks a full-pool read would touch
    blocks_skipped: int = 0      # blocks cropped past the wave's max pos
    compiled: set = dataclasses.field(default_factory=set)
    #                            # distinct (bucket, kv_len, capacity,
    #                            # max_seq) wave shapes — the reference's
    #                            # recompile key, kept as a shape count

    def mean_wave(self) -> float:
        return self.wave_rows / self.waves if self.waves else 0.0

    @property
    def decode_compiles(self) -> int:
        return len(self.compiled)

    def skip_fraction(self) -> float:
        return (self.blocks_skipped / self.blocks_total
                if self.blocks_total else 0.0)


class KVCachePool:
    """Slotted decode-cache pool owned by the engine.

    ``alloc`` hands out the lowest free ids (deterministic reuse),
    ``release`` returns them; index ``capacity`` is the scratch slot."""

    def __init__(self, cfg: ModelConfig, capacity: int, max_seq: int,
                 fixed: bool = False, seq_block: int = 1, device="cpu"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if seq_block < 1:
            raise ValueError(f"seq_block must be >= 1, got {seq_block}")
        self.cfg = cfg
        self.capacity = capacity
        self.seq_block = seq_block
        self.max_seq = self._align(max_seq)
        self.fixed = fixed
        self.device = torch.device(device)
        self.caches = tf.init_cache(cfg, capacity + 1, self.max_seq,
                                    device=self.device)
        self.enc: Optional[torch.Tensor] = None   # [capacity + 1, S, d]
        self._free: List[int] = list(range(capacity))
        self.stats = PoolStats()
        self.tracer = NULL_TRACER    # engine.set_tracer swaps a live one in

    # -- slot lifecycle -----------------------------------------------------

    @property
    def scratch(self) -> int:
        return self.capacity

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, n: int) -> np.ndarray:
        """Claim ``n`` slot rows (lowest free ids first)."""
        if n > len(self._free):
            raise RuntimeError(
                f"KVCachePool exhausted: want {n} rows, {len(self._free)} "
                f"free of {self.capacity} (admission should have deferred)")
        self._free.sort()
        slots, self._free = self._free[:n], self._free[n:]
        self.stats.allocs += n
        self.stats.high_water = max(self.stats.high_water, self.num_used)
        if self.tracer.enabled:
            self.tracer.instant("kvpool.alloc", "kvpool",
                                args={"rows": n, "used": self.num_used,
                                      "capacity": self.capacity})
        return np.asarray(slots, np.int32)

    def release(self, slots: np.ndarray) -> None:
        self._free.extend(int(s) for s in slots)
        self.stats.releases += len(slots)
        if self.tracer.enabled:
            self.tracer.instant("kvpool.release", "kvpool",
                                args={"rows": len(slots),
                                      "used": self.num_used,
                                      "capacity": self.capacity})

    def rewind(self, slots: np.ndarray, keep_len: int,
               old_len: int) -> None:
        """Logically rewind ``slots`` from ``old_len`` valid KV positions
        back to ``keep_len`` (speculation rollback), WITHOUT touching
        device memory.

        For full-length (linear) caches this is free by construction:
        decode attention derives validity from the row's *position*
        (slot index i is read iff i < kv_len and i <= pos: the plain
        version's ``decode_validity`` in ``kernels/decode_attn/ref.py``
        and the CUDA kernel's ``s <= p`` test in ``csrc/decode_attn.cu``),
        so the stale suffix above ``keep_len`` is never read once the
        sequence's position moves back, and the replayed decodes
        overwrite it index for index. Ring (sliding-window) caches alias
        positions modulo the window, so a rewind deeper than one step
        would leave stale entries *inside* the live window where
        validity cannot mask them: rejected here, and the engine caps
        speculation depth at 1 for windowed models. Recurrent state
        (RWKV/SSM blocks) cannot be rewound at all: the state update is
        not invertible and old states are not kept."""
        if not (0 < keep_len <= old_len <= self.max_seq):
            raise ValueError(
                f"rewind wants 0 < keep_len <= old_len <= max_seq, got "
                f"keep_len={keep_len} old_len={old_len} "
                f"max_seq={self.max_seq}")
        dropped = old_len - keep_len
        if self.cfg.ssm_state > 0 or self.cfg.block in ("rwkv6", "hybrid"):
            raise ValueError(
                "KV rewind is undefined for recurrent-state blocks "
                f"(block={self.cfg.block!r}, ssm_state="
                f"{self.cfg.ssm_state}): gate speculation off for this "
                "model")
        if dropped > 1 and self.cfg.window > 0 and \
                "local" in self.cfg.pattern_classes():
            raise ValueError(
                f"ring (window={self.cfg.window}) caches alias positions "
                f"modulo the window: rewinding {dropped} steps would "
                "leave stale rows inside the live window; speculation "
                "depth must be 1 for windowed models")
        self.stats.rewinds += 1
        self.stats.rewound_tokens += dropped * len(slots)
        if self.tracer.enabled:
            self.tracer.instant("kvpool.rewind", "kvpool",
                                args={"rows": len(slots),
                                      "keep_len": keep_len,
                                      "dropped": dropped})

    # -- wave shape bucketing ----------------------------------------------

    def _align(self, n: int) -> int:
        """Round ``n`` up to the pool's seq-block quantum."""
        b = self.seq_block
        return -(-n // b) * b

    def attn_len(self, max_pos: int, bucket: int) -> int:
        """Attention length for one wave: the block-aligned valid prefix
        covering every row's position, clamped to the pool. Also the
        bookkeeping point for the ragged-wave savings."""
        kv_len = min(self._align(max_pos + 1), self.max_seq)
        nb_full = self.max_seq // self.seq_block
        self.stats.blocks_total += nb_full
        self.stats.blocks_skipped += nb_full - kv_len // self.seq_block
        self.stats.compiled.add((bucket, kv_len, self.capacity, self.max_seq))
        return kv_len

    def bucket(self, n: int) -> int:
        """Pow2 wave-size bucket."""
        b = next_pow2(n)
        self.stats.buckets.add(b)
        return b

    def pad_wave(self, tokens: torch.Tensor, slots: np.ndarray,
                 positions: np.ndarray, bucket: Optional[int] = None
                 ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """Pad a W-row wave to its pow2 bucket, or to ``bucket`` rows (a
        rollback replays a step at the shape of the wave it stands in
        for). Pad rows carry token 0 at position 0 against the scratch
        slot; their outputs are dropped."""
        w = len(slots)
        self.stats.waves += 1
        self.stats.wave_rows += w
        if bucket is None:
            bucket = self.bucket(w)
        elif bucket < w:
            raise ValueError(f"bucket {bucket} < wave rows {w}")
        else:
            self.stats.buckets.add(bucket)
        pad = bucket - w
        if pad:
            tokens = torch.cat([tokens, tokens.new_zeros(
                (pad,) + tuple(tokens.shape[1:]))])
            slots = np.concatenate(
                [slots, np.full((pad,), self.scratch, np.int32)])
            positions = np.concatenate(
                [positions, np.zeros((pad,), positions.dtype)])
        return tokens, slots, positions

    # -- prefill rows -------------------------------------------------------

    def write_prefill(self, slots: np.ndarray, caches: Any) -> None:
        """Copy a prefilled request's cache rows (built with the pool's
        ``max_seq``) into its slots, in place."""
        idx = torch.as_tensor(np.asarray(slots), device=self.device).long()
        for cls, c in caches["classes"].items():
            for key, rows in c.items():
                pool = self.caches["classes"][cls][key]
                pool[:, idx] = rows.to(pool.dtype)

    def write_enc(self, slots: np.ndarray, rows: torch.Tensor) -> None:
        """Per-slot encoder states (RETRO): [B, S_enc, d] rows into the
        pooled buffer, in place. Every write keeps the row shape of the
        first one: the buffer is shared by every live slot. Widths differ
        only when ``rag.k * rag.chunk_len < 8`` (prefill's neutral
        encoder rows are at least 8 wide), which needs the per-sequence
        loop."""
        if self.enc is None:
            shape = (self.capacity + 1,) + tuple(rows.shape[1:])
            self.enc = torch.zeros(shape, dtype=rows.dtype,
                                   device=self.device)
        elif self.enc.shape[1:] != rows.shape[1:]:
            raise ValueError(
                f"pooled enc rows must keep shape {tuple(self.enc.shape[1:])}"
                f", got {tuple(rows.shape[1:])} — heterogeneous encoder "
                "widths (rag.k * rag.chunk_len < 8) need the per-sequence "
                "path (wave=False)")
        idx = torch.as_tensor(np.asarray(slots), device=self.device).long()
        self.enc[idx] = rows.to(self.enc.dtype)

    def gather_enc(self, slots: np.ndarray) -> Optional[torch.Tensor]:
        """The wave's encoder rows [W, S_enc, d] (None before any
        ``write_enc``: a decoder-only model)."""
        if self.enc is None:
            return None
        return self.enc[torch.as_tensor(np.asarray(slots),
                                        device=self.device).long()]

    # -- growth -------------------------------------------------------------

    def grow_slots(self, new_capacity: int) -> None:
        """Grow the slot axis of every leaf; the old scratch row becomes a
        free slot (prefill rewrites whole rows at admission)."""
        if self.fixed:
            raise RuntimeError("fixed-capacity pool cannot grow")
        if new_capacity <= self.capacity:
            return
        delta = new_capacity - self.capacity
        for c in self.caches["classes"].values():
            for key, a in c.items():
                c[key] = torch.cat([a, a.new_zeros(
                    (a.shape[0], delta) + tuple(a.shape[2:]))], dim=1)
        if self.enc is not None:
            self.enc = torch.cat([self.enc, self.enc.new_zeros(
                (delta,) + tuple(self.enc.shape[1:]))])
        self._free.extend(range(self.capacity, new_capacity))
        self.capacity = new_capacity
        self.stats.slot_grows += 1

    def grow_seq(self, new_max_seq: int) -> None:
        """Extend the sequence axis of full-length (non-ring) K/V leaves;
        written prefixes keep their positions. Stays seq-block aligned."""
        new_max_seq = self._align(new_max_seq)
        if new_max_seq <= self.max_seq:
            return
        delta = new_max_seq - self.max_seq
        for cls, c in self.caches["classes"].items():
            if cls == "local" and self.cfg.window > 0:
                continue
            for key in ("k", "v"):
                a = c[key]
                c[key] = torch.cat([a, a.new_zeros(
                    a.shape[:2] + (delta,) + tuple(a.shape[3:]))], dim=2)
        self.max_seq = new_max_seq
        self.stats.seq_grows += 1
