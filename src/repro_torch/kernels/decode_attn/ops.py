"""Decode attention over a (slotted) KV cache: the CUDA kernel's wrapper.

``decode_attention`` is the single entry point. The device of ``q``
decides: a CPU tensor runs the plain version (crop to ``kv_len``, gather
the wave's pool rows, grouped attention), and so does a meta tensor,
which only propagates shapes; a CUDA tensor launches the
split-KV kernel of ``csrc/decode_attn.cu``, which reads the pool rows
through ``slots`` itself and merges its splits inside the one launch, or
raises.

``decode_attention_partial`` is the same kernel's partial mode, for a
cache that holds one rank's slot range of a cache split over ranks (a
linear cache, or a ring, with or without a window): it returns the
range's float32 (acc, m, l), which the caller merges across ranks
(``ref.merge_partials``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.common import PLAIN_DEVICES
from repro_torch.kernels.decode_attn.ref import (
    ref_decode_attention, ref_decode_attention_partial)

_P, _I, _F = _build.P, _build.I, _build.F

#: the CUDA entry point; ``KERNEL.launches`` counts wave launches
KERNEL = _build.Kernel("decode_attn_launch",
                       [_P] * 10 + [_I] * 10 + [_F, _P])
#: the partial mode's entry point; ``PARTIAL_KERNEL.launches`` counts its
#: launches, ``mode_launches`` those over a "ring" and a "linear" cache
PARTIAL_KERNEL = _build.Kernel("decode_attn_partial_launch",
                               [_P] * 12 + [_I] * 12 + [_F, _P])
TILE = 32          # slots the kernel stages at a time (kTile)
HEAD_DIMS = (16, 64, 96, 128, 256)   # the instances the kernel has
MAX_G = 16         # query heads a KV head, at most
SMEM_PER_SM = 228 * 1024


def _gather_rows(q, k_cache, v_cache, slots, kv_len, ring):
    """The plain version's view of the cache: crop linear caches to
    ``kv_len`` first, then copy the wave's rows out of the pool (the
    reference's order, ``transformer.py:218-225``)."""
    k, v = k_cache, v_cache
    if kv_len is not None and not ring and kv_len < k.shape[1]:
        k, v = k[:, :kv_len], v[:, :kv_len]
    if slots is not None:
        idx = slots.long()
        k, v = k[idx], v[idx]
    return k, v


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, position: torch.Tensor,
                     window: int = 0, ring: bool = False,
                     slots: Optional[torch.Tensor] = None,
                     kv_len: Optional[int] = None,
                     spec: registry.KernelSpec = registry.DEFAULT
                     ) -> torch.Tensor:
    """One-token decode for a whole wave.

    q [W, 1, H, D]; caches [P, S, KV, D] — pool rows, of which wave row
    ``w`` reads row ``slots[w]`` (``slots=None``: row ``w``); position
    [W]; ``kv_len`` crops linear caches to their valid prefix;
    ``spec.tile_n`` sets the CUDA kernel's slots per block (by default
    ``pick_split`` chooses). Returns [W, 1, H, D] in the cache dtype.

    Shapes, dtypes and layouts are checked on the host; the values of
    ``slots`` and ``position`` are not (that would cost a device sync
    per layer): they come from the KV pool, which hands out rows < P and
    grows its seq axis past every position."""
    if q.is_cuda:
        return _launch(q, k_cache, v_cache, position, window, ring, slots,
                       kv_len, spec)
    if q.device.type not in PLAIN_DEVICES:
        raise RuntimeError(f"decode_attention: no kernel for {q.device}")
    k, v = _gather_rows(q, k_cache, v_cache, slots, kv_len, ring)
    return ref_decode_attention(q, k, v, position, window=window, ring=ring)


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, position: torch.Tensor,
                             slot_offset: int = 0, window: int = 0,
                             ring_size: Optional[int] = None,
                             spec: registry.KernelSpec = registry.DEFAULT):
    """One decode token's attention over one rank's slot range of a cache
    split over ranks: q [W, 1, H, D]; caches [W, S, KV, D] whose slot
    ``i`` is global slot ``slot_offset + i``; position [W] absolute.
    Linear caches (``ring_size=None``) hold that position there; a ring
    of ``ring_size`` slots in all holds ``pos - ((pos - g) mod
    ring_size)`` at global slot ``g``. ``window`` also rejects positions
    ``<= pos - window``. Returns float32 (acc [W, H, D], m [W, H],
    l [W, H]); a row with no valid slot in the range gives l = 0,
    acc = 0 and a finite m."""
    if q.is_cuda:
        return _launch_partial(q, k_cache, v_cache, position,
                               int(slot_offset), int(window), ring_size,
                               spec)
    if q.device.type not in PLAIN_DEVICES:
        raise RuntimeError(f"decode_attention_partial: no kernel for "
                           f"{q.device}")
    return ref_decode_attention_partial(q, k_cache, v_cache, position,
                                        slot_offset, window, ring_size)


def pick_split(W: int, KV: int, S: int, sms: int,
               tile_n: Optional[int] = None, blocks_per_sm: int = 8) -> int:
    """Slots per block of the CUDA kernel: ``tile_n`` when the spec sets
    it, else ``S`` cut into as many splits of whole 32-slot tiles as give
    the grid of ``W * KV * splits`` blocks about ``blocks_per_sm`` blocks
    on each of the ``sms`` SMs, which all fit on the card at once (one
    wave). The split need not divide ``S``: the kernel masks the ragged
    last one (a ring of 1024 slots cut in 3 gives splits of 352, 352 and
    320)."""
    if tile_n is not None:
        return max(1, int(tile_n))
    tiles = -(-S // TILE)
    splits = max(1, min(tiles, round(blocks_per_sm * sms / max(1, W * KV))))
    return TILE * -(-tiles // splits)


def resident_blocks(D: int, G: int) -> int:
    """Blocks of the kernel's instance for (D, G) that one SM's shared
    memory holds at once, at most 8: the instance's dynamic shared memory
    (``Shape::kSmem`` in ``csrc/decode_attn.cu``: two stages of 32-slot K
    and V tiles, or the [J, GM, D] float32 P.V reduction buffer when that
    is larger), its static score and softmax arrays, and the 1 KB the
    card reserves a block, against 228 KB an SM. 8 at D 64, 6 at D 128,
    3 at D 256."""
    gm = 1 << max(0, G - 1).bit_length()
    j = 128 // (D // 2)
    dyn = max(4 * TILE * D * 2, j * gm * D * 4)
    static = gm * (TILE + 3) * 4 + 4
    return max(1, min(8, SMEM_PER_SM // (dyn + static + 1024)))


def _prepare(q, k_cache, v_cache, position, ring, slots, kv_len, spec):
    """The checked launch geometry shared by both modes: (W, H, D, KV, G,
    S_pool, S, slots, pos, split, NS) and the splits' scratch (part_m,
    part_l, part_acc)."""
    W, T, H, D = q.shape
    P, S_pool, KV, Dk = k_cache.shape
    if T != 1:
        raise ValueError(f"decode kernel takes one token per row, got T={T}")
    if Dk != D or v_cache.shape != k_cache.shape or H % KV:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} "
                         f"k {tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    G = H // KV
    if D not in HEAD_DIMS or G > MAX_G:
        raise ValueError(f"decode kernel supports D in {HEAD_DIMS} and "
                         f"H/KV <= {MAX_G}, got D={D}, G={G}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or \
                t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"bfloat16 tensor on {q.device}")
    S = S_pool
    if kv_len is not None and not ring and kv_len < S_pool:
        S = int(kv_len)
    if slots is None:
        if P < W:
            raise ValueError(f"cache holds {P} rows for a wave of {W}")
        slots = torch.arange(W, device=q.device, dtype=torch.int32)
    slots = slots.to(device=q.device, dtype=torch.int32).contiguous()
    pos = position.to(device=q.device, dtype=torch.int32).contiguous()
    if slots.shape != (W,) or pos.shape != (W,):
        raise ValueError("slots and position must be [W]")
    split = pick_split(W, KV, S, _build.sm_count(q.device), spec.tile_n,
                       resident_blocks(D, G))
    NS = -(-S // split)
    part_m = torch.empty((W, KV, NS, G), device=q.device, dtype=torch.float32)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((W, KV, NS, G, D), device=q.device,
                           dtype=torch.float32)
    return (W, H, D, KV, G, S_pool, S, slots, pos, split, NS, part_m,
            part_l, part_acc)


def _launch(q, k_cache, v_cache, position, window, ring, slots, kv_len,
            spec):
    (W, H, D, KV, G, S_pool, S, slots, pos, split, NS, part_m, part_l,
     part_acc) = _prepare(q, k_cache, v_cache, position, ring, slots, kv_len,
                          spec)
    counters = _build.merge_counters(KERNEL.symbol, q, W * KV)
    out = torch.empty_like(q)
    KERNEL(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           slots.data_ptr(), pos.data_ptr(), part_m.data_ptr(),
           part_l.data_ptr(), part_acc.data_ptr(), counters.data_ptr(),
           out.data_ptr(), W, S_pool, S, KV, G, D, int(window),
           int(bool(ring)), split, NS, float(D ** -0.5),
           _build.stream_ptr(q))
    return out


def _launch_partial(q, k_cache, v_cache, position, slot_offset, window,
                    ring_size, spec):
    ring = ring_size is not None
    (W, H, D, KV, G, S_pool, S, slots, pos, split, NS, part_m, part_l,
     part_acc) = _prepare(q, k_cache, v_cache, position, ring, None, None,
                          spec)
    if ring and not slot_offset + S <= ring_size:
        raise ValueError(f"slots {slot_offset}..{slot_offset + S - 1} lie "
                         f"outside a ring of {ring_size}")
    counters = _build.merge_counters(PARTIAL_KERNEL.symbol, q, W * KV)
    out_m = torch.empty((W, H), device=q.device, dtype=torch.float32)
    out_l = torch.empty_like(out_m)
    out_acc = torch.empty((W, H, D), device=q.device, dtype=torch.float32)
    PARTIAL_KERNEL(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                   slots.data_ptr(), pos.data_ptr(), part_m.data_ptr(),
                   part_l.data_ptr(), part_acc.data_ptr(),
                   counters.data_ptr(), out_m.data_ptr(), out_l.data_ptr(),
                   out_acc.data_ptr(), W, S_pool, S, KV, G, D, slot_offset,
                   window, int(ring), int(ring_size) if ring else 0, split,
                   NS, float(D ** -0.5), _build.stream_ptr(q),
                   mode="ring" if ring else "linear")
    return out_acc, out_m, out_l


def count_skipped_blocks(positions: np.ndarray, S: int, blk: int,
                         tile_b: int, window: int = 0, ring: bool = False
                         ) -> tuple:
    """Host-side replica of the reference kernel's tile-level skip
    predicate: ``(blocks_skipped, blocks_total)`` over its whole grid.
    The CUDA kernel skips at least these (it visits only each row's own
    valid slot range)."""
    pos = np.asarray(positions).reshape(-1)
    if pos.shape[0] % tile_b or S % blk:
        raise ValueError(f"tile_b={tile_b} must divide {pos.shape[0]} rows "
                         f"and blk={blk} must divide S={S}")
    nb = S // blk
    skipped = total = 0
    for t in range(pos.shape[0] // tile_b):
        tile = pos[t * tile_b:(t + 1) * tile_b]
        for j in range(nb):
            start = j * blk
            live = start <= tile.max()
            if window > 0 and not ring:
                live = live and (start + blk - 1 > tile.min() - window)
            total += 1
            skipped += 0 if live else 1
    return skipped, total
