"""Decode attention over a (slotted) KV cache: the CUDA kernel's wrapper.

``decode_attention`` is the single entry point. The device of ``q``
decides: a CPU tensor runs the plain version (crop to ``kv_len``, gather
the wave's pool rows, grouped attention); a CUDA tensor launches the
split-KV kernel of ``csrc/decode_attn.cu``, which reads the pool rows
through ``slots`` itself, or raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.decode_attn.ref import ref_decode_attention

_P, _I, _F = _build.P, _build.I, _build.F

#: the CUDA entry point; ``KERNEL.launches`` counts wave launches
KERNEL = _build.Kernel("decode_attn_launch",
                       [_P] * 9 + [_I] * 10 + [_F, _P])


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
    [W]; ``kv_len`` crops linear caches to their valid prefix. Returns
    [W, 1, H, D] in the cache dtype.

    Shapes, dtypes and layouts are checked on the host; the values of
    ``slots`` and ``position`` are not (that would cost a device sync
    per layer): they come from the KV pool, which hands out rows < P and
    grows its seq axis past every position."""
    if q.is_cuda:
        return _launch(q, k_cache, v_cache, position, window, ring, slots,
                       kv_len, spec)
    if q.device.type != "cpu":
        raise RuntimeError(f"decode_attention: no kernel for {q.device}")
    k, v = _gather_rows(q, k_cache, v_cache, slots, kv_len, ring)
    return ref_decode_attention(q, k, v, position, window=window, ring=ring)


def _launch(q, k_cache, v_cache, position, window, ring, slots, kv_len,
            spec):
    W, T, H, D = q.shape
    P, S_pool, KV, Dk = k_cache.shape
    if T != 1:
        raise ValueError(f"decode kernel takes one token per row, got T={T}")
    if Dk != D or v_cache.shape != k_cache.shape or H % KV:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} "
                         f"k {tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    G = H // KV
    if D not in (64, 128) or G > 8:
        raise ValueError(f"decode kernel supports D in (64, 128) and "
                         f"H/KV <= 8, got D={D}, G={G}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or \
                t.device != q.device:
            raise ValueError(f"{name} must be a contiguous bfloat16 tensor "
                             f"on {q.device}")
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
    split = spec.pick_block_seq(S)
    NS = S // split
    part_m = torch.empty((W, KV, NS, G), device=q.device, dtype=torch.float32)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((W, KV, NS, G, D), device=q.device,
                           dtype=torch.float32)
    out = torch.empty_like(q)
    KERNEL(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           slots.data_ptr(), pos.data_ptr(), part_m.data_ptr(),
           part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
           W, S_pool, S, KV, G, D, int(window), int(bool(ring)), split, NS,
           float(D ** -0.5), _build.stream_ptr(q))
    return out


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
