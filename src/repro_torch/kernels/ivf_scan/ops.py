"""IVF probe (ChamVS.idx): the CUDA kernel's wrapper.

A CPU tensor runs the plain version; a CUDA tensor launches the fused
centroid-scan + top-nprobe kernel of ``csrc/ivf_scan.cu`` or raises. The
reference's small-index fallback (``PALLAS_MIN_NLIST``) is gone: the
kernel runs at any ``nlist``. The kernel splits the centroids between
``probe_grid`` blocks per query tile and merges their lists inside the
one launch (``merge_plan`` sizes the merge's scratch and counters).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.ivf_scan.ref import ref_ivf_scan

_P, _I = _build.P, _build.I

#: the CUDA entry point; ``KERNEL.launches`` counts probe launches
KERNEL = _build.Kernel("ivf_scan_launch", [_P] * 7 + [_I] * 10 + [_P])
MAX_NPROBE = 128
Q_TILES = (32, 16)  # queries per block, the first that fills the card
C_TILE = 32       # centroids per tile; a block takes a multiple of it
FAN_IN = 4        # lists that one merging block reads


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def probe_grid(nq: int, nlist: int, sms: int, tile_c: int = 0
               ) -> Tuple[int, int, int]:
    """(queries per block, centroids per block, blocks per query tile):
    enough blocks that two are resident on each of the ``sms`` SMs, and
    at least one ``C_TILE`` tile a block; 32 queries a block, or 16 when
    a grid of 32-query blocks would leave most SMs without a block.
    ``tile_c`` (rounded up to a whole tile) sets the centroids per block
    instead."""
    tiles = max(1, _cdiv(nlist, C_TILE))
    for tq in Q_TILES:
        q_tiles = _cdiv(nq, tq)
        if tile_c:
            per = _cdiv(tile_c, C_TILE)
        else:
            per = _cdiv(tiles * q_tiles, 2 * sms)
        per = max(1, min(per, tiles))
        splits = _cdiv(tiles, per)
        if 2 * q_tiles * splits >= sms:
            break
    return tq, per * C_TILE, splits


def merge_plan(splits: int, fan_in: int = FAN_IN) -> Tuple[int, int]:
    """(scratch lists, counters) per query tile of the in-kernel merge: a
    tree in which the last block of every ``fan_in`` lists merges them,
    level by level, until one list is left."""
    slots = counters = 0
    n = splits
    while n > 1:
        slots += n
        n = _cdiv(n, fan_in)
        counters += n
    return slots, counters


def ivf_index_scan(queries: torch.Tensor, centroids: torch.Tensor,
                   nprobe: int,
                   spec: registry.KernelSpec = registry.DEFAULT
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [nq, D], centroids [nlist, D] -> (dists [nq, nprobe] f32,
    list ids [nq, nprobe] int32), ascending, ties to the lower id.

    ``spec.tile_c`` overrides the centroids per block (``probe_grid``)."""
    if not queries.is_cuda:
        if queries.device.type != "cpu":
            raise RuntimeError(f"ivf_index_scan: no kernel for "
                               f"{queries.device}")
        return ref_ivf_scan(queries, centroids, nprobe)
    nq, D = queries.shape
    nlist = centroids.shape[0]
    if centroids.shape[1] != D or not 1 <= nprobe <= MAX_NPROBE or \
            D % 4:
        raise ValueError(f"ivf_index_scan: queries {tuple(queries.shape)}, "
                         f"centroids {tuple(centroids.shape)} (D % 4 == 0), "
                         f"nprobe {nprobe} (<= {MAX_NPROBE})")
    for name, t in (("queries", queries), ("centroids", centroids)):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != queries.device or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"float32 tensor on {queries.device}")
    dev = queries.device
    out_d = torch.empty((nq, nprobe), device=dev, dtype=torch.float32)
    out_i = torch.empty((nq, nprobe), device=dev, dtype=torch.int32)
    tq, per_block, splits = probe_grid(nq, nlist, _build.sm_count(dev),
                                       spec.tile_c or 0)
    slots, n_counters = merge_plan(splits, FAN_IN)
    q_tiles = _cdiv(nq, tq)
    parts = q_tiles * slots * tq * nprobe
    part_d = torch.empty(parts, device=dev, dtype=torch.float32)
    part_a = torch.empty(parts, device=dev, dtype=torch.int32)
    counters = _build.merge_counters(KERNEL.symbol, queries,
                                     q_tiles * n_counters)
    KERNEL(queries.data_ptr(), centroids.data_ptr(), out_d.data_ptr(),
           out_i.data_ptr(), part_d.data_ptr(), part_a.data_ptr(),
           counters.data_ptr(), nq, nlist, D, nprobe, tq, per_block,
           splits, FAN_IN, slots, n_counters, _build.stream_ptr(queries))
    return out_d, out_i
