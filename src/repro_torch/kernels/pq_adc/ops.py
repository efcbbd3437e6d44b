"""PQ ADC scans: the CUDA kernels' wrappers (twin of
``repro.kernels.pq_adc.ops``).

``probed_adc_topk`` is the staged per-shard unit
(``core.chamvs.shard_search`` with ``fused=False``): ADC over a shard's
probed lists, read in place, plus a local top-k per (query, probe)
entry. ``pq_adc_topk`` is the reference's signature of the same scan
over a gathered batch of list slices; both launch the one ``adc_scan``
kernel. ``pq_shared_scan`` scans one shared code slab against a batch of
non-residual LUTs. A CPU tensor runs the plain version; a CUDA tensor
launches ``csrc/pq_adc.cu`` or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.pq_adc.ref import ref_pq_adc_topk, ref_shared_scan

_P, _I, _L = _build.P, _build.I, _build.L

#: the CUDA entry points; ``.launches`` counts launches
ADC_KERNEL = _build.Kernel("adc_scan_launch",
                           [_P, _L, _L] + [_P] * 8 + [_I] * 8 + [_P])
SHARED_KERNEL = _build.Kernel("shared_scan_launch",
                              [_P] * 3 + [_I] * 7 + [_P])
MAX_K = 1792                    # as the fused scan's MAX_KK
QUEUE_BYTES = 4096 * 8          # adc_scan's largest queue: (dist, row) slots
MIN_CHUNK_ROWS = 4096           # adc_scan: the fewest rows a block takes
MAX_TILE_Q = 4                  # shared_scan queries per block: one 16-byte
                                # LUT load serves four
SHARED_BLOCKS_PER_SM = 4        # shared_scan's grid: about four blocks an SM
MIN_SHARED_ROWS = 4096          # shared_scan: the fewest rows a block takes
SMEM_LIMIT = 227 << 10          # shared memory a block may use on the H100


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise RuntimeError(f"{name}: no kernel for {t.device}")
    return True


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           dev: torch.device) -> None:
    if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{dev}")


def _vec(codes: torch.Tensor, m: int) -> int:
    """Whether every code row can be read as 16-byte vectors."""
    return int(m % 16 == 0 and codes.data_ptr() % 16 == 0)


def adc_chunk_rows(B: int, n: int, sms: int) -> int:
    """adc_scan's most rows a block: a full list of ``n`` rows spreads
    over enough blocks that all ``B`` full lists would fill the ``sms``
    SMs 8 blocks deep, but a block takes ``MIN_CHUNK_ROWS`` rows at
    least, so that its LUT load and merges stay a small share of it."""
    return max(1, min(n, max(MIN_CHUNK_ROWS, -(-n * B // (8 * sms)))))


def pq_adc_topk(luts: torch.Tensor, codes: torch.Tensor, lens: torch.Tensor,
                k: int, tile_n: Optional[int] = None,
                spec: Optional[registry.KernelSpec] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC + local top-k over a batch of probed list slices.

    luts [B, m, ksub] | codes [B, n, m] uint8 | lens [B] int32 ->
    (dists [B, k], row idx [B, k] int32) ascending, ties to the lower
    row, (+inf, -1) past ``lens``. Dists have the LUTs' dtype; the card
    takes float32 only.

    ``tile_n`` and ``spec`` are the reference's row-tile overrides. No
    row tile applies here: a block walks its entry's valid rows and stops
    at ``lens`` itself, so the codes need no padding and both are
    accepted for the reference's signature and not read."""
    del tile_n, spec
    if _on_cpu("pq_adc_topk", luts):
        return ref_pq_adc_topk(luts, codes, lens, k)
    B, n, m = codes.shape
    if luts.dim() != 3 or luts.shape[:2] != (B, m) or lens.shape != (B,):
        raise ValueError(f"pq_adc_topk shapes: luts {tuple(luts.shape)} "
                         f"codes {tuple(codes.shape)} lens "
                         f"{tuple(lens.shape)}")
    return _launch_adc(luts, luts.stride(0), 0, 1, codes, None, lens, k)


def probed_adc_topk(luts: torch.Tensor, codes: torch.Tensor,
                    list_len: torch.Tensor, probe_ids: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC + local top-k over a shard's probed lists, read in place.

    luts [nq, nprobe, m, ksub] (any strides over the first two axes: a
    non-residual index's stride-0 probe axis is read as one LUT per
    query) | codes [nlist, cap, m] uint8 | list_len [nlist] int32 |
    probe_ids [nq, nprobe] -> (dists [nq, nprobe, k], row idx
    [nq, nprobe, k] int32): entry (q, p) is ``pq_adc_topk`` over the
    first ``list_len[l]`` rows of list ``l = probe_ids[q, p]``. On the
    CPU it gathers the lists at those row bases and runs the plain
    version. The probe ids are trusted (< nlist), not checked on the
    device: the IVF probe makes them."""
    nq, nprobe = probe_ids.shape
    nlist, cap, m = codes.shape
    ksub = luts.shape[-1]
    if luts.dim() != 4 or luts.shape[:3] != (nq, nprobe, m) or \
            list_len.shape != (nlist,):
        raise ValueError(f"probed_adc_topk shapes: luts {tuple(luts.shape)} "
                         f"codes {tuple(codes.shape)} list_len "
                         f"{tuple(list_len.shape)} probe_ids "
                         f"{tuple(probe_ids.shape)}")
    if _on_cpu("probed_adc_topk", luts):
        lists = probe_ids.reshape(-1).long()
        rows = lists[:, None] * cap + torch.arange(cap)        # row bases
        d, i = ref_pq_adc_topk(luts.reshape(nq * nprobe, m, ksub),
                               codes.reshape(nlist * cap, m)[rows],
                               list_len[lists], k)
        return d.reshape(nq, nprobe, k), i.reshape(nq, nprobe, k)
    lists = probe_ids.to(device=luts.device, dtype=torch.int32).contiguous()
    d, i = _launch_adc(luts, luts.stride(0), luts.stride(1), nprobe, codes,
                       lists, list_len, k)
    return d.reshape(nq, nprobe, k), i.reshape(nq, nprobe, k)


def _launch_adc(luts, lut_qs, lut_ps, per_q, codes, lists, lens, k):
    """One adc_scan launch over B entries: entry b's LUT at
    ``lut_qs * (b // per_q) + lut_ps * (b % per_q)``, its list
    ``lists[b]`` (``b`` when None) of ``codes [*, n, m]``."""
    dev = luts.device
    n, m = codes.shape[1], codes.shape[2]
    ksub = luts.shape[-1]
    B = lists.numel() if lists is not None else codes.shape[0]
    if not 1 <= k <= MAX_K or n >= 2 ** 31:
        raise ValueError(f"adc_scan: k={k} (1..{MAX_K}), n={n} (< 2^31)")
    if luts.dtype != torch.float32 or luts.stride(-1) != 1 or \
            luts.stride(-2) != ksub or luts.device != dev:
        raise ValueError("luts must be float32 with contiguous [m, ksub] "
                         "blocks")
    if m * ksub * 4 + QUEUE_BYTES > SMEM_LIMIT:
        raise ValueError(f"adc_scan: an m={m} x ksub={ksub} LUT does not "
                         "fit in shared memory")
    _check("codes", codes, torch.uint8, dev)
    _check("lens", lens, torch.int32, dev)
    out_d = torch.empty((B, k), device=dev, dtype=torch.float32)
    out_i = torch.empty((B, k), device=dev, dtype=torch.int32)
    rows = adc_chunk_rows(B, n, _build.sm_count(dev))
    chunks = -(-n // rows)
    parts = B * chunks * k if chunks > 1 else 0
    part_d = torch.empty(parts, device=dev, dtype=torch.float32)
    part_a = torch.empty(parts, device=dev, dtype=torch.int32)
    counters = _build.merge_counters(ADC_KERNEL.symbol, luts, B)
    ADC_KERNEL(luts.data_ptr(), lut_qs, lut_ps, codes.data_ptr(),
               lists.data_ptr() if lists is not None else None,
               lens.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
               part_d.data_ptr(), part_a.data_ptr(), counters.data_ptr(), B,
               n, per_q, m, ksub, k, rows, _vec(codes, m),
               _build.stream_ptr(luts))
    return out_d, out_i


def shared_tile_q(q: int, m: int, ksub: int,
                  cap: Optional[int] = None) -> int:
    """shared_scan's queries per block: 4, 2 or 1 (the floats of one LUT
    load), halved while half of them would still cover all ``q`` queries,
    while above ``cap``, or while their LUTs would not fit in shared
    memory. Raises when one LUT does not fit."""
    lut_bytes = m * ksub * 4
    if lut_bytes > SMEM_LIMIT:
        raise ValueError(f"pq_shared_scan: an m={m} x ksub={ksub} LUT does "
                         "not fit in shared memory")
    tq = MAX_TILE_Q
    while tq > 1 and (tq // 2 >= q or (cap is not None and tq > cap)
                      or tq * lut_bytes > SMEM_LIMIT):
        tq //= 2
    return tq


def shared_rows(n: int, tiles: int, sms: int) -> int:
    """shared_scan's rows a block: the ``n`` rows cut into as many chunks
    as make ``tiles`` query tiles about ``SHARED_BLOCKS_PER_SM`` blocks on
    each of ``sms`` SMs, each at least ``MIN_SHARED_ROWS`` rows, and at
    most 65 535 chunks (the grid's y limit)."""
    chunks = max(1, min(n // MIN_SHARED_ROWS,
                        -(-SHARED_BLOCKS_PER_SM * sms // tiles)))
    return max(-(-n // chunks), -(-n // 65535), 1)


def pq_shared_scan(luts: torch.Tensor, codes: torch.Tensor,
                   tile_n: Optional[int] = None,
                   spec: Optional[registry.KernelSpec] = None
                   ) -> torch.Tensor:
    """Batched-LUT shared scan: luts [q, m, ksub], codes [n, m] uint8 ->
    dists [n, q] float32 (the card takes float32 LUTs only).

    ``tile_n`` (else ``spec.tile_n``, else ``shared_rows``) is the rows
    of one block's chunk; ``spec.tile_q`` caps the queries per block
    (``shared_tile_q``)."""
    spec = spec or registry.DEFAULT
    if _on_cpu("pq_shared_scan", luts):
        return ref_shared_scan(luts.float(), codes).T
    q, m, ksub = luts.shape
    n = codes.shape[0]
    dev = luts.device
    if codes.dim() != 2 or codes.shape[1] != m or n >= 2 ** 31:
        raise ValueError(f"pq_shared_scan shapes: luts {tuple(luts.shape)} "
                         f"codes {tuple(codes.shape)}")
    _check("luts", luts, torch.float32, dev)
    _check("codes", codes, torch.uint8, dev)
    tq = shared_tile_q(q, m, ksub, spec.tile_q)
    rows = tile_n or spec.tile_n or shared_rows(n, -(-q // tq),
                                                _build.sm_count(dev))
    rows = max(rows, -(-n // 65535), 1)
    out = torch.empty((n, q), device=dev, dtype=torch.float32)
    SHARED_KERNEL(luts.data_ptr(), codes.data_ptr(), out.data_ptr(), n, q, m,
                  ksub, tq, rows, _vec(codes, m), _build.stream_ptr(luts))
    return out
