"""PQ ADC scans: the CUDA kernels' wrappers (twin of
``repro.kernels.pq_adc.ops``).

``pq_adc_topk`` is the staged per-shard unit (``core.chamvs.shard_search``
with ``fused=False``): ADC over a batch of probed list slices plus a
local top-k per entry. ``pq_shared_scan`` scans one shared code slab
against a batch of non-residual LUTs. A CPU tensor runs the plain
version; a CUDA tensor launches ``csrc/pq_adc.cu`` or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.pq_adc.ref import ref_pq_adc_topk, ref_shared_scan

_P, _I, _L = _build.P, _build.I, _build.L

#: the CUDA entry points; ``.launches`` counts launches
ADC_KERNEL = _build.Kernel("adc_scan_launch",
                           [_P, _L] + [_P] * 4 + [_I] * 6 + [_P])
SHARED_KERNEL = _build.Kernel("shared_scan_launch",
                              [_P] * 3 + [_I] * 7 + [_P])
MAX_K = 1792                    # queue slots left beside one round's buffer
QUEUE_BYTES = 2048 * 8          # adc_scan's queue: 2048 (dist, row) slots
MAX_TILE_Q = 8                  # shared_scan queries per block
SHARED_LUT_BYTES = 64 << 10     # one block's LUTs: three blocks share an SM
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
    dev = luts.device
    if luts.dim() != 3 or luts.shape[:2] != (B, m) or lens.shape != (B,):
        raise ValueError(f"pq_adc_topk shapes: luts {tuple(luts.shape)} "
                         f"codes {tuple(codes.shape)} lens "
                         f"{tuple(lens.shape)}")
    ksub = luts.shape[2]
    if not 1 <= k <= MAX_K or n >= 2 ** 31:
        raise ValueError(f"pq_adc_topk: k={k} (1..{MAX_K}), n={n} (< 2^31)")
    if luts.dtype != torch.float32 or luts.stride(2) != 1 or \
            luts.stride(1) != ksub or luts.device != dev:
        raise ValueError("luts must be float32 with contiguous [m, ksub] "
                         "blocks")
    if m * ksub * 4 + QUEUE_BYTES > SMEM_LIMIT:
        raise ValueError(f"pq_adc_topk: an m={m} x ksub={ksub} LUT does not "
                         "fit in shared memory")
    _check("codes", codes, torch.uint8, dev)
    _check("lens", lens, torch.int32, dev)
    out_d = torch.empty((B, k), device=dev, dtype=torch.float32)
    out_i = torch.empty((B, k), device=dev, dtype=torch.int32)
    ADC_KERNEL(luts.data_ptr(), luts.stride(0), codes.data_ptr(),
               lens.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), B, n, m,
               ksub, k, _vec(codes, m), _build.stream_ptr(luts))
    return out_d, out_i


def pq_shared_scan(luts: torch.Tensor, codes: torch.Tensor,
                   tile_n: Optional[int] = None,
                   spec: Optional[registry.KernelSpec] = None
                   ) -> torch.Tensor:
    """Batched-LUT shared scan: luts [q, m, ksub], codes [n, m] uint8 ->
    dists [n, q] float32 (the card takes float32 LUTs only).

    ``tile_n`` (else ``spec.tile_n``, else 8192) is the rows of one
    block's chunk; ``spec.tile_q`` caps the queries per block, which by
    default are as many LUTs as fit in 64 KB of shared memory (at most
    8)."""
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
    lut_bytes = m * ksub * 4
    tq = max(1, min(MAX_TILE_Q, q,
                    spec.tile_q or SHARED_LUT_BYTES // lut_bytes))
    if tq * lut_bytes > SMEM_LIMIT:
        raise ValueError(f"pq_shared_scan: {tq} LUTs of m={m} x ksub={ksub} "
                         "do not fit in shared memory")
    rows = max(tile_n or spec.tile_n or 8192, -(-n // 65535), 1)
    out = torch.empty((n, q), device=dev, dtype=torch.float32)
    SHARED_KERNEL(luts.data_ptr(), codes.data_ptr(), out.data_ptr(), n, q, m,
                  ksub, tq, rows, _vec(codes, m), _build.stream_ptr(luts))
    return out
