"""Plain PyTorch versions of the PQ ADC scans (twin of
``repro.kernels.pq_adc.ref``).

``dist[n] = sum_j lut[j, codes[n, j]]``: each code byte addresses its
sub-space's LUT row, and the m terms are summed in index order 0..m-1,
the CUDA kernels' order, so kernel and plain version agree bit for bit
in float32. The reference sums in XLA's order (within 1e-5 relative).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.ivfpq import adc_scan_ref
from repro_torch.kernels.common import topk_smallest


def ref_adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut [..., m, ksub], codes [..., n, m] integer -> [..., n]
    distances (the reference's [m, ksub], [n, m] -> [n], batched)."""
    return adc_scan_ref(lut, codes)


def ref_adc_batch(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts [b, m, ksub], codes [b, n, m] -> [b, n]."""
    return adc_scan_ref(luts, codes)


def ref_adc_topk(lut: torch.Tensor, codes: torch.Tensor, valid: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC + exact top-k: lut [..., m, ksub], codes [..., n, m], valid
    [..., n] bool (the padding mask) -> (dists [..., k], row idx
    [..., k] int32) ascending, ties to the lower row, (+inf, -1) past
    the valid rows."""
    d = ref_adc(lut, codes)
    d = torch.where(valid, d, torch.full_like(d, float("inf")))
    rows = torch.arange(d.shape[-1], device=d.device, dtype=torch.int32)
    return topk_smallest(d, rows.expand_as(d), k)


def ref_pq_adc_topk(luts: torch.Tensor, codes: torch.Tensor,
                    lens: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``ops.pq_adc_topk``: luts [B, m, ksub],
    codes [B, n, m], lens [B] (valid prefix of each entry) ->
    (dists [B, k], row idx [B, k])."""
    rows = torch.arange(codes.shape[1], device=codes.device)
    return ref_adc_topk(luts, codes, rows < lens.to(codes.device)[:, None],
                        k)


def ref_shared_scan(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts [q, m, ksub] (one LUT per query, non-residual PQ), codes
    [n, m] (one slab shared by every query) -> dists [q, n]."""
    q = luts.shape[0]
    return adc_scan_ref(luts, codes.expand(q, *codes.shape))
