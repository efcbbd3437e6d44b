"""Approximate hierarchical top-k: the CUDA kernels' wrapper (twin of
``repro.kernels.topk.ops``).

A CPU tensor runs the plain versions; a CUDA tensor calls
``csrc/topk.cu`` once — the level-1 kernel (each column block keeps its
k' smallest) and the level-2 kernel (the exact merge of the survivors)
on one stream — or raises.

Degenerate tilings (``n % num_blocks != 0`` or blocks shorter than k')
get the exact top-k, as in the reference. On the card that is the same
level-1 kernel with one block per row and k' = k, so there is no route
to a plain version and nothing to count or warn about.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.approx_topk_math import truncated_queue_len
from repro_torch.kernels import _build
from repro_torch.kernels.topk.ref import ref_exact_topk, ref_hierarchical_topk

_P, _I, _L = _build.P, _build.I, _build.L

#: the CUDA entry point; ``KERNEL.launches`` counts its calls (each one
#: level-1 launch, plus the level-2 launch when num_blocks > 1)
KERNEL = _build.Kernel("hierarchical_topk_launch",
                       [_P, _L] + [_P] * 4 + [_I] * 5 + [_P])
MAX_K = 1024                    # queue slots left beside one round's buffer


def approx_topk(d: torch.Tensor, k: int, num_blocks: int = 16,
                k_prime: Optional[int] = None, eps: float = 0.01
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row with truncated level-1 queues (paper §4.2.2).

    d [B, n] f32 (+inf = invalid) -> (dists [B, k], idx [B, k] int32)
    ascending, ties to the lower column, -1 on +inf slots. ``k_prime``
    None sizes k' by the paper's binomial bound, so that at most ``eps``
    of rows differ from the exact top-k; ``num_blocks`` is the number of
    level-1 producers per row."""
    B, n = d.shape
    if k_prime is None:
        k_prime = truncated_queue_len(k, num_blocks, eps)
    k_prime = min(max(k_prime, 1), k)
    degenerate = n % num_blocks != 0 or n // num_blocks < k_prime
    if not d.is_cuda:
        if d.device.type != "cpu":
            raise RuntimeError(f"approx_topk: no kernel for {d.device}")
        if degenerate:
            return ref_exact_topk(d, k)
        return ref_hierarchical_topk(d, k, num_blocks, k_prime)
    if degenerate:
        num_blocks, k_prime = 1, k
    if d.dtype != torch.float32 or d.stride(1) != 1:
        raise ValueError("d must be float32 with contiguous rows")
    if not (1 <= k_prime <= MAX_K and k <= MAX_K) or n >= 2 ** 31:
        raise ValueError(f"approx_topk: k={k}, k'={k_prime} (1..{MAX_K}), "
                         f"n={n} (< 2^31)")
    out_d = torch.empty((B, k), device=d.device, dtype=torch.float32)
    out_i = torch.empty((B, k), device=d.device, dtype=torch.int32)
    if num_blocks == 1:                     # level 1 is the whole answer
        l1_d, l1_i = out_d, out_i
    else:
        l1_d = torch.empty((B, num_blocks, k_prime), device=d.device,
                           dtype=torch.float32)
        l1_i = torch.empty_like(l1_d, dtype=torch.int32)
    KERNEL(d.data_ptr(), d.stride(0), l1_d.data_ptr(), l1_i.data_ptr(),
           out_d.data_ptr(), out_i.data_ptr(), B, num_blocks,
           n // num_blocks, k_prime, k, _build.stream_ptr(d))
    return out_d, out_i
