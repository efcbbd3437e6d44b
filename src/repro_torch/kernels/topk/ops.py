"""Approximate hierarchical top-k: the CUDA kernel's wrapper (twin of
``repro.kernels.topk.ops``).

A CPU tensor runs the plain versions (a meta tensor too, propagating
shapes only); a CUDA tensor makes one launch of
``csrc/topk.cu`` — level 1 (each column block keeps its k' smallest) and
level 2 (the exact merge of the survivors) in the same kernel — or
raises.

Degenerate tilings (``n % num_blocks != 0`` or blocks shorter than k')
get the exact top-k, as in the reference. On the card that is the same
kernel with one column block per row and k' = k, so there is no route
to a plain version and nothing to count or warn about.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.approx_topk_math import truncated_queue_len
from repro_torch.kernels import _build
from repro_torch.kernels.common import PLAIN_DEVICES
from repro_torch.kernels.topk.ref import ref_exact_topk, ref_hierarchical_topk

_P, _I, _L = _build.P, _build.I, _build.L

#: the CUDA entry point; ``KERNEL.launches`` counts its launches (one a
#: call: both levels run in one kernel)
KERNEL = _build.Kernel("hierarchical_topk_launch",
                       [_P, _L] + [_P] * 7 + [_I] * 7 + [_P])
MAX_K = 1024                    # queue slots left beside one round's buffer
WARP_MAX_K = 128                # k above this takes the shared queue path
BLOCKS_PER_SM = 3               # the pieces' grid: about 3 blocks an SM
MIN_PIECE_COLS = 4096           # the fewest columns a piece takes


def topk_pieces(B: int, num_blocks: int, tile: int, k: int, sms: int) -> int:
    """Blocks per column block: the fewest that give the ``B *
    num_blocks`` column blocks ``BLOCKS_PER_SM`` blocks on each of
    ``sms`` SMs (five fit an SM; every piece past the first adds a merge,
    and more pieces measured slower), each piece at least
    ``MIN_PIECE_COLS`` of the ``tile`` columns; 1 when k > ``WARP_MAX_K``
    (the shared queue path takes whole column blocks)."""
    if k > WARP_MAX_K:
        return 1
    want = -(-BLOCKS_PER_SM * sms // max(B * num_blocks, 1))
    return max(1, min(want, tile // MIN_PIECE_COLS))


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
        if d.device.type not in PLAIN_DEVICES:
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
    dev = d.device
    tile = n // num_blocks
    pieces = topk_pieces(B, num_blocks, tile, k, _build.sm_count(dev))
    vec = int(d.data_ptr() % 16 == 0 and d.stride(0) % 4 == 0
              and tile % 4 == 0)
    out_d = torch.empty((B, k), device=dev, dtype=torch.float32)
    out_i = torch.empty((B, k), device=dev, dtype=torch.int32)
    n_part = B * num_blocks * pieces * k_prime if pieces > 1 else 0
    n_l1 = B * num_blocks * k_prime if num_blocks > 1 else 0
    part_d = torch.empty(n_part, device=dev, dtype=torch.float32)
    part_a = torch.empty(n_part, device=dev, dtype=torch.int32)
    l1_d = torch.empty(n_l1, device=dev, dtype=torch.float32)
    l1_a = torch.empty(n_l1, device=dev, dtype=torch.int32)
    counters = _build.merge_counters(KERNEL.symbol, d, B * num_blocks + B)
    KERNEL(d.data_ptr(), d.stride(0), part_d.data_ptr(), part_a.data_ptr(),
           l1_d.data_ptr(), l1_a.data_ptr(), out_d.data_ptr(),
           out_i.data_ptr(), counters.data_ptr(), B, num_blocks, tile,
           pieces, k_prime, k, vec, _build.stream_ptr(d))
    return out_d, out_i
