"""Row-wise k-smallest with the reference kernels' tie rule.

``repro.kernels.common.extract_topk_rows`` folds each new tile into a
running queue by row argmin over ``[queue, tile]``, the lower index
winning ties. The queue it leaves is therefore the first ``k`` of a
*stable* ascending sort of every candidate in arrival order, with
``+inf`` slots reported as id ``-1``. ``torch.topk`` promises no order
among equal values, so the plain versions sort stably and slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

#: devices whose tensors run a wrapper's plain version: the CPU computes
#: it; "meta" tensors carry no data, so the plain version only
#: propagates shapes and dtypes (the dry run's programs). A CUDA tensor
#: launches the kernel; any other device raises.
PLAIN_DEVICES = ("cpu", "meta")


def topk_smallest(d: torch.Tensor, i: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """d, i: [..., cand] in arrival order -> ([..., k], [..., k])
    ascending, ties to the earlier candidate, padded with (+inf, -1)
    when there are fewer than ``k`` candidates."""
    d_sorted, order = torch.sort(d, dim=-1, stable=True)
    keep = min(k, d.shape[-1])
    out_d = d_sorted[..., :keep]
    out_i = torch.gather(i, -1, order[..., :keep])
    if keep < k:
        pad = list(d.shape[:-1]) + [k - keep]
        out_d = torch.cat([out_d, torch.full(pad, float("inf"),
                                             dtype=d.dtype,
                                             device=d.device)], dim=-1)
        out_i = torch.cat([out_i, torch.full(pad, -1, dtype=i.dtype,
                                             device=i.device)], dim=-1)
    return out_d, torch.where(torch.isinf(out_d),
                              torch.full_like(out_i, -1), out_i)
