"""Plain PyTorch version of the IVF probe (twin of
``repro.kernels.ivf_scan.ref``): distances to every coarse centroid, then
the nprobe smallest with ties to the lower centroid id."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.kmeans import _pairwise_sq_l2
from repro_torch.kernels.common import topk_smallest


def ref_ivf_scan(queries: torch.Tensor, centroids: torch.Tensor,
                 nprobe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [nq, D], centroids [nlist, D] -> (dists [nq, nprobe] f32,
    list ids [nq, nprobe] int32) ascending."""
    d = _pairwise_sq_l2(queries.float(), centroids.float())
    ids = torch.arange(d.shape[1], device=d.device,
                       dtype=torch.int32).expand_as(d)
    return topk_smallest(d, ids, nprobe)
