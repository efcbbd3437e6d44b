"""Plain PyTorch version of the fused ChamVS scan (twin of
``repro.kernels.chamvs_scan.ref``): gather-ADC -> padding mask -> one
exact top-kk per shard, ties to the earlier candidate in arrival order
(probe by probe, row by row)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.ivfpq import adc_scan_ref
from repro_torch.kernels.common import topk_smallest


def ref_chamvs_scan(luts: torch.Tensor, codes: torch.Tensor,
                    gids: torch.Tensor, lens: torch.Tensor, kk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """luts [nq,np,m,ksub], codes [S,nq,np,cap,m], gids [S,nq,np,cap],
    lens [S,nq,np] -> (dists [S,nq,kk], ids [S,nq,kk]) ascending."""
    S, nq, nprobe, cap, _ = codes.shape
    out_d, out_i = [], []
    for s in range(S):
        d = adc_scan_ref(luts, codes[s])                      # [nq, np, cap]
        valid = (torch.arange(cap, device=d.device)[None, None, :]
                 < lens[s][..., None])
        d = torch.where(valid, d, torch.full_like(d, float("inf")))
        dd, ii = topk_smallest(d.reshape(nq, nprobe * cap),
                               gids[s].reshape(nq, nprobe * cap), kk)
        out_d.append(dd)
        out_i.append(ii)
    return torch.stack(out_d), torch.stack(out_i)
