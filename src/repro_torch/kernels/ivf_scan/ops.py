"""IVF probe (ChamVS.idx): the CUDA kernel's wrapper.

A CPU tensor runs the plain version; a CUDA tensor launches the fused
centroid-scan + top-nprobe kernel of ``csrc/ivf_scan.cu`` or raises. The
reference's small-index fallback (``PALLAS_MIN_NLIST``) is gone: the
kernel runs at any ``nlist``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.ivf_scan.ref import ref_ivf_scan

_P, _I = _build.P, _build.I

#: the CUDA entry point; ``KERNEL.launches`` counts probe launches
KERNEL = _build.Kernel("ivf_scan_launch", [_P] * 4 + [_I] * 5 + [_P])
MAX_NPROBE = 128


def ivf_index_scan(queries: torch.Tensor, centroids: torch.Tensor,
                   nprobe: int,
                   spec: registry.KernelSpec = registry.DEFAULT
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [nq, D], centroids [nlist, D] -> (dists [nq, nprobe] f32,
    list ids [nq, nprobe] int32), ascending, ties to the lower id."""
    if not queries.is_cuda:
        if queries.device.type != "cpu":
            raise RuntimeError(f"ivf_index_scan: no kernel for "
                               f"{queries.device}")
        return ref_ivf_scan(queries, centroids, nprobe)
    nq, D = queries.shape
    nlist = centroids.shape[0]
    if centroids.shape[1] != D or not 1 <= nprobe <= MAX_NPROBE:
        raise ValueError(f"ivf_index_scan: queries {tuple(queries.shape)}, "
                         f"centroids {tuple(centroids.shape)}, "
                         f"nprobe {nprobe} (<= {MAX_NPROBE})")
    for name, t in (("queries", queries), ("centroids", centroids)):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != queries.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {queries.device}")
    out_d = torch.empty((nq, nprobe), device=queries.device,
                        dtype=torch.float32)
    out_i = torch.empty((nq, nprobe), device=queries.device,
                        dtype=torch.int32)
    KERNEL(queries.data_ptr(), centroids.data_ptr(), out_d.data_ptr(),
           out_i.data_ptr(), nq, nlist, D, nprobe, spec.pick_tile_q(nq),
           _build.stream_ptr(queries))
    return out_d, out_i
