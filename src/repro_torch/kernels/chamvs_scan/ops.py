"""Fused ChamVS scan: the CUDA kernel's wrapper and the shard-stack
frontend.

``fused_scan`` takes the stacked shard tables and the probe ids. A CPU
tensor runs the plain version on the reference's gathered
``[S, nq, nprobe, cap, m]`` copy of the probed lists (a meta tensor
too, propagating shapes only); a CUDA tensor
launches ``csrc/chamvs_scan.cu``, which indexes the probed lists itself
and splits each (shard, query)'s rows between ``scan_groups`` blocks
whose top-kk lists it merges inside the one launch, or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chamvs_scan.ref import ref_chamvs_scan
from repro_torch.kernels.common import PLAIN_DEVICES

_P, _I, _L = _build.P, _build.I, _build.L

#: the CUDA entry point; ``KERNEL.launches`` counts scan launches
KERNEL = _build.Kernel("chamvs_scan_launch",
                       [_P, _L, _L] + [_P] * 9 + [_I] * 9 + [_P])
MAX_KK = 1792


def scan_groups(S: int, nq: int, nprobe: int, cap: int, kk: int,
                sms: int) -> int:
    """Blocks that share each (shard, query)'s probed rows: enough for two
    resident blocks on each of the ``sms`` SMs, but no more than leave a
    block ~4 K rows when the lists are full, and no more than make the
    in-kernel merge offer ~16 K partial entries."""
    return max(1, min(2 * sms // (S * nq), nprobe * cap // 4096,
                      16384 // kk))


def fused_scan(luts: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor,
               lens: torch.Tensor, probe_ids: torch.Tensor, kk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC + running top-kk over every shard's probed lists.

    luts [nq, np, m, ksub] f32 | codes [S, nlist, cap, m] uint8 |
    ids [S, nlist, cap] int32 | lens [S, nlist] int32 |
    probe_ids [nq, np] -> (dists [S, nq, kk] f32, global ids
    [S, nq, kk] int32) ascending, -1 where there are fewer than kk.

    The index values (probe ids < nlist, lens <= cap) are trusted, not
    checked on the device: the IVF probe and ``build_shards`` make them."""
    if not luts.is_cuda:
        if luts.device.type not in PLAIN_DEVICES:
            raise RuntimeError(f"fused_scan: no kernel for {luts.device}")
        p = probe_ids.long()
        return ref_chamvs_scan(luts, codes[:, p], ids[:, p], lens[:, p], kk)
    return _launch(luts, codes, ids, lens, probe_ids, kk)


def _launch(luts, codes, ids, lens, probe_ids, kk):
    S, nlist, cap, m = codes.shape
    nq, nprobe, m_l, ksub = luts.shape
    dev = luts.device
    if m_l != m or ids.shape != (S, nlist, cap) or lens.shape != (S, nlist) \
            or probe_ids.shape != (nq, nprobe):
        raise ValueError(
            f"fused_scan shapes: luts {tuple(luts.shape)} codes "
            f"{tuple(codes.shape)} ids {tuple(ids.shape)} lens "
            f"{tuple(lens.shape)} probe_ids {tuple(probe_ids.shape)}")
    if not 1 <= kk <= MAX_KK or nprobe * cap >= 2 ** 31:
        raise ValueError(f"fused_scan: kk={kk} (<= {MAX_KK}), "
                         f"nprobe*cap={nprobe * cap} (< 2^31)")
    if luts.dtype != torch.float32 or luts.stride(3) != 1 or \
            luts.stride(2) != ksub:
        raise ValueError("luts must be float32 with contiguous [m, ksub] "
                         "blocks")
    for name, t, dt in (("codes", codes, torch.uint8),
                        ("ids", ids, torch.int32),
                        ("lens", lens, torch.int32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}")
    probe = probe_ids.to(device=dev, dtype=torch.int32).contiguous()
    out_d = torch.empty((S, nq, kk), device=dev, dtype=torch.float32)
    out_i = torch.empty((S, nq, kk), device=dev, dtype=torch.int32)
    groups = scan_groups(S, nq, nprobe, cap, kk, _build.sm_count(dev))
    parts = S * nq * kk * groups if groups > 1 else 0
    part_d = torch.empty(parts, device=dev, dtype=torch.float32)
    part_a = torch.empty(parts, device=dev, dtype=torch.int32)
    counters = _build.merge_counters(KERNEL.symbol, luts, S * nq)
    KERNEL(luts.data_ptr(), luts.stride(0), luts.stride(1),
           codes.data_ptr(), ids.data_ptr(), lens.data_ptr(),
           probe.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
           part_d.data_ptr(), part_a.data_ptr(), counters.data_ptr(), S, nq,
           nprobe, nlist, cap, m, ksub, kk, groups, _build.stream_ptr(luts))
    return out_d, out_i


def fused_shard_scan(params, stacked, queries: torch.Tensor,
                     probe_ids: torch.Tensor, cfg, kk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LUTs + one fused scan over a ``stack_shards``-packed stack.

    params: IVFPQParams | stacked: IVFPQShard with a leading [S] axis |
    queries [nq, D] | probe_ids [nq, np] -> (dists [S, nq, kk], global
    ids [S, nq, kk])."""
    from repro_torch.core import ivfpq
    luts = ivfpq.compute_luts(params, queries, probe_ids, cfg.ivfpq)
    return fused_scan(luts, stacked.codes, stacked.ids, stacked.list_len,
                      probe_ids, kk)
