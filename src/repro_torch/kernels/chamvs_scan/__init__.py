"""Fused ChamVS scan: ``ops.fused_scan`` is the wrapper (CUDA kernel on
the card, ``ref`` on the CPU); ``ops.fused_shard_scan`` the frontend."""
from repro_torch.kernels.chamvs_scan.ops import fused_scan, fused_shard_scan
from repro_torch.kernels.chamvs_scan.ref import ref_chamvs_scan

__all__ = ["fused_scan", "fused_shard_scan", "ref_chamvs_scan"]
