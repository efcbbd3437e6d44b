"""Approximate hierarchical top-k: ``ops.approx_topk`` is the wrapper
(CUDA level-1 kernel on the card, ``ref`` on the CPU)."""
from repro_torch.kernels.topk.ops import approx_topk
from repro_torch.kernels.topk.ref import ref_exact_topk, ref_hierarchical_topk

__all__ = ["approx_topk", "ref_exact_topk", "ref_hierarchical_topk"]
