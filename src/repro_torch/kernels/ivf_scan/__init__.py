"""IVF probe: ``ops.ivf_index_scan`` is the wrapper (CUDA kernel on the
card, ``ref`` on the CPU)."""
from repro_torch.kernels.ivf_scan.ops import ivf_index_scan
from repro_torch.kernels.ivf_scan.ref import ref_ivf_scan

__all__ = ["ivf_index_scan", "ref_ivf_scan"]
