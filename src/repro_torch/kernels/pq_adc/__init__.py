"""PQ ADC scans: ``ops.pq_adc_topk`` (the staged per-shard scan) and
``ops.pq_shared_scan`` are the wrappers (CUDA kernels on the card,
``ref`` on the CPU)."""
from repro_torch.kernels.pq_adc.ops import pq_adc_topk, pq_shared_scan
from repro_torch.kernels.pq_adc.ref import (ref_adc, ref_adc_batch,
                                            ref_adc_topk, ref_pq_adc_topk,
                                            ref_shared_scan)

__all__ = ["pq_adc_topk", "pq_shared_scan", "ref_adc", "ref_adc_batch",
           "ref_adc_topk", "ref_pq_adc_topk", "ref_shared_scan"]
