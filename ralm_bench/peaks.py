"""Published peaks of the cards the benchmark reads rooflines against
(NVIDIA's data sheet, SXM part, dense rates, at the full 700 W power
limit). A card not in the table gets no roofline and no MFU."""
from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_flops=989e12, f32_flops=67e12,
                                  hbm_bytes_per_s=3.35e12),
}


def peaks(kind: Optional[str]) -> Optional[dict]:
    return PEAKS.get(kind) if kind else None


def least_seconds(nbytes: float, f32_flops: float, peak: dict) -> float:
    """The least time the card could take to move ``nbytes`` and do
    ``f32_flops`` float32 operations (the kernel table's ``bound``)."""
    return max(nbytes / peak["hbm_bytes_per_s"],
               f32_flops / peak["f32_flops"])
