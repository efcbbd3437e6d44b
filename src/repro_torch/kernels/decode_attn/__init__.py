"""Decode attention over a slotted KV cache: ``ops.decode_attention`` is
the wrapper (CUDA kernel on the card, ``ref`` on the CPU)."""
from repro_torch.kernels.decode_attn.ops import (count_skipped_blocks,
                                                 decode_attention)
from repro_torch.kernels.decode_attn.ref import ref_decode_attention

__all__ = ["count_skipped_blocks", "decode_attention", "ref_decode_attention"]
