"""Qwen2-VL-72B — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

The vision frontend is a stub in the reference too: it hands precomputed
patch embeddings and M-RoPE position streams to the backbone, which
``transformer.lm_loss`` takes as a batch's ``embeds`` and [3, B, T]
``positions``. The port serves the backbone on text, whose three M-RoPE
streams are equal."""
from repro_torch.configs import (ArchSpec, FULL_ATTENTION_SKIP, reduce_cfg,
                                 register)
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, d_head=128, qkv_bias=True,
    rope_mode="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    frontend="vision")

REDUCED = reduce_cfg(CONFIG, mrope_sections=(2, 3, 3))

register(ArchSpec(
    name="qwen2_vl_72b", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="knnlm", interval=1, k=100),
    source="arXiv:2409.12191; hf",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
