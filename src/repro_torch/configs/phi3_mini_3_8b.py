"""Phi-3-mini-3.8B — RoPE SwiGLU, MHA (kv=32) [arXiv:2404.14219; unverified]."""
from repro_torch.configs import (ArchSpec, FULL_ATTENTION_SKIP, reduce_cfg,
                                 register)
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", n_layers=32, d_model=3072, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab_size=32064, d_head=96, rope_theta=1e4)

REDUCED = reduce_cfg(CONFIG, n_kv_heads=4)

register(ArchSpec(
    name="phi3_mini_3_8b", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="knnlm", interval=1, k=100),
    source="arXiv:2404.14219; unverified",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
