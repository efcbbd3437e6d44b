"""Llama-3.1-405B — dense GQA, 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.configs import (ArchSpec, FULL_ATTENTION_SKIP, reduce_cfg,
                                 register)
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", n_layers=126, d_model=16384, n_heads=128,
    n_kv_heads=8, d_ff=53248, vocab_size=128256, d_head=128,
    rope_theta=5e5)

REDUCED = reduce_cfg(CONFIG)

register(ArchSpec(
    name="llama3_405b", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="knnlm", interval=1, k=100),
    source="arXiv:2407.21783; unverified",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
