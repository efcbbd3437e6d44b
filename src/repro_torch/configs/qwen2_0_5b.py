"""Qwen2-0.5B — dense GQA with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs import (ArchSpec, FULL_ATTENTION_SKIP, reduce_cfg,
                                 register)
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151936, d_head=64, qkv_bias=True,
    rope_theta=1e6, tie_embeddings=True)

REDUCED = reduce_cfg(CONFIG)

register(ArchSpec(
    name="qwen2_0_5b", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="knnlm", interval=1, k=100),
    source="arXiv:2407.10671; hf",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
