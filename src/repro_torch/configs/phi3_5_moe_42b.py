"""Phi-3.5-MoE-42B (6.6B active) — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from repro_torch.configs import ArchSpec, FULL_ATTENTION_SKIP, reduce_cfg, register
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=6400, vocab_size=32064, d_head=128, block="moe",
    n_experts=16, top_k=2)

REDUCED = reduce_cfg(CONFIG)

register(ArchSpec(
    name="phi3_5_moe_42b", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="knnlm", interval=1, k=100),
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
