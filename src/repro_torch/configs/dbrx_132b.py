"""DBRX-132B — fine-grained MoE, 16 experts top-4
[hf:databricks/dbrx-base; unverified]."""
from repro_torch.configs import ArchSpec, FULL_ATTENTION_SKIP, reduce_cfg, register
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352, d_head=128, block="moe",
    n_experts=16, top_k=4, rope_theta=5e5)

REDUCED = reduce_cfg(CONFIG)

register(ArchSpec(
    name="dbrx_132b", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="knnlm", interval=1, k=100),
    source="hf:databricks/dbrx-base; unverified",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
