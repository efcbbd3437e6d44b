"""Gemma-3-4B — 5:1 local:global sliding-window, 262k vocab
[hf:google/gemma-3-1b-pt; unverified].

long_500k runs for this arch: 5/6 of layers use a 1024-token ring KV cache
(sub-quadratic); the sparse global layers decode O(L) against the full
cache."""
from repro_torch.configs import ArchSpec, reduce_cfg, register
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab_size=262144, d_head=256,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024, rope_theta=1e6, tie_embeddings=True)

REDUCED = reduce_cfg(CONFIG)

register(ArchSpec(
    name="gemma3_4b", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="knnlm", interval=1, k=100),
    source="hf:google/gemma-3-1b-pt; unverified"))
