"""Hymba-1.5B — parallel attention + mamba heads in every block
[arXiv:2411.13676; hf].

Adaptation notes (as in the reference): Hymba places full-attention layers at
{0, 15, 31} and SWA elsewhere; our cyclic layer-pattern mechanism puts the
full-attention layers at {0, 16} (period-16 cycle). Meta tokens are omitted.
long_500k RUNS: hybrid attn∥SSM with ring caches is sub-quadratic."""
from repro_torch.configs import ArchSpec, reduce_cfg, register
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, d_head=64, block="hybrid", ssm_state=16,
    layer_pattern=("global",) + ("local",) * 15, window=1024)

REDUCED = reduce_cfg(CONFIG, layer_pattern=("global", "local", "local"),
                     n_heads=4, n_kv_heads=2)

register(ArchSpec(
    name="hymba_1_5b", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="knnlm", interval=1, k=100),
    source="arXiv:2411.13676; hf"))
