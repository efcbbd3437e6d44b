"""Paper Table 2: Dec-L — 1259M decoder-only RALM (kNN-LM, interval 1)."""
from repro_torch.configs import (ArchSpec, FULL_ATTENTION_SKIP, reduce_cfg,
                                 register)
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dec-l", n_layers=96, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2736, vocab_size=50000, d_head=64, tie_embeddings=True)

REDUCED = reduce_cfg(CONFIG, n_kv_heads=4)

register(ArchSpec(
    name="dec_l", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="knnlm", interval=1, k=100),
    source="paper Table 2",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
