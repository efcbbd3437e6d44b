"""Paper Table 2: Dec-S — 101M decoder-only RALM (kNN-LM, interval 1, K=100).

d_ff chosen so gated-MLP params match the paper's 2*d*4d FFN budget
(3*d*f = 8*d^2 -> f = 8d/3), giving ~101M with tied embeddings."""
from repro_torch.configs import (ArchSpec, FULL_ATTENTION_SKIP, reduce_cfg,
                                 register)
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dec-s", n_layers=24, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=1368, vocab_size=50000, d_head=64, tie_embeddings=True)

REDUCED = reduce_cfg(CONFIG, n_kv_heads=4)

register(ArchSpec(
    name="dec_s", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="knnlm", interval=1, k=100),
    source="paper Table 2",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
