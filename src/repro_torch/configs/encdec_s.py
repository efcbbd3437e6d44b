"""Paper Table 2: EncDec-S — 158M RETRO-style RALM (2-layer shallow encoder +
24-layer decoder; retrieval intervals 8/64/512, K=10)."""
from repro_torch.configs import (ArchSpec, FULL_ATTENTION_SKIP, reduce_cfg,
                                 register)
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="encdec-s", n_layers=24, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=1368, vocab_size=50000, d_head=64, arch="encdec", n_enc_layers=2,
    tie_embeddings=True)

REDUCED = reduce_cfg(CONFIG, n_kv_heads=4)

register(ArchSpec(
    name="encdec_s", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="retro", interval=64, k=10, chunk_len=64),
    source="paper Table 2",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
