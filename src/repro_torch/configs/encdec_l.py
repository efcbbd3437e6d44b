"""Paper Table 2: EncDec-L — 1738M RETRO-style RALM (2-layer encoder +
96-layer decoder)."""
from repro_torch.configs import (ArchSpec, FULL_ATTENTION_SKIP, reduce_cfg,
                                 register)
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="encdec-l", n_layers=96, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2736, vocab_size=50000, d_head=64, arch="encdec", n_enc_layers=2,
    tie_embeddings=True)

REDUCED = reduce_cfg(CONFIG, n_kv_heads=4)

register(ArchSpec(
    name="encdec_l", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="retro", interval=64, k=10, chunk_len=64),
    source="paper Table 2",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
