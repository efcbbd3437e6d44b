"""SeamlessM4T-medium — encoder-decoder, multimodal [arXiv:2308.11596; hf].

The audio frontend is a stub in the reference too: only its dry run's
input specs read ``frontend``; serving embeds token chunks. This is the closest assigned arch to the
paper's EncDec RALMs: retrieved chunks feed the encoder, the decoder
cross-attends (RETRO-style, paper §2.1 category 1)."""
from repro_torch.configs import ArchSpec, FULL_ATTENTION_SKIP, reduce_cfg, register
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", n_layers=12, d_model=1024, n_heads=16,
    n_kv_heads=16, d_ff=4096, vocab_size=256206, d_head=64,
    arch="encdec", n_enc_layers=12, frontend="audio")

REDUCED = reduce_cfg(CONFIG, n_kv_heads=4)

register(ArchSpec(
    name="seamless_m4t_medium", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="retro", interval=64, k=10, chunk_len=64),
    source="arXiv:2308.11596; hf",
    skip_shapes={"long_500k": FULL_ATTENTION_SKIP}))
