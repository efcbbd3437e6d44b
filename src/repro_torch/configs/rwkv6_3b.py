"""RWKV-6 "Finch" 3B — attention-free, data-dependent decay
[arXiv:2404.05892; hf].

The paper's interval-1 decoder-only RALM case maps perfectly: the RWKV
hidden state is the retrieval query (kNN-LM). long_500k RUNS: O(1)-state
decode is the designated sub-quadratic cell."""
from repro_torch.configs import ArchSpec, reduce_cfg, register
from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536, d_head=64, block="rwkv6", rope_mode="none")

REDUCED = reduce_cfg(CONFIG, n_heads=4, n_kv_heads=4)

register(ArchSpec(
    name="rwkv6_3b", model=CONFIG, reduced=REDUCED,
    rag=RagConfig(mode="knnlm", interval=1, k=100),
    source="arXiv:2404.05892; hf"))
