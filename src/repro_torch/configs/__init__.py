"""Architecture registry (twin of ``repro.configs``).

The paper's four RALMs (Table 2) are registered: the kNN-LM decoders
Dec-S and Dec-L and the RETRO encoder-decoders EncDec-S and EncDec-L;
and the five dense assigned backbones, served as kNN-LMs: Qwen2-0.5B,
Phi-3-mini, Gemma-3-4B, Llama-3-405B and Qwen2-VL-72B. ``get_arch``
imports ``repro_torch.configs.<name>`` on first use, as the reference
does; the other five assigned backbones (MoE, hybrid, RWKV6 and the
audio encoder-decoder) are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig


ASSIGNED = (
    "qwen2_0_5b", "llama3_405b", "phi3_mini_3_8b", "gemma3_4b",
    "qwen2_vl_72b", "seamless_m4t_medium", "hymba_1_5b", "dbrx_132b",
    "phi3_5_moe_42b", "rwkv6_3b",
)
PAPER = ("dec_s", "dec_l", "encdec_s", "encdec_l")
#: assigned backbones whose block family the port does not serve yet
NOT_PORTED = ("seamless_m4t_medium", "hymba_1_5b", "dbrx_132b",
              "phi3_5_moe_42b", "rwkv6_3b")

# the assigned input-shape grid (LM transformer shapes: seq_len x global_batch)
SHAPES: Dict[str, Dict] = {
    "train_4k":    dict(kind="train",   seq_len=4096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768,  global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32768,  global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524288, global_batch=1),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    model: ModelConfig
    reduced: ModelConfig
    rag: RagConfig
    source: str                         # public-literature citation
    # shape name -> reason, for cells that are skipped per the assignment
    skip_shapes: Dict[str, str] = dataclasses.field(default_factory=dict)

    def applicable_shapes(self) -> Tuple[str, ...]:
        return tuple(s for s in SHAPES if s not in self.skip_shapes)


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    name = name.replace("-", "_").replace(".", "_")
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name}: its block family is not ported to repro_torch yet "
            f"(ROADMAP Queue 1 item 12b)")
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]


def list_archs(include_paper: bool = True) -> Tuple[str, ...]:
    return ASSIGNED + (PAPER if include_paper else ())


FULL_ATTENTION_SKIP = (
    "pure full attention — long_500k requires sub-quadratic attention; "
    "skipped per assignment"
)


def reduce_cfg(cfg: ModelConfig, **over) -> ModelConfig:
    """Family-preserving reduction for CPU tests (the reference's rule)."""
    pattern = over.get("layer_pattern", cfg.layer_pattern)
    base = dict(
        n_layers=min(cfg.n_layers, 4 if len(pattern) <= 2
                     else len(pattern) + 1),
        d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        d_ff=128, vocab_size=512, d_head=0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        window=min(cfg.window, 8) if cfg.window else 0,
    )
    base.update(over)
    return dataclasses.replace(cfg, **base)
