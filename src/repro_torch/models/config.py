"""Model configuration (twin of ``repro.models.config``), jax-free.

The dtype stays a string (``"bfloat16"``, ``"float32"``) so configs
compare and hash like the reference's; ``torch_dtype`` turns it into a
``torch.dtype`` where tensors are made. The port serves the dense
families (decoders, with RoPE or M-RoPE, and encoder-decoders); the
fields of the other families are kept so configs convert one to one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                      # 0 -> d_model // n_heads

    block: str = "dense"                 # only "dense" is served here
    layer_pattern: Tuple[str, ...] = ("global",)
    window: int = 0                      # sliding window for "local" layers

    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_mode: str = "rope"              # "rope" | "mrope" | "none"
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # qwen2-vl t/h/w split

    n_experts: int = 0
    top_k: int = 0
    ssm_state: int = 0
    conv_width: int = 4

    arch: str = "decoder"
    n_enc_layers: int = 0

    norm_eps: float = 1e-5
    act: str = "silu"                    # silu (SwiGLU) | gelu (GeGLU)
    tie_embeddings: bool = False

    frontend: Optional[str] = None

    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head",
                               self.d_model // max(self.n_heads, 1))

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def pattern_classes(self) -> Tuple[str, ...]:
        """Distinct layer-class names in stack order of first appearance."""
        seen, out = set(), []
        for i in range(self.n_layers):
            c = self.layer_pattern[i % len(self.layer_pattern)]
            if c not in seen:
                seen.add(c)
                out.append(c)
        return tuple(out)

    def layer_classes(self) -> Tuple[str, ...]:
        """Per-layer class name, length n_layers."""
        return tuple(self.layer_pattern[i % len(self.layer_pattern)]
                     for i in range(self.n_layers))

    def class_layers(self, cls: str) -> Tuple[int, ...]:
        """Global layer indices belonging to class ``cls``."""
        return tuple(i for i, c in enumerate(self.layer_classes()) if c == cls)
