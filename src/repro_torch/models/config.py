"""Model configuration (twin of ``repro.models.config``), jax-free.

The dtype stays a string (``"bfloat16"``, ``"float32"``) so configs
compare and hash like the reference's; ``torch_dtype`` turns it into a
``torch.dtype`` where tensors are made. Every field converts one to
one from the reference's config.
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

    block: str = "dense"                 # dense | moe | hybrid | rwkv6
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

    def param_count(self) -> int:
        """Total parameters (embedding + blocks), for 6ND model-flops math."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        nh, nkv, dh = self.n_heads, self.n_kv_heads, self.d_head
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.block == "rwkv6":
            # r,k,v,g,w projections + output + ffn(2 mats) + small lora decays
            tmix = d * (nh * dh) * 4 + d * (nh * dh) + d * 64 * 2 * 5
            cmix = d * f + f * d + d * d
            blk = tmix + cmix
        else:
            attn = d * nh * dh + 2 * d * nkv * dh + nh * dh * d
            if self.block == "moe":
                mlp = self.n_experts * 3 * d * f + d * self.n_experts
            else:
                mlp = 3 * d * f
            blk = attn + mlp
            if self.block == "hybrid":
                d_in = nh * dh
                blk += 2 * d * d_in + d_in * (2 * self.ssm_state + 1) + d_in * d
        enc = 0
        if self.arch == "encdec":
            # encoder layers + decoder cross-attention
            enc_attn = d * nh * dh + 2 * d * nkv * dh + nh * dh * d
            enc = self.n_enc_layers * (enc_attn + 3 * d * f)
            blk += enc_attn  # cross-attn per decoder layer
        return emb + L * blk + enc

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only ``top_k`` experts)."""
        if self.block != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        dense_like = self.param_count() - L * self.n_experts * 3 * d * f
        return dense_like + L * self.top_k * 3 * d * f

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
