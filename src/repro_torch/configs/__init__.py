"""Architecture registry (twin of ``repro.configs``).

This slice registers the paper's Dec-S only; ``get_arch`` imports
``repro_torch.configs.<name>`` on first use, as the reference does.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.core.rag import RagConfig
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    model: ModelConfig
    reduced: ModelConfig
    rag: RagConfig
    source: str                         # public-literature citation
    skip_shapes: Dict[str, str] = dataclasses.field(default_factory=dict)


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    name = name.replace("-", "_").replace(".", "_")
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]


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
