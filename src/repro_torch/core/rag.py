"""RALM integration (twin of ``repro.core.rag``): the kNN-LM mix.

Token-level, decoder-only retrieval (kNN-LM; paper Dec-S/Dec-L,
retrieval interval 1): the last layer's hidden state is the query, each
database vector maps to the next token of its context, and the LM's
next-token distribution is mixed with a distance-weighted distribution
over the retrieved next tokens.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RagConfig:
    mode: str = "knnlm"            # "knnlm" | "none" (RETRO comes later)
    interval: int = 1              # retrieve every N generated tokens
    k: int = 100                   # neighbors (paper Table 2)
    lam: float = 0.25              # kNN-LM interpolation weight
    temperature: float = 10.0      # kNN softmax temperature over L2^2 dists
    chunk_len: int = 64            # RETRO chunk length (tokens per neighbor)


def knnlm_interpolate(lm_logits: torch.Tensor, knn_dists: torch.Tensor,
                      knn_tokens: torch.Tensor, lam: float,
                      temperature: float) -> torch.Tensor:
    """log((1-lam) softmax(lm_logits) + lam p_knn) -> [B, V] float32.

    p_knn(w) ∝ sum_{i: tok_i = w} exp(-d_i / T). Invalid neighbors (inf
    dist / token -1) carry zero mass; a row with no valid neighbor falls
    back to the pure LM distribution."""
    B, V = lm_logits.shape
    valid = (knn_tokens >= 0) & torch.isfinite(knn_dists)
    logw = torch.where(valid, -knn_dists.float() / temperature,
                       float("-inf"))
    m = logw.max(dim=-1, keepdim=True).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.where(valid, torch.exp(logw - m), torch.zeros_like(logw))
    denom = w.sum(dim=-1, keepdim=True)
    has_knn = denom[:, 0] > 0
    w = w / torch.clamp(denom, min=1e-20)
    tok = torch.clamp(knn_tokens, min=0).long()
    p_knn = torch.zeros((B, V), dtype=torch.float32, device=w.device)
    p_knn.scatter_add_(1, tok, w)
    p_lm = torch.softmax(lm_logits.float(), dim=-1)
    lam_row = torch.where(has_knn, lam, 0.0)[:, None]
    mixed = (1.0 - lam_row) * p_lm + lam_row * p_knn
    return torch.log(torch.clamp(mixed, min=1e-20))


def gather_payload(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Vector id -> payload (paper step 9). Missing ids (-1) return row 0;
    callers mask by id."""
    return table[torch.clamp(ids, min=0).long()]


def should_retrieve(step: int, interval: int) -> bool:
    """Interval-1 RALMs retrieve every step; interval-N at every Nth
    generated token (and always at step 0)."""
    return interval <= 1 or step % interval == 0
