"""RALM integration (twin of ``repro.core.rag``), the paper's two modes.

Token-level, decoder-only retrieval (kNN-LM; paper Dec-S/Dec-L,
retrieval interval 1): the last layer's hidden state is the query, each
database vector maps to the next token of its context, and the LM's
next-token distribution is mixed with a distance-weighted distribution
over the retrieved next tokens.

Chunk-level, encoder-decoder retrieval (RETRO; paper EncDec-S/EncDec-L,
intervals 8/64/512): each database vector maps to a chunk of text, the
retrieved chunks are encoded by a shallow encoder and enter the decoder
through cross-attention.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RagConfig:
    mode: str = "knnlm"            # "knnlm" | "retro" | "none"
    interval: int = 1              # retrieve every N generated tokens
    k: int = 100                   # neighbors (paper Table 2)
    lam: float = 0.25              # kNN-LM interpolation weight
    temperature: float = 10.0      # kNN softmax temperature over L2^2 dists
    chunk_len: int = 64            # RETRO chunk length (tokens per neighbor)


def knnlm_interpolate(lm_logits: torch.Tensor, knn_dists: torch.Tensor,
                      knn_tokens: torch.Tensor, lam: float,
                      temperature: float, offset: int = 0,
                      max_all=None, sum_all=None) -> torch.Tensor:
    """log((1-lam) softmax(lm_logits) + lam p_knn) -> [B, V] float32.

    p_knn(w) ∝ sum_{i: tok_i = w} exp(-d_i / T). Invalid neighbors (inf
    dist / token -1) carry zero mass; a row with no valid neighbor falls
    back to the pure LM distribution.

    Logits split by vocabulary over ranks: ``lm_logits`` [B, V_local] are
    this rank's columns [offset, offset + V_local), and the result is the
    mix's log-probabilities of those columns. The LM softmax takes its
    max and its sum over every rank's columns (``max_all`` / ``sum_all``:
    the elementwise max / sum over the ranks; None: this rank's alone);
    p_knn adds only the neighbours whose tokens fall in the columns."""
    B, V = lm_logits.shape
    valid = (knn_tokens >= 0) & torch.isfinite(knn_dists)
    logw = torch.where(valid, -knn_dists.float() / temperature,
                       float("-inf"))
    m = logw.max(dim=-1, keepdim=True).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.where(valid, torch.exp(logw - m), torch.zeros_like(logw))
    denom = w.sum(dim=-1, keepdim=True)
    w = w / torch.clamp(denom, min=1e-20)
    local = knn_tokens.long() - offset
    mine = (knn_tokens >= 0) & (local >= 0) & (local < V)
    p_knn = torch.zeros((B, V), dtype=torch.float32, device=w.device)
    p_knn.scatter_add_(1, local.clamp(0, V - 1), torch.where(mine, w, 0.0))
    logits = lm_logits.float()
    top = logits.amax(-1)
    top = top if max_all is None else max_all(top)
    e = torch.exp(logits - top[:, None])
    total = e.sum(-1)
    p_lm = e / (total if sum_all is None else sum_all(total))[:, None]
    lam_row = torch.where(denom[:, 0] > 0, lam, 0.0)[:, None]
    mixed = (1.0 - lam_row) * p_lm + lam_row * p_knn
    return torch.log(torch.clamp(mixed, min=1e-20))


def gather_payload(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Vector id -> payload (paper step 9). Missing ids (-1) return row 0;
    callers mask by id."""
    return table[torch.clamp(ids, min=0).long()]


def retro_neighbor_tokens(chunk_table: torch.Tensor, ids: torch.Tensor
                          ) -> torch.Tensor:
    """Retrieved chunks for the RETRO encoder: ``chunk_table``
    [N, chunk_len] and ids [B, K] -> [B, K, chunk_len]; missing
    neighbours (-1) give PAD (token 0) rows."""
    toks = gather_payload(chunk_table, ids)
    return torch.where((ids >= 0)[..., None], toks, torch.zeros_like(toks))


def should_retrieve(step: int, interval: int) -> bool:
    """Interval-1 RALMs retrieve every step; interval-N at every Nth
    generated token (and always at step 0)."""
    return interval <= 1 or step % interval == 0
