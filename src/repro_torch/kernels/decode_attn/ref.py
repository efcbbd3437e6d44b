"""Plain PyTorch version of the decode-attention kernel (twin of
``repro.kernels.decode_attn.ref``).

It follows the reference's grouped ``ref`` leg, the one the JAX engine
serves with by default, including where that leg rounds to the cache
dtype: the q.k scores come out of a cache-dtype einsum, and the softmax
weights are cast to the cache dtype before the PV product
(``decode_attn/ref.py:58-65``). Each product here is taken in float32
and rounded once to the cache dtype, which is what a bf16 einsum with
float32 accumulation does. The CUDA kernel instead stays in float32
until its final division, as the reference's Pallas kernel does; the
two differ by those bf16 roundings.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_validity(position: torch.Tensor, S: int, window: int,
                    ring: bool) -> torch.Tensor:
    """[B, S] slot validity from per-row absolute positions.

    Linear cache: slot ``i`` holds position ``i``, valid iff ``i <= pos``.
    Ring cache of size S: slot ``i`` holds ``pos - ((pos - i) mod S)``,
    valid iff that is ``>= 0``. A sliding ``window`` also rejects
    positions ``<= pos - window``."""
    pos = position.long()[:, None]
    slot = torch.arange(S, device=position.device)[None]
    if ring:
        p_slot = pos - torch.remainder(pos - slot, S)
        valid = p_slot >= 0
    else:
        p_slot = slot.expand(pos.shape[0], S)
        valid = p_slot <= pos
    if window > 0:
        valid = valid & (p_slot > pos - window)
    return valid


def ref_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, position: torch.Tensor,
                         window: int = 0, ring: bool = False
                         ) -> torch.Tensor:
    """q [B, T, H, D], caches [B, S, KV, D], position [B] -> [B, T, H, D].
    Grouped over the KV-head axis; no head repeat."""
    B, S, KV, D = k_cache.shape
    T, H = q.shape[1], q.shape[2]
    G = H // KV
    dt = v_cache.dtype
    qg = q.reshape(B, T, KV, G, D).float()
    s = torch.einsum("btkgd,bskd->bkgts", qg, k_cache.float())
    s = s.to(dt).float() * D ** -0.5
    valid = decode_validity(position, S, window, ring)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", w.to(dt).float(),
                       v_cache.float()).to(dt)
    return out.reshape(B, T, H, D)
