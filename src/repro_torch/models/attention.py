"""Attention (twin of ``repro.models.attention``): causal attention for
train/prefill and the cache builders. Decode attention is
``repro_torch.kernels.decode_attn.ops.decode_attention`` (the CUDA
kernel's wrapper; the reference routed between backends here).

``flash_attention`` in the reference is plain jnp (a blocked online
softmax, no Pallas). Here it is a plain masked softmax over the whole
score matrix, with the reference's numerics: float32 scores, softmax
weights cast to the value dtype for the PV product, float32 accumulation,
division by the float32 row sum. For sequences within one of the
reference's 512-wide KV blocks the two compute the same thing.

The JAX functions are pure; here ``prefill_cache`` and ``update_cache``
write into the cache tensors they are given, in place (the reference
donates the pool caches to get the same effect, ``serve/engine.py:119``).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, KV*q_per_kv, D] (GQA head expansion)."""
    if q_per_kv == 1:
        return k
    return k.repeat_interleave(q_per_kv, dim=2)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int
          ) -> torch.Tensor:
    """[B, Tq, Tk] boolean validity from absolute positions."""
    m = torch.ones(qpos.shape + (kpos.shape[-1],), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[..., None, :] <= qpos[..., :, None]
    if window > 0:
        m &= kpos[..., None, :] > qpos[..., :, None] - window
    return m


def flash_attention(q, k, v, q_positions, k_positions, causal=True,
                    window=0):
    """q [B,T,H,D], k/v [B,S,KV,D], positions [B,T]/[B,S] -> [B,T,H,D].
    Fully masked rows give zero."""
    D = q.shape[-1]
    qkv = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, qkv), _repeat_kv(v, qkv)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * D ** -0.5
    msk = _mask(q_positions, k_positions, causal, window)[:, None]
    s = torch.where(msk, s, NEG_INF)
    mx = s.amax(-1, keepdim=True)
    p = torch.where(msk, torch.exp(s - mx), torch.zeros_like(s))
    sm = p.sum(-1, keepdim=True)
    pv = torch.einsum("bhts,bshd->bhtd", p.to(v.dtype).float(), v.float())
    out = pv / torch.clamp(sm, min=1e-20)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def prefill_cache(k_cache, v_cache, k_new, v_new, ring: bool = False):
    """Write prefill K/V of positions 0..T-1 into [B, S, KV, D] caches,
    in place (linear: slots 0..T-1; ring: the last S positions, each at
    slot p % S)."""
    S = k_cache.shape[1]
    T = k_new.shape[1]
    if not ring or T <= S:
        n = min(T, S)
        k_cache[:, :n] = k_new[:, :n].to(k_cache.dtype)
        v_cache[:, :n] = v_new[:, :n].to(v_cache.dtype)
        return k_cache, v_cache
    shift = (T - S) % S
    k_cache.copy_(torch.roll(k_new[:, T - S:].to(k_cache.dtype), shift, 1))
    v_cache.copy_(torch.roll(v_new[:, T - S:].to(v_cache.dtype), shift, 1))
    return k_cache, v_cache


def update_cache(k_cache, v_cache, k_new, v_new, position,
                 ring: bool = False, slots=None):
    """Write [B,Tn,KV,D] new keys/values at ``position`` ([B] or scalar),
    in place. Full cache: slot = position + t; ring: (position + t) % S.
    With ``slots``, row ``w`` of the wave goes to cache row ``slots[w]``
    (the KV pool). A full cache must be long enough for every write
    (the engine grows its pool before a request outruns it); the
    reference's scatter would drop such writes, an index past the end
    here is an error."""
    S = k_cache.shape[1]
    B, Tn = k_new.shape[:2]
    pos = torch.as_tensor(position, device=k_new.device).long()
    pos = pos.expand(B) if pos.ndim == 0 else pos
    seq_idx = pos[:, None] + torch.arange(Tn, device=pos.device)[None, :]
    if ring:
        seq_idx = seq_idx % S
    rows = (torch.arange(B, device=pos.device) if slots is None
            else torch.as_tensor(slots, device=pos.device).long())
    bidx = rows[:, None].expand(B, Tn)
    k_cache[bidx, seq_idx] = k_new.to(k_cache.dtype)
    v_cache[bidx, seq_idx] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
