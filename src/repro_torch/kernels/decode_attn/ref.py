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

``ref_decode_attention_partial`` is the plain version of the kernel's
partial mode, for a cache that holds one rank's range of a sequence split
over ranks, and ``merge_partials`` the cross-rank merge of those
partials: float32 throughout (the scores rounded to the cache dtype as
above), normalised only by the merge.
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


def ref_decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 position: torch.Tensor,
                                 slot_offset: int = 0):
    """One rank's share of a decode step's attention: q [B, 1, H, D];
    caches [B, S, KV, D] whose slot ``i`` holds absolute position
    ``slot_offset + i`` (a linear cache); position [B]. Returns float32
    (acc [B, H, D], m [B, H], l [B, H]): the running max of the valid
    scores, the sum of their exponentials against it, and the weighted
    sum of the values. A row with no valid slot gives m = NEG_INF, l = 0
    and acc = 0."""
    B, S, KV, D = k_cache.shape
    H = q.shape[2]
    G = H // KV
    dt = v_cache.dtype
    qg = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    s = s.to(dt).float() * D ** -0.5
    valid = decode_validity(position.long() - int(slot_offset), S, 0,
                            False)[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return acc.reshape(B, H, D), m.reshape(B, H), p.sum(-1).reshape(B, H)


def merge_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor
                   ) -> torch.Tensor:
    """The attention output from R ranks' partials, stacked on a leading
    axis: acc [R, B, H, D], m and l [R, B, H] float32 -> [B, H, D]
    float32. Each partial is rescaled to the largest running max of the
    ranks that saw a valid slot (a rank with l = 0 weighs nothing), the
    sums are added in rank order, and the one division comes last."""
    live = l > 0
    top = torch.where(live, m, NEG_INF).amax(0)
    c = torch.where(live, torch.exp(m - top), 0.0)
    total = (l * c).sum(0)
    out = (acc * c[..., None]).sum(0)
    return out / torch.clamp(total, min=1e-20)[..., None]
