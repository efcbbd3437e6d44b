"""Attention (twin of ``repro.models.attention``): causal attention for
train/prefill and the cache builders. Decode attention is
``repro_torch.kernels.decode_attn.ops.decode_attention`` (the CUDA
kernel's wrapper; the reference routed between backends here).

``flash_attention`` is the reference's, in plain PyTorch as the
reference's is plain jnp (no Pallas): Q and K/V blocked by 512 with an
online softmax (float32 scores and accumulation, the probability tile
cast to the value dtype for the PV product). The reference pads the
last Q and K/V block to the full block, the keys at int32-max positions
that every mask rejects; here the last block is shorter, which drops
only padded query rows and zero probabilities (RETRO's 640 encoder rows
were padded to 1024). Its backward is the reference's FA2 rule
(``_flash_bwd_rule``), an autograd ``Function`` that saves only
``q, k, v``, the positions, ``out`` and the per-row log-sum-exp and
recomputes each probability tile in float32; the reference runs a dq
pass and a dk/dv pass over the same tiles, this runs one pass that adds
each tile into dq, dk and dv in the reference's orders (dq over K
blocks, dk/dv over Q blocks), so the sums are the same.

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


def _flash_forward(q, k, v, q_positions, k_positions, causal, window,
                   q_block, k_block, with_lse=True):
    """(out [B, T, H, D] in q's dtype, lse [B, T, H] float32, or None
    without ``with_lse``). A non-causal call without a window masks
    nothing: every key is valid, as no block is padded."""
    T, H, D = q.shape[1:]
    S = k.shape[1]
    qb, kb = min(q_block, T), min(k_block, S)
    qkv = H // k.shape[2]
    qf = q.float()
    kf = _repeat_kv(k, qkv).float()
    vr = _repeat_kv(v, qkv)
    vf = vr.float()
    masked = causal or window > 0
    scale = D ** -0.5
    outs, lses = [], []
    for i in range(0, T, qb):
        qblk, qbp = qf[:, i:i + qb], q_positions[:, i:i + qb]
        acc = mx = sm = msk = None
        for j in range(0, S, kb):
            s = torch.einsum("bthd,bshd->bhts", qblk, kf[:, j:j + kb]) * scale
            if masked:
                msk = _mask(qbp, k_positions[:, j:j + kb], causal,
                            window)[:, None]
                s = torch.where(msk, s, NEG_INF)
            new_mx = s.amax(-1) if mx is None else torch.maximum(
                mx, s.amax(-1))
            p = torch.exp(s - new_mx[..., None])
            if masked:
                p = torch.where(msk, p, 0.0)
            pv = torch.einsum("bhts,bshd->bhtd", p.to(vr.dtype).float(),
                              vf[:, j:j + kb])
            if acc is None:         # the first block: the carry is zero
                acc, sm = pv, p.sum(-1)
            else:
                corr = torch.exp(mx - new_mx)
                sm = sm * corr + p.sum(-1)
                acc = acc * corr[..., None] + pv
            mx = new_mx
        smc = torch.clamp(sm, min=1e-20)
        outs.append((acc / smc[..., None]).permute(0, 2, 1, 3).to(q.dtype))
        if with_lse:
            lses.append((mx + torch.log(smc)).transpose(1, 2))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 1)
    if not with_lse:
        return out, None
    return out, lses[0] if len(lses) == 1 else torch.cat(lses, 1)


class _FlashAttention(torch.autograd.Function):
    """``_flash_forward`` with the reference's FA2 backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, k_positions, causal, window,
                q_block, k_block):
        out, lse = _flash_forward(q, k, v, q_positions, k_positions,
                                  causal, window, q_block, k_block)
        ctx.save_for_backward(q, k, v, q_positions, k_positions, out, lse)
        ctx.args = (causal, window, q_block, k_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_positions, k_positions, out, lse = ctx.saved_tensors
        causal, window, q_block, k_block = ctx.args
        B, T, H, D = q.shape
        S, KV = k.shape[1], k.shape[2]
        qkv = H // KV
        qb, kb = min(q_block, T), min(k_block, S)
        f32 = torch.float32
        qf = q.to(f32)
        kf = _repeat_kv(k, qkv).to(f32)
        vf = _repeat_kv(v, qkv).to(f32)
        dof = dout.to(f32)
        lse = lse.transpose(1, 2)                            # [B,H,T]
        scale = D ** -0.5
        # D_i = rowsum(dOut * Out)
        delta = torch.einsum("bthd,bthd->bht", dof, out.to(f32))
        dq = torch.zeros_like(qf)
        dk = torch.zeros_like(kf)
        dv = torch.zeros_like(vf)
        masked = causal or window > 0
        for i in range(0, T, qb):
            qblk, dob = qf[:, i:i + qb], dof[:, i:i + qb]
            lseb, dltb = lse[..., i:i + qb, None], delta[..., i:i + qb, None]
            for j in range(0, S, kb):
                kblk, vblk = kf[:, j:j + kb], vf[:, j:j + kb]
                s = torch.einsum("bthd,bshd->bhts", qblk, kblk) * scale
                p = torch.exp(s - lseb)
                if masked:
                    p = torch.where(_mask(q_positions[:, i:i + qb],
                                          k_positions[:, j:j + kb], causal,
                                          window)[:, None], p, 0.0)
                dp = torch.einsum("bthd,bshd->bhts", dob, vblk)
                ds = p * (dp - dltb) * scale
                dq[:, i:i + qb] += torch.einsum("bhts,bshd->bthd", ds, kblk)
                dv[:, j:j + kb] += torch.einsum("bhts,bthd->bshd", p, dob)
                dk[:, j:j + kb] += torch.einsum("bhts,bthd->bshd", ds, qblk)
        # un-repeat GQA heads: sum each group's gradients
        dk = dk.reshape(B, S, KV, qkv, D).sum(3)
        dv = dv.reshape(B, S, KV, qkv, D).sum(3)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def flash_attention(q, k, v, q_positions, k_positions, causal=True,
                    window=0, q_block=512, k_block=512):
    """q [B,T,H,D], k/v [B,S,KV,D], positions [B,T]/[B,S] -> [B,T,H,D].
    Fully masked rows give zero. Differentiable through the FA2
    backward, which keeps no score tile; without gradients (serving) the
    forward runs alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, q_positions, k_positions,
                                     causal, window, q_block, k_block)
    return _flash_forward(q, k, v, q_positions, k_positions, causal, window,
                          q_block, k_block, with_lse=False)[0]


def prefill_cache(k_cache, v_cache, k_new, v_new, ring: bool = False,
                  slot_offset: int = 0, ring_size=None):
    """Write prefill K/V of positions 0..T-1 into [B, S, KV, D] caches,
    in place (linear: slots 0..T-1; ring: the last S positions, each at
    slot p % S).

    ``slot_offset``: the cache is one rank's slot range of a cache split
    over ranks, its slot ``i`` being global slot ``slot_offset + i``; it
    keeps the positions that land in its range. A ring split so has
    ``ring_size`` slots in all (position p lands in global slot
    p % ring_size, the last such position of the prompt kept)."""
    S = k_cache.shape[1]
    T = k_new.shape[1]
    if ring:
        # global slot g holds the prompt's last position p = g mod R
        R = S if ring_size is None else int(ring_size)
        g = torch.arange(slot_offset, slot_offset + S)
        p = (T - 1) - torch.remainder(T - 1 - g, R)
        held = (p >= 0).nonzero()[:, 0]
        src = p[held].to(k_new.device)
        dst = held.to(k_new.device)
        k_cache[:, dst] = k_new[:, src].to(k_cache.dtype)
        v_cache[:, dst] = v_new[:, src].to(v_cache.dtype)
        return k_cache, v_cache
    n = max(0, min(T - slot_offset, S))
    k_cache[:, :n] = k_new[:, slot_offset:slot_offset + n].to(k_cache.dtype)
    v_cache[:, :n] = v_new[:, slot_offset:slot_offset + n].to(v_cache.dtype)
    return k_cache, v_cache


def update_cache(k_cache, v_cache, k_new, v_new, position,
                 ring: bool = False, slots=None, slot_offset=None,
                 ring_size=None):
    """Write [B,Tn,KV,D] new keys/values at ``position`` ([B] or scalar),
    in place. Full cache: slot = position + t; ring: (position + t) % S.
    With ``slots``, row ``w`` of the wave goes to cache row ``slots[w]``
    (the KV pool). A full cache must be long enough for every write
    (the engine grows its pool before a request outruns it); the
    reference's scatter would drop such writes, an index past the end
    here is an error.

    ``slot_offset`` (an int): the cache is one rank's slot range of a
    cache split over ranks, slot ``i`` being global slot
    ``slot_offset + i`` (of a ring of ``ring_size`` slots in all, when
    ``ring``); a write to a global slot outside the range writes nothing
    (its slot is rewritten with what it holds, so no host sync decides
    which rows write)."""
    S = k_cache.shape[1]
    B, Tn = k_new.shape[:2]
    pos = torch.as_tensor(position, device=k_new.device).long()
    pos = pos.expand(B) if pos.ndim == 0 else pos
    seq_idx = pos[:, None] + torch.arange(Tn, device=pos.device)[None, :]
    if ring:
        seq_idx = seq_idx % (S if ring_size is None else int(ring_size))
    rows = (torch.arange(B, device=pos.device) if slots is None
            else torch.as_tensor(slots, device=pos.device).long())
    bidx = rows[:, None].expand(B, Tn)
    if slot_offset is not None:
        local = seq_idx - slot_offset
        mine = ((local >= 0) & (local < S))[..., None, None]
        seq_idx = local.clamp(0, S - 1)
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            cache[bidx, seq_idx] = torch.where(
                mine, new.to(cache.dtype), cache[bidx, seq_idx])
        return k_cache, v_cache
    k_cache[bidx, seq_idx] = k_new.to(k_cache.dtype)
    v_cache[bidx, seq_idx] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
