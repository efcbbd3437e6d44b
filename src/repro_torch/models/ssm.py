"""State-space sequence mixers (twin of ``repro.models.ssm``): the
Mamba-style selective-SSM head of Hymba's blocks and the RWKV-6
("Finch") time and channel mix.

Each has a form over a whole sequence (prefill, training) and a
single-step form for O(1)-state decode, which is the same function at
T = 1. States and recurrences stay in float32, as in the reference.

The reference scans time with ``lax.scan``; here the scans are Python
loops. ``mamba_scan`` computes every step's decay and input terms for a
block of ``SCAN_BLOCK`` steps at once, so that each step of its loop is
one fused multiply-add on the state and one product for the readout.
``rwkv6_time_mix_chunked`` replaces the per-token recurrence by
per-chunk products (the reference's GLA-style form, with each pair's
decay kept within float32: see its docstring), and falls back to the
scan where T is not a multiple of the chunk or fits in one.

``split=True``: the layer runs split over the model axis of a sharded
step (``models.parallel``), on leaves cut on head or channel boundaries.
Mamba: the rank's channels of ``w_in``'s x and z, of ``conv_w``, of
``w_bcdt``'s rows (the partial B, C and dt summed over "model", dt of
its heads kept) and of ``w_out``'s rows, its heads of ``a_log`` /
``dt_bias`` / ``d_skip``; the state holds its heads and channels.
RWKV-6's time mix: the rank's heads (columns of ``w_r`` / ``w_k`` /
``w_v`` / ``w_g`` / ``w_lora_b``, of ``w0`` and ``ln_x``, ``bonus_u``'s
rows, rows of ``w_o``; the ``wkv`` state of its heads). The channel mix:
the rank's ``f`` columns of ``w_ck`` and rows of ``w_cv``, and its ``d``
columns of ``w_cr``: the partial ``kk @ w_cv`` is reduce-scattered to
the rank's columns, gated there, and all-gathered.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import parallel
from repro_torch.models.layers import sigmoid, silu


# ---------------------------------------------------------------------------
# Mamba-style selective SSM head (Hymba's parallel branch)
# ---------------------------------------------------------------------------

class MambaParams(NamedTuple):
    w_in: torch.Tensor       # [d_model, 2*d_in]   (x and gate z)
    conv_w: torch.Tensor     # [conv_width, d_in]  depthwise causal conv
    w_bcdt: torch.Tensor     # [d_in, 2*ds + H]    B, C, dt projections
    a_log: torch.Tensor      # [H, ds] float32     -exp(a_log) = A diagonal
    dt_bias: torch.Tensor    # [H] float32
    d_skip: torch.Tensor     # [H] float32
    w_out: torch.Tensor      # [d_in, d_model]


SCAN_BLOCK = 32     # mamba_scan's steps a block of precomputed terms


def mamba_scan(p: MambaParams, x: torch.Tensor,
               state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               split: bool = False
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x [B, T, d_model] -> (y [B, T, d_model], (ssm [B, H, dh, ds]
    float32, conv [B, conv_w - 1, d_in])). ``state``: (ssm, conv) to
    resume from; None starts from zeros. ``split``: ``p`` holds the
    rank's heads (the module docstring); so do ``state`` and the
    returned state."""
    B, T, _ = x.shape
    cw, d_in = p.conv_w.shape
    H, ds = p.a_log.shape
    dh = d_in // H
    if split:
        x = parallel.copy_to_model(x)
    xi, z = (x @ p.w_in).chunk(2, dim=-1)                     # [B, T, d_in]

    conv_prev = (x.new_zeros((B, cw - 1, d_in)) if state is None
                 else state[1])
    xi_pad = torch.cat([conv_prev, xi], dim=1)
    # depthwise causal conv, summed in the reference's order
    xc = sum(xi_pad[:, i:i + T] * p.conv_w[i][None, None] for i in range(cw))
    xc = F.silu(xc)

    bcdt = xc @ p.w_bcdt
    if split:           # B and C whole, dt of the rank's heads
        bcdt = parallel.copy_to_model(parallel.reduce_from_model(bcdt))
        bcdt = torch.cat([bcdt[..., :2 * ds],
                          parallel.model_chunk(bcdt[..., 2 * ds:], -1)], -1)
    b_t = bcdt[..., :ds].float()                             # [B, T, ds]
    c_t = bcdt[..., ds:2 * ds].float()
    dt = F.softplus(bcdt[..., 2 * ds:] + p.dt_bias).float()  # [B, T, H]
    a = -torch.exp(p.a_log.float())                          # [H, ds]
    xh = xc.reshape(B, T, H, dh).float()

    h = (torch.zeros((B, H, dh, ds), dtype=torch.float32, device=x.device)
         if state is None else state[0])
    ys = []
    for s in range(0, T, SCAN_BLOCK):
        e = min(s + SCAN_BLOCK, T)
        dtb = dt[:, s:e]
        da = torch.exp(dtb[..., None] * a)                   # [B, n, H, ds]
        dbx = (dtb[..., None, None] * xh[:, s:e, :, :, None]
               * b_t[:, s:e, None, None, :])                 # [B, n, H, dh, ds]
        cb = c_t[:, s:e, None, :, None]                      # [B, n, 1, ds, 1]
        for t in range(e - s):
            h = torch.addcmul(dbx[:, t], h, da[:, t, :, None, :])
            ys.append(torch.matmul(h, cb[:, t]))             # [B, H, dh, 1]
    y = torch.stack(ys, dim=1).reshape(B, T, d_in)
    y = y + xc * p.d_skip.repeat_interleave(dh)[None, None]
    y = (y.to(x.dtype) * F.silu(z)) @ p.w_out
    if split:
        y = parallel.reduce_from_model(y)
    conv_state = xi_pad[:, T:] if cw > 1 else conv_prev
    return y, (h, conv_state)


def mamba_decode(p: MambaParams, x: torch.Tensor,
                 state: Tuple[torch.Tensor, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-token step: x [B, 1, d_model], state from ``mamba_scan``."""
    return mamba_scan(p, x, state)


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent decay linear recurrence
# ---------------------------------------------------------------------------

class RWKV6Params(NamedTuple):
    # time mix
    mu_r: torch.Tensor       # [d]   token-shift mix coefficients
    mu_k: torch.Tensor       # [d]
    mu_v: torch.Tensor       # [d]
    mu_g: torch.Tensor       # [d]
    mu_w: torch.Tensor       # [d]
    w_r: torch.Tensor        # [d, H*dh]
    w_k: torch.Tensor        # [d, H*dh]
    w_v: torch.Tensor        # [d, H*dh]
    w_g: torch.Tensor        # [d, H*dh]
    w_o: torch.Tensor        # [H*dh, d]
    # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
    w0: torch.Tensor         # [H*dh]
    w_lora_a: torch.Tensor   # [d, 64]
    w_lora_b: torch.Tensor   # [64, H*dh]
    bonus_u: torch.Tensor    # [H, dh]
    ln_x: torch.Tensor       # [H*dh] per-head group-norm scale
    # channel mix
    mu_ck: torch.Tensor      # [d]
    mu_cr: torch.Tensor      # [d]
    w_ck: torch.Tensor       # [d, f]
    w_cv: torch.Tensor       # [f, d]
    w_cr: torch.Tensor       # [d, d]


class RWKVState(NamedTuple):
    wkv: torch.Tensor        # [B, H, dh, dh] float32
    shift_t: torch.Tensor    # [B, d] last token (time-mix shift)
    shift_c: torch.Tensor    # [B, d] last token (channel-mix shift)


def rwkv6_init_state(B: int, H: int, dh: int, d: int, dtype,
                     device="cpu") -> RWKVState:
    return RWKVState(
        wkv=torch.zeros((B, H, dh, dh), dtype=torch.float32, device=device),
        shift_t=torch.zeros((B, d), dtype=dtype, device=device),
        shift_c=torch.zeros((B, d), dtype=dtype, device=device))


def _group_norm(y: torch.Tensor, scale: torch.Tensor, H: int
                ) -> torch.Tensor:
    """Per-head LayerNorm of the wkv readout (RWKV's ln_x); the variance
    has no Bessel correction, as ``jnp.var``."""
    B, T, D = y.shape
    yh = y.reshape(B, T, H, D // H).float()
    mean = yh.mean(-1, keepdim=True)
    var = yh.var(-1, unbiased=False, keepdim=True)
    yh = (yh - mean) * torch.rsqrt(var + 1e-5)
    return (yh.reshape(B, T, D) * scale).to(y.dtype)


def _time_mix_inputs(p: RWKV6Params, x: torch.Tensor, state: RWKVState,
                     H: int, split: bool = False):
    """The token-shifted projections of the time mix: (r, k, v [B, T, H,
    dh] in x's dtype, the gate g [B, T, D], the decays w [B, T, H, dh]
    float32, clamped to w >= e^-8). ``split``: H and D are the rank's."""
    B, T, _ = x.shape
    D = p.w_r.shape[-1]
    dh = D // H
    x_prev = torch.cat([state.shift_t[:, None], x[:, :-1]], dim=1)
    tp = parallel.copy_to_model if split else (lambda t: t)

    def mix(mu):
        return tp(x + (x_prev - x) * mu[None, None])
    r = (mix(p.mu_r) @ p.w_r).reshape(B, T, H, dh)
    k = (mix(p.mu_k) @ p.w_k).reshape(B, T, H, dh)
    v = (mix(p.mu_v) @ p.w_v).reshape(B, T, H, dh)
    g = silu(mix(p.mu_g) @ p.w_g)
    # the reference adds w0 in float32: XLA does not round the bf16 sum
    # that feeds the float32 exp
    x_w = x + (x_prev - x) * p.mu_w[None, None]
    w_log = p.w0.float() + (tp(torch.tanh(x_w @ p.w_lora_a))
                            @ p.w_lora_b).float()
    # decay clamp w >= e^-8: keeps the chunked form's within-chunk decay
    # products inside float32 range
    w = torch.exp(-torch.clamp(torch.exp(w_log), 0.0, 8.0))
    return r, k, v, g, w.reshape(B, T, H, dh)


def rwkv6_time_mix(p: RWKV6Params, x: torch.Tensor, state: RWKVState,
                   H: int, split: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> (y [B, T, d], wkv state' [B, H, dh, dh] float32,
    shift' [B, d]). Any T; T = 1 is the decode step. ``split``: ``p``,
    H and the wkv state are the rank's heads (the module docstring)."""
    B, T, _ = x.shape
    D = p.w_r.shape[-1]
    r, k, v, g, w = _time_mix_inputs(p, x, state, H, split)
    r, k, v = r.float(), k.float(), v.float()
    u = p.bonus_u[None, :, :, None]                          # [1, H, dh, 1]
    s = state.wkv
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B, H, dh, dh]
        ys.append(torch.matmul(r[:, t, :, None, :], s + u * kv))
        s = w[:, t, :, :, None] * s + kv
    y = torch.cat(ys, dim=2).transpose(1, 2).reshape(B, T, D).to(x.dtype)
    y = _group_norm(y, p.ln_x, H)
    return _time_mix_out(y * g.to(y.dtype), p.w_o, split), s, x[:, -1]


def _time_mix_out(y: torch.Tensor, w_o: torch.Tensor, split: bool
                  ) -> torch.Tensor:
    """The time mix's output projection (the rank's rows of ``w_o``,
    summed over "model", when ``split``)."""
    y = y @ w_o
    return parallel.reduce_from_model(y) if split else y


def rwkv6_time_mix_chunked(p: RWKV6Params, x: torch.Tensor,
                           state: RWKVState, H: int, chunk: int = 32,
                           split: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Chunked-parallel RWKV-6: the math of ``rwkv6_time_mix`` with the
    per-token state recurrence replaced by per-chunk products, so the
    [H, dh, dh] state is read and written once a chunk.

    Within a chunk, with log-decays L_j = sum_{l<j} log w_l and the
    chunk's total L_C:
      y_j   = (r_j e^{L_j}) S_0 + sum_{i<j} (r_j e^{L_j - L_i - log w_i}
              . k_i) v_i + u (r_j . k_j) v_j
      S_out = e^{L_C} S_0 + sum_i (e^{L_C - L_i - log w_i} k_i) (x) v_i
    in float32. Every factor is a decay, at most 1. The reference splits
    each intra-chunk pair's factor into e^{L_j - L_mid} e^{L_mid - L_i -
    log w_i} around the chunk's middle; under the clamp w >= e^-8 a
    half chunk spans up to 16 x 8 = 128 in log, over float32's range
    (e^88), and at full width that gives inf and NaN. Here each pair's
    factor is one exp of a non-positive exponent, chunk by chunk.
    ``split``: as ``rwkv6_time_mix``'s."""
    B, T, _ = x.shape
    D = p.w_r.shape[-1]
    dh = D // H
    if T % chunk != 0 or T <= chunk:
        return rwkv6_time_mix(p, x, state, H, split)
    r, k, v, g, w = _time_mix_inputs(p, x, state, H, split)
    u = p.bonus_u.float()                                    # [H, dh]

    C, n = chunk, T // chunk
    rc = r.float().reshape(B, n, C, H, dh)
    kc = k.float().reshape(B, n, C, H, dh)
    vc = v.float().reshape(B, n, C, H, dh)
    logw = torch.log(torch.clamp(w.reshape(B, n, C, H, dh), min=1e-38))
    cs = torch.cumsum(logw, dim=2)                           # inclusive
    L_excl = cs - logw
    Dk = torch.exp(cs[:, :, -1])                             # [B, n, H, dh]
    r_a = rc * torch.exp(L_excl)
    k_s = kc * torch.exp(cs[:, :, -1][:, :, None] - cs)
    diag = (rc * u * kc).sum(-1)                             # r.u.k a token
    # strict-lower pairs (c, s), s < c: decay e^{L_c - cs_s} <= 1
    lower = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device),
                       diagonal=-1)[None, :, :, None, None]

    S = state.wkv
    ys = []
    for j in range(n):
        expo = L_excl[:, j, :, None] - cs[:, j, None, :]    # [B, C, C, H, dh]
        decay = torch.exp(torch.where(lower, expo, -torch.inf))
        scores = (rc[:, j, :, None] * kc[:, j, None, :] * decay).sum(-1)
        ys.append(torch.einsum("bcsh,bshd->bchd", scores, vc[:, j])
                  + diag[:, j, ..., None] * vc[:, j]
                  + torch.einsum("bchk,bhkv->bchv", r_a[:, j], S))
        S = Dk[:, j, :, :, None] * S + torch.einsum(
            "bchk,bchv->bhkv", k_s[:, j], vc[:, j])
    y = torch.stack(ys, dim=1).reshape(B, T, D)
    y = _group_norm(y.to(x.dtype), p.ln_x, H)
    return _time_mix_out(y * g.to(y.dtype), p.w_o, split), S, x[:, -1]


def rwkv6_channel_mix(p: RWKV6Params, x: torch.Tensor, shift: torch.Tensor,
                      split: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> (out [B, T, d], shift' [B, d]). ``split``: the
    rank's columns (the module docstring)."""
    x_prev = torch.cat([shift[:, None], x[:, :-1]], dim=1)
    xk = x + (x_prev - x) * p.mu_ck[None, None]
    xr = x + (x_prev - x) * p.mu_cr[None, None]
    if not split:
        kk = torch.square(torch.relu(xk @ p.w_ck))
        return sigmoid(xr @ p.w_cr) * (kk @ p.w_cv), x[:, -1]
    xk, xr = parallel.copy_to_model(xk), parallel.copy_to_model(xr)
    kk = torch.square(torch.relu(xk @ p.w_ck))
    v = parallel.scatter_to_model(kk @ p.w_cv, -1)
    return parallel.gather_from_model(sigmoid(xr @ p.w_cr) * v, -1), \
        x[:, -1]
