"""Plain float32 dense decoder: the model family of the configurations
whose ``reference`` is ``dense_decoder`` (Dec-S, Phi-3-mini). A family
module makes the weights from the seed in the port's parameter layout
(``make_weights``) and holds the plain forward over them
(``hidden_states``, ``logits``).

Pre-norm layers: RMSNorm, multi-head attention with rotate-half RoPE and a
causal softmax, RMSNorm, SwiGLU; the hidden state before the final norm is
the kNN-LM query, and the logits are its final norm times the output
head (the embedding, transposed, when the embeddings are tied).

Every product runs in float32 with TF32 off (``no_tf32``). Leaves are
read in the layout ``make_weights`` makes them:
``embed`` [V, d], ``final_norm`` [d], ``lm_head`` [d, V] when untied,
``classes["global"][name]`` stacked over layers. A layer's leaves are
cast to float32 when it runs, so the float32 copy of the model never
exists whole.

``quant="fp8"`` is the precision control: every matrix product reads
its weight and its input rounded to float8 e4m3 (the weight by one scale
for the whole matrix, the input by one scale a token), then multiplies in
float32.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ralm_bench.inputs import generator

FP8_MAX = 448.0


def make_weights(model: dict, scales: dict, seed: int, device) -> dict:
    """Random weights in the port's layout, in the served dtype: normal
    leaves, made leaf by stacked leaf (one call each) from one generator,
    norms ones. The embedding and the output head take the configuration's
    own scales (``weights`` in its file), the rest ``std`` (0.02)."""
    g = generator(seed, "weights", device)
    dt = getattr(torch, model["dtype"])
    d, f, V, n = (model["d_model"], model["d_ff"], model["vocab_size"],
                  model["n_layers"])
    H, KV, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    std = scales.get("std", 0.02)

    def normal(shape, s):
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, s, generator=g)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    params = {"embed": normal((V, d), scales.get("embed_std", std)),
              "final_norm": ones(d)}
    if not model["tie_embeddings"]:
        params["lm_head"] = normal((d, V), scales.get("lm_head_std", std))
    params["classes"] = {"global": {
        "ln1": ones(n, d), "wq": normal((n, d, H * dh), std),
        "wk": normal((n, d, KV * dh), std), "wv": normal((n, d, KV * dh), std),
        "wo": normal((n, H * dh, d), std), "ln2": ones(n, d),
        "wg": normal((n, d, f), std), "wu": normal((n, d, f), std),
        "wd": normal((n, f, d), std)}}
    return params


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (``dim=None``) or one
    scale a slice along ``dim``, returned in float32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim, keepdim=True)
    scale = amax.clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def matmul(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
           ) -> torch.Tensor:
    """x [..., k] @ w [k, n] in float32 (``quant="fp8"``: both rounded)."""
    w = w.float()
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, None)
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * \
        scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x [B, T, H, dh] at positions 0..T-1."""
    T, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                        device=x.device) / dh))
    ang = (torch.arange(T, dtype=torch.float64, device=x.device)[:, None]
           * inv).float()
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, q_block: int = 512) -> torch.Tensor:
    """Causal softmax attention, q/k/v [B, T, H, dh] float32, in blocks of
    ``q_block`` query rows."""
    B, T, H, dh = q.shape
    kt = k.permute(0, 2, 3, 1)                         # [B, H, dh, T]
    vt = v.transpose(1, 2)                             # [B, H, T, dh]
    out = []
    for s in range(0, T, q_block):
        e = min(T, s + q_block)
        qb = q[:, s:e].transpose(1, 2)                 # [B, H, tb, dh]
        sc = (qb @ kt[..., :e]) * dh ** -0.5
        keep = (torch.arange(e, device=q.device)[None, :]
                <= torch.arange(s, e, device=q.device)[:, None])
        sc = sc.masked_fill(~keep, float("-inf"))
        out.append((torch.softmax(sc, -1) @ vt[:, :, :e]).transpose(1, 2))
    return torch.cat(out, 1)


def hidden_states(params, model: dict, tokens: torch.Tensor,
                  quant: Optional[str] = None) -> torch.Tensor:
    """tokens [B, T] -> hidden states before the final norm [B, T, d]
    float32 (the kNN-LM keys and queries)."""
    H, KV, dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    eps, theta = model["norm_eps"], model["rope_theta"]
    if H != KV:
        raise ValueError("the dense reference is written for MHA")
    layers = params["classes"]["global"]
    h = params["embed"][tokens.long()].float()
    B, T, _ = h.shape
    with no_tf32():
        for i in range(model["n_layers"]):
            p = {name: leaf[i] for name, leaf in layers.items()}
            x = rms_norm(h, p["ln1"], eps)
            q = rope(matmul(x, p["wq"], quant).view(B, T, H, dh), theta)
            k = rope(matmul(x, p["wk"], quant).view(B, T, KV, dh), theta)
            v = matmul(x, p["wv"], quant).view(B, T, KV, dh)
            h = h + matmul(attention(q, k, v).reshape(B, T, H * dh),
                           p["wo"], quant)
            x = rms_norm(h, p["ln2"], eps)
            g = torch.nn.functional.silu(matmul(x, p["wg"], quant))
            h = h + matmul(g * matmul(x, p["wu"], quant), p["wd"], quant)
    return h


def logits(params, model: dict, h: torch.Tensor,
           quant: Optional[str] = None) -> torch.Tensor:
    """Hidden states [..., d] -> logits [..., V] float32."""
    x = rms_norm(h, params["final_norm"], model["norm_eps"])
    head = params["embed"].T if model["tie_embeddings"] \
        else params["lm_head"]
    with no_tf32():
        return matmul(x, head, quant)
