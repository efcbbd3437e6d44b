"""The dense decoder stack (twin of ``repro.models.transformer``).

Parameters keep the reference's layout leaf for leaf: ``embed``,
``final_norm`` (``lm_head`` when untied) and ``classes[cls][name]``,
each class's layers stacked on a leading axis
(``_init_block_class``, ``transformer.py:41``), so the JAX package's
params convert one to one (``repro_torch.convert``). Layers run in a
Python loop in stack order; caches are updated in place.

Modes: ``train`` (full sequence, no cache), ``prefill`` (full sequence,
fills the cache), ``decode`` (one token per row against the cache). This
slice serves the dense decoder family only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.models.attention import (flash_attention, prefill_cache,
                                          update_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (positional_rotate, rms_norm,
                                       rope_tables, swiglu)

Params = Dict[str, Any]


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.block != "dense" or cfg.arch != "decoder":
        raise NotImplementedError(
            f"repro_torch serves dense decoders; got block={cfg.block!r} "
            f"arch={cfg.arch!r}")


def _dense_init(gen: torch.Generator, shape, dtype, scale=0.02):
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def _init_block_class(gen: torch.Generator, cfg: ModelConfig, n: int
                      ) -> Params:
    """Stacked params for ``n`` layers of one class."""
    d, f = cfg.d_model, cfg.d_ff
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt, dev = cfg.torch_dtype, gen.device
    p: Params = {"ln1": torch.ones((n, d), dtype=dt, device=dev)}
    p["wq"] = _dense_init(gen, (n, d, H * dh), dt)
    p["wk"] = _dense_init(gen, (n, d, KV * dh), dt)
    p["wv"] = _dense_init(gen, (n, d, KV * dh), dt)
    p["wo"] = _dense_init(gen, (n, H * dh, d), dt)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, H * dh), dtype=dt, device=dev)
        p["bk"] = torch.zeros((n, KV * dh), dtype=dt, device=dev)
        p["bv"] = torch.zeros((n, KV * dh), dtype=dt, device=dev)
    p["ln2"] = torch.ones((n, d), dtype=dt, device=dev)
    p["wg"] = _dense_init(gen, (n, d, f), dt)
    p["wu"] = _dense_init(gen, (n, d, f), dt)
    p["wd"] = _dense_init(gen, (n, f, d), dt)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights (N(0, 0.02), norms at 1) on ``gen.device``."""
    _check_dense(cfg)
    dt, dev = cfg.torch_dtype, gen.device
    params: Params = {
        "embed": _dense_init(gen, (cfg.vocab_size, cfg.d_model), dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                        dt)
    params["classes"] = {
        cls: _init_block_class(gen, cfg, len(cfg.class_layers(cls)))
        for cls in cfg.pattern_classes()}
    return params


def init_cache(cfg: ModelConfig, B: int, max_seq: int,
               device="cpu") -> Params:
    """Per-class decode caches [n_layers_of_class, B, S, KV, dh]. Local
    (sliding) classes get ring buffers of ``cfg.window`` slots."""
    _check_dense(cfg)
    caches: Params = {"classes": {}}
    for cls in cfg.pattern_classes():
        n = len(cfg.class_layers(cls))
        S = cfg.window if (cls == "local" and cfg.window > 0) else max_seq
        shape = (n, B, S, cfg.n_kv_heads, cfg.d_head)
        caches["classes"][cls] = {
            "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}
    return caches


def _proj_qkv(cfg, p, x):
    B, T, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, T, cfg.n_heads, cfg.d_head),
            k.reshape(B, T, cfg.n_kv_heads, cfg.d_head),
            v.reshape(B, T, cfg.n_kv_heads, cfg.d_head))


def _self_attention(cfg, p, h, positions, mode, cache, window, slots=None,
                    kv_len=None, rope=None):
    """Returns attn_out [B, T, d]; fills ``cache`` in place.

    ``slots``: the cache is the KV pool and wave row ``w`` lives in pool
    row ``slots[w]``. ``kv_len`` crops every full-cache attention read
    to the wave's block-aligned valid prefix (ring caches never crop)."""
    B, T, _ = h.shape
    q, k, v = _proj_qkv(cfg, p, h)
    q = positional_rotate(q, positions, cfg, rope)
    k = positional_rotate(k, positions, cfg, rope)
    ring = window > 0
    if mode == "decode":
        update_cache(cache["k"], cache["v"], k, v, positions[:, 0],
                     ring=ring, slots=slots)
        out = decode_attention(q, cache["k"], cache["v"], positions[:, 0],
                               window=window, ring=ring, slots=slots,
                               kv_len=kv_len)
    else:
        out = flash_attention(q, k, v, positions, positions, causal=True,
                              window=window)
        if mode == "prefill":
            prefill_cache(cache["k"], cache["v"], k, v, ring=ring)
    return out.reshape(B, T, cfg.n_heads * cfg.d_head) @ p["wo"]


def apply_block(cfg: ModelConfig, p: Params, h: torch.Tensor,
                positions: torch.Tensor, mode: str, cache: Optional[Params],
                window: int, slots=None, kv_len=None, rope=None
                ) -> torch.Tensor:
    """One layer (pre-norm attention + gated MLP)."""
    hn = rms_norm(h, p["ln1"], cfg.norm_eps)
    h = h + _self_attention(cfg, p, hn, positions, mode, cache, window,
                            slots=slots, kv_len=kv_len, rope=rope)
    return h + swiglu(rms_norm(h, p["ln2"], cfg.norm_eps), p["wg"], p["wu"],
                      p["wd"], cfg.act)


def apply_stack(cfg: ModelConfig, classes_params: Params, h: torch.Tensor,
                positions: torch.Tensor, mode: str,
                caches: Optional[Params] = None, slots=None,
                kv_len=None) -> torch.Tensor:
    """All ``n_layers`` in stack order; layer ``i`` of class ``cls`` is
    index ``class_layers(cls).index(i)`` of that class's stacked leaves.
    The RoPE tables are computed once and shared by every layer."""
    rope = (rope_tables(positions, cfg.d_head, cfg.rope_theta)
            if cfg.rope_mode == "rope" else None)
    seen: Dict[str, int] = {}
    for cls in cfg.layer_classes():
        idx = seen.get(cls, 0)
        seen[cls] = idx + 1
        p = {name: a[idx] for name, a in classes_params[cls].items()}
        cache = (None if caches is None else
                 {name: a[idx] for name, a in caches["classes"][cls].items()})
        window = cfg.window if cls == "local" else 0
        h = apply_block(cfg, p, h, positions, mode, cache, window,
                        slots=slots, kv_len=kv_len, rope=rope)
    return h


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def unembed(params: Params, cfg: ModelConfig, h: torch.Tensor
            ) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head


def hidden_states(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  mode: str = "train", caches: Optional[Params] = None,
                  slots=None, kv_len=None) -> torch.Tensor:
    """The stack's output [B, T, d] before the final norm — the kNN-LM
    key/query — without the unembedding."""
    _check_dense(cfg)
    h = embed_tokens(params, tokens)
    B, T = h.shape[:2]
    if positions is None:
        positions = torch.arange(T, device=h.device)[None].expand(B, T)
    return apply_stack(cfg, params["classes"], h, positions, mode, caches,
                       slots=slots, kv_len=kv_len)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, mode: str = "train",
            caches: Optional[Params] = None, return_hidden: bool = False,
            slots=None, kv_len=None):
    """Full forward over ``tokens`` [B, T]. Returns (logits [B, T, V],
    caches[, hidden [B, T, d]]); ``caches`` are filled in place."""
    h = hidden_states(params, cfg, tokens, positions, mode, caches,
                      slots=slots, kv_len=kv_len)
    logits = unembed(params, cfg, h)
    if return_hidden:
        return logits, caches, h
    return logits, caches


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, caches: Params,
                token: torch.Tensor, position: torch.Tensor,
                return_hidden: bool = False):
    """One serving step over a request's own caches (the per-sequence
    loop): ``token`` [B, 1], ``position`` [B]; cache row ``b`` is request
    row ``b`` and every attention read covers the whole cache (no
    ``slots``, no ``kv_len`` crop). The caches are updated in place.
    Returns (logits [B, V], caches[, hidden [B, d]]); the hidden state is
    the retrieval query."""
    out = forward(params, cfg, token, positions=position[:, None],
                  mode="decode", caches=caches, return_hidden=return_hidden)
    if return_hidden:
        logits, caches, h = out
        return logits[:, 0], caches, h[:, 0]
    logits, caches = out
    return logits[:, 0], caches


@torch.no_grad()
def decode_wave(params: Params, cfg: ModelConfig, caches: Params,
                token: torch.Tensor, slots: torch.Tensor,
                position: torch.Tensor, return_hidden: bool = False,
                kv_len: Optional[int] = None):
    """One serving step for a whole wave over a slotted KV pool.

    ``caches`` hold the pool's P slot rows; ``token`` [W, 1], ``slots``
    [W] and ``position`` [W] describe the wave. The pool is updated in
    place. Returns (logits [W, V], caches[, hidden [W, d]])."""
    out = forward(params, cfg, token, positions=position[:, None],
                  mode="decode", caches=caches, return_hidden=return_hidden,
                  slots=slots, kv_len=kv_len)
    if return_hidden:
        logits, caches, h = out
        return logits[:, 0], caches, h[:, 0]
    logits, caches = out
    return logits[:, 0], caches
