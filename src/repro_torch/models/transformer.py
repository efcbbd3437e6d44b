"""The dense decoder stack (twin of ``repro.models.transformer``).

Parameters keep the reference's layout leaf for leaf: ``embed``,
``final_norm`` (``lm_head`` when untied) and ``classes[cls][name]``,
each class's layers stacked on a leading axis
(``_init_block_class``, ``transformer.py:41``), so the JAX package's
params convert one to one (``repro_torch.convert``). Layers run in a
Python loop in stack order; caches are updated in place.

Modes: ``train`` (full sequence, no cache), ``prefill`` (full sequence,
fills the cache), ``decode`` (one token per row against the cache). The
port serves dense decoders (the paper's Dec-S and Dec-L; the assigned
Qwen2-0.5B, Phi-3-mini, Gemma-3-4B with its local ring layers,
Llama-3-405B, and Qwen2-VL-72B's backbone with M-RoPE, whose positions
are [3, B, T]) and dense encoder-decoders (RETRO: EncDec-S and
EncDec-L). An encoder-decoder's
decoder layers carry a cross-attention (``lnx``, ``xwq``/``xwk``/``xwv``/
``xwo``) over ``enc_states``, the output of ``encode`` over the
retrieved chunks; it runs after the self-attention and before the MLP.

The encoder's and the cross-attention's attention is the plain
``flash_attention`` (the reference's is plain jnp too, no Pallas). The
reference blocks its KV axis by 512 with an online softmax; here the
whole score row is one softmax, so for encoder widths above 512 (RETRO's
K x chunk_len = 640) the two round the softmax weights differently.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.models.attention import (flash_attention, prefill_cache,
                                          update_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (position_tables, positional_rotate,
                                       rms_norm, rope_tables, swiglu)

Params = Dict[str, Any]


def _check_dense(cfg: ModelConfig) -> None:
    """Dense decoders and dense encoder-decoders with RoPE, M-RoPE (or no
    positions) are served; every other block family (MoE, hybrid, RWKV6)
    is ROADMAP Queue 1 item 12b."""
    if cfg.block != "dense" or cfg.arch not in ("decoder", "encdec") or \
            cfg.rope_mode not in ("rope", "mrope", "none"):
        raise NotImplementedError(
            f"repro_torch serves dense decoders and dense encoder-decoders "
            f"(RoPE or M-RoPE); got block={cfg.block!r} arch={cfg.arch!r} "
            f"rope_mode={cfg.rope_mode!r} (the other block families: "
            f"ROADMAP Queue 1 item 12b)")


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's own config: ``n_enc_layers`` dense layers at the
    decoder's widths (the reference builds the same one)."""
    return ModelConfig(
        name=cfg.name + "-enc", n_layers=cfg.n_enc_layers,
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab_size=cfg.vocab_size,
        d_head=cfg.d_head, block="dense", qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps, act=cfg.act,
        dtype=cfg.dtype)


def _dense_init(gen: torch.Generator, shape, dtype, scale=0.02):
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def _init_block_class(gen: torch.Generator, cfg: ModelConfig, n: int,
                      cross: bool = False) -> Params:
    """Stacked params for ``n`` layers of one class; ``cross`` adds the
    cross-attention's leaves (encoder-decoder layers)."""
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
    if cross:
        p["lnx"] = torch.ones((n, d), dtype=dt, device=dev)
        p["xwq"] = _dense_init(gen, (n, d, H * dh), dt)
        p["xwk"] = _dense_init(gen, (n, d, KV * dh), dt)
        p["xwv"] = _dense_init(gen, (n, d, KV * dh), dt)
        p["xwo"] = _dense_init(gen, (n, H * dh, d), dt)
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
    encdec = cfg.arch == "encdec"
    params["classes"] = {
        cls: _init_block_class(gen, cfg, len(cfg.class_layers(cls)),
                               cross=encdec)
        for cls in cfg.pattern_classes()}
    if encdec:
        params["encoder"] = {
            "classes": {"global": _init_block_class(
                gen, _enc_cfg(cfg), cfg.n_enc_layers)},
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev)}
    return params


def init_cache(cfg: ModelConfig, B: int, max_seq: int,
               device="cpu", enc_len: int = 0) -> Params:
    """Per-class decode caches [n_layers_of_class, B, S, KV, dh]. Local
    (sliding) classes get ring buffers of ``cfg.window`` slots. An
    encoder-decoder with ``enc_len > 0`` also caches the cross K/V
    (``xk``/``xv`` [n, B, enc_len, KV, dh], filled at prefill); with
    ``enc_len=0`` (the serving engine's choice) decode recomputes them
    from ``enc_states`` every step."""
    _check_dense(cfg)
    dt = cfg.torch_dtype
    caches: Params = {"classes": {}}
    for cls in cfg.pattern_classes():
        n = len(cfg.class_layers(cls))
        S = cfg.window if (cls == "local" and cfg.window > 0) else max_seq
        shape = (n, B, S, cfg.n_kv_heads, cfg.d_head)
        c = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
        if cfg.arch == "encdec" and enc_len > 0:
            xshape = (n, B, enc_len, cfg.n_kv_heads, cfg.d_head)
            c["xk"] = torch.zeros(xshape, dtype=dt, device=device)
            c["xv"] = torch.zeros(xshape, dtype=dt, device=device)
        caches["classes"][cls] = c
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
    to the wave's block-aligned valid prefix (ring caches never crop).
    Under M-RoPE ``positions`` are [3, B, T]; cache slots, validity and
    masks follow the first (temporal) stream, as in the reference."""
    B, T, _ = h.shape
    q, k, v = _proj_qkv(cfg, p, h)
    pos1d = positions[0] if positions.ndim == 3 else positions
    q = positional_rotate(q, positions, cfg, rope)
    k = positional_rotate(k, positions, cfg, rope)
    ring = window > 0
    if mode == "decode":
        update_cache(cache["k"], cache["v"], k, v, pos1d[:, 0],
                     ring=ring, slots=slots)
        out = decode_attention(q, cache["k"], cache["v"], pos1d[:, 0],
                               window=window, ring=ring, slots=slots,
                               kv_len=kv_len)
    else:
        out = flash_attention(q, k, v, pos1d, pos1d, causal=True,
                              window=window)
        if mode == "prefill":
            prefill_cache(cache["k"], cache["v"], k, v, ring=ring)
    return out.reshape(B, T, cfg.n_heads * cfg.d_head) @ p["wo"]


def _cross_attention(cfg, p, h, enc_states, mode, cache, slots=None):
    """Cross-attention over the encoder states (RETRO), with its own
    pre-norm ``lnx``; returns ``h + out @ xwo``. Decode reads the cached
    cross K/V when the cache has them (gathered to the wave's rows under
    ``slots``), else recomputes them from ``enc_states`` [B, S, d]
    (already the wave's rows). Prefill fills a cross cache in place."""
    B, T, _ = h.shape
    hn = rms_norm(h, p["lnx"], cfg.norm_eps)
    q = (hn @ p["xwq"]).reshape(B, T, cfg.n_heads, cfg.d_head)
    if mode == "decode" and cache is not None and "xk" in cache:
        xk, xv = cache["xk"], cache["xv"]
        if slots is not None:
            idx = torch.as_tensor(slots, device=xk.device).long()
            xk, xv = xk[idx], xv[idx]
    else:
        S = enc_states.shape[1]
        xk = (enc_states @ p["xwk"]).reshape(B, S, cfg.n_kv_heads,
                                             cfg.d_head)
        xv = (enc_states @ p["xwv"]).reshape(B, S, cfg.n_kv_heads,
                                             cfg.d_head)
    S = xk.shape[1]
    qpos = torch.zeros((B, T), dtype=torch.int32, device=h.device)
    kpos = torch.arange(S, device=h.device)[None].expand(B, S)
    out = flash_attention(q, xk, xv, qpos, kpos, causal=False)
    if mode == "prefill" and cache is not None and "xk" in cache:
        cache["xk"].copy_(xk.to(cache["xk"].dtype))
        cache["xv"].copy_(xv.to(cache["xv"].dtype))
    return h + out.reshape(B, T, cfg.n_heads * cfg.d_head) @ p["xwo"]


def apply_block(cfg: ModelConfig, p: Params, h: torch.Tensor,
                positions: torch.Tensor, mode: str, cache: Optional[Params],
                window: int, slots=None, kv_len=None, rope=None,
                enc_states=None) -> torch.Tensor:
    """One layer: pre-norm self-attention, the cross-attention when the
    layer has one and ``enc_states`` are given, the gated MLP."""
    hn = rms_norm(h, p["ln1"], cfg.norm_eps)
    h = h + _self_attention(cfg, p, hn, positions, mode, cache, window,
                            slots=slots, kv_len=kv_len, rope=rope)
    if enc_states is not None and "xwq" in p:
        h = _cross_attention(cfg, p, h, enc_states, mode, cache, slots=slots)
    return h + swiglu(rms_norm(h, p["ln2"], cfg.norm_eps), p["wg"], p["wu"],
                      p["wd"], cfg.act)


def apply_stack(cfg: ModelConfig, classes_params: Params, h: torch.Tensor,
                positions: torch.Tensor, mode: str,
                caches: Optional[Params] = None, slots=None,
                kv_len=None, enc_states=None) -> torch.Tensor:
    """All ``n_layers`` in stack order; layer ``i`` of class ``cls`` is
    index ``class_layers(cls).index(i)`` of that class's stacked leaves.
    The rotation tables (RoPE, or M-RoPE's from its per-frequency
    positions) are computed once and shared by every layer."""
    rope = position_tables(positions, cfg, cfg.d_head)
    seen: Dict[str, int] = {}
    for cls in cfg.layer_classes():
        idx = seen.get(cls, 0)
        seen[cls] = idx + 1
        p = {name: a[idx] for name, a in classes_params[cls].items()}
        cache = (None if caches is None else
                 {name: a[idx] for name, a in caches["classes"][cls].items()})
        window = cfg.window if cls == "local" else 0
        h = apply_block(cfg, p, h, positions, mode, cache, window,
                        slots=slots, kv_len=kv_len, rope=rope,
                        enc_states=enc_states)
    return h


def encode(params: Params, cfg: ModelConfig, enc_embeds: torch.Tensor
           ) -> torch.Tensor:
    """The encoder: ``n_enc_layers`` bidirectional dense layers over
    ``enc_embeds`` [B, S, d] (the embedded retrieved chunks), then the
    encoder's final norm -> ``enc_states`` [B, S, d]."""
    _check_dense(cfg)
    enc_cfg = _enc_cfg(cfg)
    B, S, _ = enc_embeds.shape
    pos = torch.arange(S, device=enc_embeds.device)[None].expand(B, S)
    rope = rope_tables(pos, cfg.d_head, cfg.rope_theta)
    h = enc_embeds
    stacked = params["encoder"]["classes"]["global"]
    for idx in range(cfg.n_enc_layers):
        p = {name: a[idx] for name, a in stacked.items()}
        hn = rms_norm(h, p["ln1"], cfg.norm_eps)
        q, k, v = _proj_qkv(enc_cfg, p, hn)
        q = positional_rotate(q, pos, enc_cfg, rope)
        k = positional_rotate(k, pos, enc_cfg, rope)
        out = flash_attention(q, k, v, pos, pos, causal=False)
        h = h + out.reshape(B, S, cfg.n_heads * cfg.d_head) @ p["wo"]
        h = h + swiglu(rms_norm(h, p["ln2"], cfg.norm_eps), p["wg"],
                       p["wu"], p["wd"], cfg.act)
    return rms_norm(h, params["encoder"]["final_norm"], cfg.norm_eps)


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
                  slots=None, kv_len=None, enc_states=None) -> torch.Tensor:
    """The stack's output [B, T, d] before the final norm — the kNN-LM
    key/query — without the unembedding. ``enc_states`` [B, S, d] feed
    an encoder-decoder's cross-attention (without them its decoder runs
    alone)."""
    _check_dense(cfg)
    h = embed_tokens(params, tokens)
    B, T = h.shape[:2]
    if positions is None:
        positions = torch.arange(T, device=h.device)[None].expand(B, T)
    return apply_stack(cfg, params["classes"], h, positions, mode, caches,
                       slots=slots, kv_len=kv_len, enc_states=enc_states)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, mode: str = "train",
            caches: Optional[Params] = None, return_hidden: bool = False,
            slots=None, kv_len=None, enc_states=None):
    """Full forward over ``tokens`` [B, T]. Returns (logits [B, T, V],
    caches[, hidden [B, T, d]]); ``caches`` are filled in place."""
    h = hidden_states(params, cfg, tokens, positions, mode, caches,
                      slots=slots, kv_len=kv_len, enc_states=enc_states)
    logits = unembed(params, cfg, h)
    if return_hidden:
        return logits, caches, h
    return logits, caches


def _step_positions(cfg: ModelConfig, position: torch.Tensor
                    ) -> torch.Tensor:
    """A decode step's positions: [B, 1], or [3, B, 1] under M-RoPE
    (three equal streams: text)."""
    pos = position[:, None]
    if cfg.rope_mode == "mrope":
        pos = pos[None].expand((3,) + pos.shape)
    return pos


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, caches: Params,
                token: torch.Tensor, position: torch.Tensor,
                return_hidden: bool = False, enc_states=None):
    """One serving step over a request's own caches (the per-sequence
    loop): ``token`` [B, 1], ``position`` [B]; cache row ``b`` is request
    row ``b`` and every attention read covers the whole cache (no
    ``slots``, no ``kv_len`` crop). The caches are updated in place.
    Returns (logits [B, V], caches[, hidden [B, d]]); the hidden state is
    the retrieval query. ``enc_states`` [B, S, d]: the request's encoder
    states (an encoder-decoder)."""
    out = forward(params, cfg, token, positions=_step_positions(cfg,
                                                                position),
                  mode="decode", caches=caches, return_hidden=return_hidden,
                  enc_states=enc_states)
    if return_hidden:
        logits, caches, h = out
        return logits[:, 0], caches, h[:, 0]
    logits, caches = out
    return logits[:, 0], caches


@torch.no_grad()
def decode_wave(params: Params, cfg: ModelConfig, caches: Params,
                token: torch.Tensor, slots: torch.Tensor,
                position: torch.Tensor, return_hidden: bool = False,
                kv_len: Optional[int] = None, enc_states=None):
    """One serving step for a whole wave over a slotted KV pool.

    ``caches`` hold the pool's P slot rows; ``token`` [W, 1], ``slots``
    [W] and ``position`` [W] describe the wave; ``enc_states`` (an
    encoder-decoder) are already gathered to the wave's rows [W, S, d].
    The pool is updated in place. Returns (logits [W, V], caches[,
    hidden [W, d]])."""
    out = forward(params, cfg, token, positions=_step_positions(cfg,
                                                                position),
                  mode="decode", caches=caches, return_hidden=return_hidden,
                  slots=slots, kv_len=kv_len, enc_states=enc_states)
    if return_hidden:
        logits, caches, h = out
        return logits[:, 0], caches, h[:, 0]
    logits, caches = out
    return logits[:, 0], caches
