"""The decoder stack (twin of ``repro.models.transformer``).

Parameters keep the reference's layout leaf for leaf: ``embed``,
``final_norm`` (``lm_head`` when untied) and ``classes[cls][name]``,
each class's layers stacked on a leading axis
(``_init_block_class``, ``transformer.py:41``), so the JAX package's
params convert one to one (``repro_torch.convert``). Layers run in a
Python loop in stack order; caches are updated in place.

Modes: ``train`` (full sequence, no cache), ``prefill`` (full sequence,
fills the cache), ``decode`` (one token per row against the cache).
The four block families of the reference are served: ``dense`` (the
paper's Dec-S and Dec-L; Qwen2-0.5B, Phi-3-mini, Gemma-3-4B with its
local ring layers, Llama-3-405B, and Qwen2-VL-72B's backbone with
M-RoPE, whose positions are [3, B, T]), ``moe`` (Phi-3.5-MoE, DBRX:
the FFN is ``moe.moe_ffn``), ``hybrid`` (Hymba: one normed input
through attention and through ``ssm.mamba_scan``, the two outputs
normed and averaged) and ``rwkv6`` (RWKV-6: time mix and channel mix,
no attention), and dense encoder-decoders (RETRO: EncDec-S, EncDec-L,
SeamlessM4T-medium). An encoder-decoder's decoder layers carry a
cross-attention (``lnx``, ``xwq``/``xwk``/``xwv``/``xwo``) over
``enc_states``, the output of ``encode`` over the retrieved chunks; it
runs after the self-attention and before the MLP.

Recurrent state (RWKV-6's ``wkv``/``st``/``sc``, the hybrid's
``ssm``/``conv``) lives in the caches beside K/V. Over a slotted pool a
wave gathers its rows by ``slots`` and writes them back in place; pad
rows share the scratch slot, the only row written twice.

The encoder's and the cross-attention's attention, and train and prefill
self-attention, is ``flash_attention``: plain PyTorch as the reference's
is plain jnp (no Pallas), blocked by 512 with an online softmax and the
reference's FA2 backward.

Training: ``lm_loss`` is the reference's next-token cross-entropy over
``forward`` in train mode, from tokens or from ``embeds`` (Qwen2-VL's
vision stub), with an encoder-decoder's ``enc_embeds`` through
``encode``. ``remat=True`` recomputes each ``layer_pattern`` cycle in the
backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint(apply_cycle)``); the layers of a last partial cycle
keep their activations, as the reference's unrolled tail does.

Sharded training (a ``models.ctx`` context with a mesh group and the
parameters' specs; ``launch.steps.build_train_step`` sets it): every
leaf is read through ``parallel.leaf``, so a layer gathers its leaves
over the data axis when it runs (and, under remat, again in the
backward) and frees them after. Over the model axis a layer computes
split where its leaves are split on head or column boundaries
(``TP_GROUPS``): the attention by heads, the gated MLP by ``d_ff``
columns, each between ``copy_to_model`` and ``reduce_from_model``; the
embedding and the head by vocabulary rows, with the cross-entropy from
all-reduced maxima and sums. Any other leaf split over "model" (a head
cut in two, Mamba's, RWKV-6's and the MoE's leaves) is gathered whole
and computed replicated. The layers read the layout they got from their
leaves' shapes.

Sharded prefill and serving (``launch.steps``' builders with a rank
group of more than one): the leaves are read as in training, and each
rank's caches hold a range of the sequence (``parallel.seq_shard``), all
KV heads. A layer gathers the new token's K/V heads (and its query's)
over the model axis, writes the K/V into the rank that owns the
position, attends over its own slots in the decode kernel's partial mode
and merges the ranks' float32 partials (``_split_attention``), then
keeps its own heads for the row-split ``wo``. Prefill computes a layer's
K/V as in training and keeps the rank's slot range; RETRO's cross K/V
are split and read the same way, every slot valid.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attn.ops import (decode_attention,
                                                 decode_attention_partial)
from repro_torch.kernels.decode_attn.ref import merge_partials
from repro_torch.models import ctx as ctx_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import parallel
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import (flash_attention, prefill_cache,
                                          update_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (add_norm, position_tables,
                                       positional_rotate,
                                       rms_norm, rope_tables, swiglu)

Params = Dict[str, Any]

BLOCKS = ("dense", "moe", "hybrid", "rwkv6")
#: leaves the reference keeps in float32 whatever ``cfg.dtype`` is
FLOAT32_LEAVES = frozenset({"router", "a_log", "dt_bias", "d_skip"})
#: leaves a layer computes split over the model axis, by group: (split
#: by column, the output dim; split by row, the input dim). A group runs
#: split only when every leaf of it is split so (attention: also on head
#: boundaries); else its leaves are gathered.
TP_GROUPS = {
    "attn": (("wq", "wk", "wv", "bq", "bk", "bv"), ("wo",)),
    "xattn": (("xwq", "xwk", "xwv"), ("xwo",)),
    "mlp": (("wg", "wu"), ("wd",)),
}


def _check_block(cfg: ModelConfig) -> None:
    """The reference's block families (dense, MoE, hybrid attention and
    Mamba, RWKV-6), in decoders and encoder-decoders, with RoPE, M-RoPE or
    no positions; anything else raises."""
    if cfg.block not in BLOCKS or cfg.arch not in ("decoder", "encdec") or \
            cfg.rope_mode not in ("rope", "mrope", "none"):
        raise NotImplementedError(
            f"repro_torch serves the blocks {BLOCKS} in decoders and "
            f"encoder-decoders (RoPE, M-RoPE or none); got "
            f"block={cfg.block!r} arch={cfg.arch!r} "
            f"rope_mode={cfg.rope_mode!r}")


def attention_layers(cfg: ModelConfig) -> int:
    """Decoder layers that run decode attention (RWKV-6 has none)."""
    return 0 if cfg.block == "rwkv6" else cfg.n_layers


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


def _init_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where ``init_params`` puts the leaves: the generator's device, or
    the meta device (shapes and dtypes, no values) when ``gen`` is None."""
    return torch.device("meta") if gen is None else gen.device


def _dense_init(gen: Optional[torch.Generator], shape, dtype, scale=0.02):
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def _init_block_class(gen: torch.Generator, cfg: ModelConfig, n: int,
                      cross: bool = False) -> Params:
    """Stacked params for ``n`` layers of one class; ``cross`` adds the
    cross-attention's leaves (encoder-decoder layers)."""
    d, f = cfg.d_model, cfg.d_ff
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt, dev = cfg.torch_dtype, _init_device(gen)
    f32 = torch.float32

    def ones(*shape, dtype=dt):
        return torch.ones((n,) + shape, dtype=dtype, device=dev)

    if cfg.block == "rwkv6":
        D = H * dh

        def v(*shape, scale=0.02):
            return _dense_init(gen, (n,) + shape, dt, scale)
        return dict(
            ln1=ones(d), ln2=ones(d),
            mu_r=v(d, scale=0.5), mu_k=v(d, scale=0.5),
            mu_v=v(d, scale=0.5), mu_g=v(d, scale=0.5),
            mu_w=v(d, scale=0.5),
            w_r=v(d, D), w_k=v(d, D), w_v=v(d, D), w_g=v(d, D), w_o=v(D, d),
            w0=v(D, scale=0.5), w_lora_a=v(d, 64), w_lora_b=v(64, D),
            bonus_u=v(H, dh, scale=0.5), ln_x=ones(D),
            mu_ck=v(d, scale=0.5), mu_cr=v(d, scale=0.5),
            w_ck=v(d, f), w_cv=v(f, d), w_cr=v(d, d))
    p: Params = {"ln1": ones(d)}
    p["wq"] = _dense_init(gen, (n, d, H * dh), dt)
    p["wk"] = _dense_init(gen, (n, d, KV * dh), dt)
    p["wv"] = _dense_init(gen, (n, d, KV * dh), dt)
    p["wo"] = _dense_init(gen, (n, H * dh, d), dt)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n, H * dh), dtype=dt, device=dev)
        p["bk"] = torch.zeros((n, KV * dh), dtype=dt, device=dev)
        p["bv"] = torch.zeros((n, KV * dh), dtype=dt, device=dev)
    p["ln2"] = ones(d)
    if cfg.block == "moe":
        E = cfg.n_experts
        p["router"] = _dense_init(gen, (n, d, E), f32)
        p["wg"] = _dense_init(gen, (n, E, d, f), dt)
        p["wu"] = _dense_init(gen, (n, E, d, f), dt)
        p["wd"] = _dense_init(gen, (n, E, f, d), dt)
    else:
        p["wg"] = _dense_init(gen, (n, d, f), dt)
        p["wu"] = _dense_init(gen, (n, d, f), dt)
        p["wd"] = _dense_init(gen, (n, f, d), dt)
    if cfg.block == "hybrid":
        d_in, ds, cw = H * dh, cfg.ssm_state, cfg.conv_width
        p["mamba"] = ssm_lib.MambaParams(
            w_in=_dense_init(gen, (n, d, 2 * d_in), dt),
            conv_w=_dense_init(gen, (n, cw, d_in), dt, 0.2),
            w_bcdt=_dense_init(gen, (n, d_in, 2 * ds + H), dt),
            a_log=torch.zeros((n, H, ds), dtype=f32, device=dev),
            dt_bias=torch.zeros((n, H), dtype=f32, device=dev),
            d_skip=ones(H, dtype=f32),
            w_out=_dense_init(gen, (n, d_in, d), dt))
        p["ln_attn_out"] = ones(d)
        p["ln_ssm_out"] = ones(d)
    if cross:
        p["lnx"] = torch.ones((n, d), dtype=dt, device=dev)
        p["xwq"] = _dense_init(gen, (n, d, H * dh), dt)
        p["xwk"] = _dense_init(gen, (n, d, KV * dh), dt)
        p["xwv"] = _dense_init(gen, (n, d, KV * dh), dt)
        p["xwo"] = _dense_init(gen, (n, H * dh, d), dt)
    return p


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig) -> Params:
    """Random weights (N(0, 0.02), norms at 1; the reference's scales and
    float32 leaves) on ``gen.device``. ``gen=None`` gives the abstract
    params: every leaf on the meta device, nothing drawn or allocated
    (the reference's ``jax.eval_shape`` of ``init_params``)."""
    _check_block(cfg)
    dt, dev = cfg.torch_dtype, _init_device(gen)
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
    (sliding) classes get ring buffers of ``cfg.window`` slots. RWKV-6
    caches its recurrent state instead (``wkv`` [n, B, H, dh, dh]
    float32, the shifts ``st``/``sc`` [n, B, d]); a hybrid block adds the
    Mamba state beside K/V (``ssm`` [n, B, H, dh, ssm_state] float32,
    ``conv`` [n, B, conv_width - 1, H * dh]). An encoder-decoder with
    ``enc_len > 0`` also caches the cross K/V (``xk``/``xv`` [n, B,
    enc_len, KV, dh], filled at prefill); with ``enc_len=0`` (the
    serving engine's choice) decode recomputes them from ``enc_states``
    every step."""
    _check_block(cfg)
    dt = cfg.torch_dtype
    H, dh, d = cfg.n_heads, cfg.d_head, cfg.d_model

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    caches: Params = {"classes": {}}
    for cls in cfg.pattern_classes():
        n = len(cfg.class_layers(cls))
        if cfg.block == "rwkv6":
            caches["classes"][cls] = {
                "wkv": zeros(n, B, H, dh, dh, dtype=torch.float32),
                "st": zeros(n, B, d), "sc": zeros(n, B, d)}
            continue
        S = cfg.window if (cls == "local" and cfg.window > 0) else max_seq
        shape = (n, B, S, cfg.n_kv_heads, cfg.d_head)
        c = {"k": zeros(*shape), "v": zeros(*shape)}
        if cfg.block == "hybrid":
            c["ssm"] = zeros(n, B, H, dh, cfg.ssm_state, dtype=torch.float32)
            c["conv"] = zeros(n, B, cfg.conv_width - 1, H * dh)
        if cfg.arch == "encdec" and enc_len > 0:
            xshape = (n, B, enc_len, cfg.n_kv_heads, cfg.d_head)
            c["xk"] = torch.zeros(xshape, dtype=dt, device=device)
            c["xv"] = torch.zeros(xshape, dtype=dt, device=device)
        caches["classes"][cls] = c
    return caches


def _tp_leaves(cfg: ModelConfig, prefix: str, stacked: Params) -> set:
    """The leaves of ``stacked`` (at tree key ``prefix``) that the layer
    computes split over the model axis (``TP_GROUPS``)."""
    M = parallel.model_size()
    if M == 1:
        return set()
    heads = cfg.n_heads % M == 0 and cfg.n_kv_heads % M == 0
    keep = set()
    for group, (cols, rows) in TP_GROUPS.items():
        names = [n for n in cols + rows if n in stacked]
        if not names or (group == "mlp" and cfg.block == "moe") or \
                (group != "mlp" and not heads):
            continue
        if all(parallel.split_on(f"{prefix}/{n}", -1 if n in cols else -2,
                                 stacked[n].dim()) for n in names):
            keep.update(names)
    return keep


def _layer_params(cfg: ModelConfig, prefix: str, stacked: Params,
                  idx: int) -> Params:
    """Layer ``idx`` of the stacked leaves at tree key ``prefix`` (a
    NamedTuple of stacked leaves, as the hybrid's ``mamba``, gives a
    NamedTuple of layer leaves); in a sharded step each through
    ``parallel.leaf``."""
    if not parallel.sharded():
        return {name: type(a)(*(x[idx] for x in a))
                if isinstance(a, tuple) else a[idx]
                for name, a in stacked.items()}
    keep = _tp_leaves(cfg, prefix, stacked)
    out = {}
    for name, a in stacked.items():
        if isinstance(a, tuple):        # a NamedTuple of stacked leaves
            out[name] = type(a)(*(
                parallel.leaf(f"{prefix}/{name}/{f}", x[idx], stacked=True)
                for f, x in zip(a._fields, a)))
        else:
            out[name] = parallel.leaf(f"{prefix}/{name}", a[idx],
                                      keep_model=name in keep, stacked=True)
    return out


def _tp_in(x: torch.Tensor, tp: bool) -> torch.Tensor:
    return parallel.copy_to_model(x) if tp else x


def _tp_out(y: torch.Tensor, tp: bool) -> torch.Tensor:
    return parallel.reduce_from_model(y) if tp else y


def _proj_qkv(cfg, p, x):
    """(q [B, T, H, dh], k, v [B, T, KV, dh]); a model-split layer gets
    its own heads only."""
    B, T, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, -1, cfg.d_head)
    k = k.reshape(B, T, -1, cfg.d_head)
    v = v.reshape(B, T, -1, cfg.d_head)
    tag = "model" if q.shape[2] != cfg.n_heads else None
    ctx_lib.constrain(q, "dp", None, tag, None,
                      full=(None, None, cfg.n_heads, cfg.d_head))
    ctx_lib.constrain(k, "dp", None, tag, None,
                      full=(None, None, cfg.n_kv_heads, cfg.d_head))
    return q, k, v


def _split_attention(q, k_cache, v_cache, position, seq):
    """Decode attention over a cache whose sequence is split over
    ``seq.group``: this rank's partial over its slot range, every rank's
    partial all-gathered (one [R, W, H, D + 2] float32 buffer), merged in
    rank order. q [W, 1, H, D] (all heads) -> [W, 1, H, D] in the cache
    dtype."""
    off = seq.offset(k_cache.shape[1])
    acc, m, l = decode_attention_partial(q, k_cache, v_cache, position,
                                         slot_offset=off)
    D = acc.shape[-1]
    buf = torch.cat([acc, m[..., None], l[..., None]], -1)[None]
    every = seq.group.all_gather(buf.contiguous(), 0)
    out = merge_partials(every[..., :D], every[..., D], every[..., D + 1])
    return out.to(v_cache.dtype)[:, None]


def _self_attention(cfg, p, h, positions, mode, cache, window, slots=None,
                    kv_len=None, rope=None, seq=None):
    """Returns attn_out [B, T, d]; fills ``cache`` in place.

    ``slots``: the cache is the KV pool and wave row ``w`` lives in pool
    row ``slots[w]``. ``kv_len`` crops every full-cache attention read
    to the wave's block-aligned valid prefix (ring caches never crop).
    Under M-RoPE ``positions`` are [3, B, T]; cache slots, validity and
    masks follow the first (temporal) stream, as in the reference.

    ``seq`` (``parallel.SeqShard``): the cache holds this rank's range of
    a sequence split over ranks, every KV head (a linear cache, no
    window, not the pool)."""
    B, T, _ = h.shape
    tp = p["wq"].shape[-1] != cfg.n_heads * cfg.d_head
    q, k, v = _proj_qkv(cfg, p, _tp_in(h, tp))
    pos1d = positions[0] if positions.ndim == 3 else positions
    q = positional_rotate(q, positions, cfg, rope)
    k = positional_rotate(k, positions, cfg, rope)
    ring = window > 0
    if seq is not None:
        off = seq.offset(cache["k"].shape[1])
        if mode != "decode":
            out = flash_attention(q, k, v, pos1d, pos1d, causal=True,
                                  window=window)
        if tp:          # every head's K/V (and the query) on every rank
            k, v = parallel.gather_model(k, 2), parallel.gather_model(v, 2)
        if mode == "decode":
            update_cache(cache["k"], cache["v"], k, v, pos1d[:, 0],
                         slot_offset=off)
            out = _split_attention(parallel.gather_model(q, 2) if tp else q,
                                   cache["k"], cache["v"], pos1d[:, 0], seq)
            out = parallel.model_chunk(out, 2) if tp else out
        else:
            prefill_cache(cache["k"], cache["v"], k, v, slot_offset=off)
        return _tp_out(out.reshape(B, T, -1) @ p["wo"], tp)
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
    return _tp_out(out.reshape(B, T, -1) @ p["wo"], tp)


def _cross_attention(cfg, p, hn, enc_states, mode, cache, slots=None,
                     seq=None):
    """Cross-attention over the encoder states (RETRO) of ``hn``, the
    input normed by ``lnx``; returns ``out @ xwo``. Decode reads the
    cached cross K/V when the cache has them (gathered to the wave's rows
    under ``slots``), else recomputes them from ``enc_states`` [B, S, d]
    (already the wave's rows). Prefill fills a cross cache in place.
    ``seq``: the cross cache holds this rank's range of the encoder
    positions (every KV head); decode merges the ranks' partials, every
    slot valid."""
    B, T, _ = hn.shape
    tp = p["xwq"].shape[-1] != cfg.n_heads * cfg.d_head
    q = (_tp_in(hn, tp) @ p["xwq"]).reshape(B, T, -1, cfg.d_head)
    if seq is not None and mode == "decode":
        xk, xv = cache["xk"], cache["xv"]
        last = torch.full((B,), xk.shape[1] * seq.group.size - 1,
                          dtype=torch.int32, device=hn.device)
        out = _split_attention(parallel.gather_model(q, 2) if tp else q,
                               xk, xv, last, seq)
        out = parallel.model_chunk(out, 2) if tp else out
        return _tp_out(out.reshape(B, T, -1) @ p["xwo"], tp)
    if mode == "decode" and cache is not None and "xk" in cache:
        xk, xv = cache["xk"], cache["xv"]
        if slots is not None:
            idx = torch.as_tensor(slots, device=xk.device).long()
            xk, xv = xk[idx], xv[idx]
    else:
        S = enc_states.shape[1]
        enc = _tp_in(enc_states, tp)
        xk = (enc @ p["xwk"]).reshape(B, S, -1, cfg.d_head)
        xv = (enc @ p["xwv"]).reshape(B, S, -1, cfg.d_head)
    S = xk.shape[1]
    qpos = torch.zeros((B, T), dtype=torch.int32, device=hn.device)
    kpos = torch.arange(S, device=hn.device)[None].expand(B, S)
    out = flash_attention(q, xk, xv, qpos, kpos, causal=False)
    if mode == "prefill" and cache is not None and "xk" in cache:
        if seq is not None:
            n = cache["xk"].shape[1]
            off = seq.offset(n)
            if tp:
                xk, xv = (parallel.gather_model(xk, 2),
                          parallel.gather_model(xv, 2))
            xk, xv = xk[:, off:off + n], xv[:, off:off + n]
        cache["xk"].copy_(xk.to(cache["xk"].dtype))
        cache["xv"].copy_(xv.to(cache["xv"].dtype))
    return _tp_out(out.reshape(B, T, -1) @ p["xwo"], tp)


def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The block's FFN: the gated MLP, or the MoE over the flattened
    tokens (the capacity follows B * T)."""
    if cfg.block == "moe":
        B, T, d = x.shape
        out = moe_lib.moe_ffn(x.reshape(B * T, d), p["router"], p["wg"],
                              p["wu"], p["wd"], cfg.top_k, act=cfg.act)
        return out.reshape(B, T, d).to(x.dtype)
    return _mlp(cfg, p, x)


def _mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The gated MLP; a model-split layer computes its ``d_ff`` columns
    and all-reduces."""
    tp = p["wg"].shape[-1] != cfg.d_ff
    return _tp_out(swiglu(_tp_in(x, tp), p["wg"], p["wu"], p["wd"],
                          cfg.act), tp)


def _rows(cache: Params, keys, slots) -> list:
    """The wave's state rows of ``cache[key]`` (all rows without
    ``slots``)."""
    if slots is None:
        return [cache[key] for key in keys]
    idx = torch.as_tensor(slots, device=cache[keys[0]].device).long()
    return [cache[key][idx] for key in keys]


def _write_rows(cache: Params, rows: Dict[str, torch.Tensor], slots) -> None:
    """Write state rows back into ``cache`` in place (by ``slots``)."""
    idx = None if slots is None else torch.as_tensor(
        slots, device=next(iter(rows.values())).device).long()
    for key, val in rows.items():
        if idx is None:
            cache[key].copy_(val)
        else:
            cache[key][idx] = val.to(cache[key].dtype)


def _residual_norm(cfg: ModelConfig, h: torch.Tensor, y: torch.Tensor,
                   scale: torch.Tensor):
    """(h + y, its RMS norm). The non-dense blocks norm the sum before it
    is rounded, as XLA does (``layers.add_norm``): without it a bf16 ulp
    flips a near-tied expert choice, or an RWKV-6 token, against the JAX
    engine. Dense blocks norm the rounded sum: their tokens equal the
    JAX engine's either way, and with the unrounded sum the reduced
    Llama-3's tokens on the card parted from the CPU's at a near tie."""
    if cfg.block == "dense":
        h = h + y
        return h, rms_norm(h, scale, cfg.norm_eps)
    return add_norm(h, y, scale, cfg.norm_eps)


def _rwkv6_block(cfg: ModelConfig, p: Params, h: torch.Tensor,
                 cache: Optional[Params], slots) -> torch.Tensor:
    """RWKV-6: time mix then channel mix, each pre-normed and residual;
    the state starts from the cache's rows (zeros without a cache) and
    goes back into them."""
    rp = ssm_lib.RWKV6Params(**{f: p[f] for f in ssm_lib.RWKV6Params._fields})
    if cache is not None:
        st = ssm_lib.RWKVState(*_rows(cache, ("wkv", "st", "sc"), slots))
    else:
        st = ssm_lib.rwkv6_init_state(h.shape[0], cfg.n_heads, cfg.d_head,
                                      cfg.d_model, h.dtype, h.device)
    y, wkv, sh_t = ssm_lib.rwkv6_time_mix_chunked(
        rp, rms_norm(h, p["ln1"], cfg.norm_eps), st, cfg.n_heads)
    h, hn = _residual_norm(cfg, h, y, p["ln2"])
    y2, sh_c = ssm_lib.rwkv6_channel_mix(rp, hn, st.shift_c)
    if cache is not None:
        _write_rows(cache, dict(wkv=wkv, st=sh_t, sc=sh_c), slots)
    return h + y2


def apply_block(cfg: ModelConfig, p: Params, h: torch.Tensor,
                positions: torch.Tensor, mode: str, cache: Optional[Params],
                window: int, slots=None, kv_len=None, rope=None,
                enc_states=None, seq=None) -> torch.Tensor:
    """One layer: pre-norm self-attention (a hybrid block also runs the
    normed input through the Mamba head and averages the two normed
    outputs), the cross-attention when the layer has one and
    ``enc_states`` are given, the FFN (gated MLP or MoE). RWKV-6 layers
    are ``_rwkv6_block``. ``seq``: cache leaf name -> its
    ``parallel.SeqShard`` (a sequence split over ranks)."""
    if cfg.block == "rwkv6":
        return _rwkv6_block(cfg, p, h, cache, slots)
    seq = seq or {}
    hn = rms_norm(h, p["ln1"], cfg.norm_eps)
    attn_out = _self_attention(cfg, p, hn, positions, mode, cache, window,
                               slots=slots, kv_len=kv_len, rope=rope,
                               seq=seq.get("k"))
    if cfg.block == "hybrid":
        state = (None if cache is None
                 else tuple(_rows(cache, ("ssm", "conv"), slots)))
        ssm_out, (ssm_s, conv_s) = ssm_lib.mamba_scan(p["mamba"], hn, state)
        attn_out = 0.5 * (rms_norm(attn_out, p["ln_attn_out"], cfg.norm_eps)
                          + rms_norm(ssm_out, p["ln_ssm_out"], cfg.norm_eps))
        if cache is not None:
            _write_rows(cache, dict(ssm=ssm_s, conv=conv_s), slots)
    if enc_states is not None and "xwq" in p:
        h, hx = _residual_norm(cfg, h, attn_out, p["lnx"])
        attn_out = _cross_attention(cfg, p, hx, enc_states, mode, cache,
                                    slots=slots, seq=seq.get("xk"))
    h, hn = _residual_norm(cfg, h, attn_out, p["ln2"])
    return h + _ffn(cfg, p, hn)


def apply_stack(cfg: ModelConfig, classes_params: Params, h: torch.Tensor,
                positions: torch.Tensor, mode: str,
                caches: Optional[Params] = None, slots=None,
                kv_len=None, enc_states=None, remat: bool = False
                ) -> torch.Tensor:
    """All ``n_layers`` in stack order; layer ``i`` of class ``cls`` is
    index ``class_layers(cls).index(i)`` of that class's stacked leaves.
    The rotation tables (RoPE, or M-RoPE's from its per-frequency
    positions) are computed once and shared by every layer. ``remat``
    checkpoints each full ``layer_pattern`` cycle."""
    rope = position_tables(positions, cfg, cfg.d_head)
    seen: Dict[str, int] = {}
    layers = []
    for cls in cfg.layer_classes():
        idx = seen.get(cls, 0)
        seen[cls] = idx + 1
        layers.append((cls, idx))

    def run(h, chunk):
        for cls, idx in chunk:
            p = _layer_params(cfg, f"classes/{cls}", classes_params[cls],
                              idx)
            cache = (None if caches is None else
                     {name: a[idx]
                      for name, a in caches["classes"][cls].items()})
            window = cfg.window if cls == "local" else 0
            seq = None if cache is None or not parallel.sharded() else {
                name: parallel.seq_shard(f"classes/{cls}/{name}")
                for name in ("k", "xk") if name in cache}
            h = apply_block(cfg, p, h, positions, mode, cache, window,
                            slots=slots, kv_len=kv_len, rope=rope,
                            enc_states=enc_states, seq=seq)
            ctx_lib.constrain(h, "dp", None, None,
                              full=(None, None, cfg.d_model))
        return h

    period = len(cfg.layer_pattern)
    n_full = len(layers) // period * period
    if remat:
        for c in range(0, n_full, period):
            h = checkpoint(run, h, layers[c:c + period], use_reentrant=False,
                           context_fn=ctx_lib.recompute_context())
        return run(h, layers[n_full:])
    return run(h, layers)


def encode(params: Params, cfg: ModelConfig, enc_embeds: torch.Tensor
           ) -> torch.Tensor:
    """The encoder: ``n_enc_layers`` bidirectional dense layers over
    ``enc_embeds`` [B, S, d] (the embedded retrieved chunks), then the
    encoder's final norm -> ``enc_states`` [B, S, d]."""
    _check_block(cfg)
    enc_cfg = _enc_cfg(cfg)
    B, S, _ = enc_embeds.shape
    pos = torch.arange(S, device=enc_embeds.device)[None].expand(B, S)
    rope = rope_tables(pos, cfg.d_head, cfg.rope_theta)
    h = enc_embeds
    stacked = params["encoder"]["classes"]["global"]
    for idx in range(cfg.n_enc_layers):
        p = _layer_params(enc_cfg, "encoder/classes/global", stacked, idx)
        hn = rms_norm(h, p["ln1"], cfg.norm_eps)
        tp = p["wq"].shape[-1] != cfg.n_heads * cfg.d_head
        q, k, v = _proj_qkv(enc_cfg, p, _tp_in(hn, tp))
        q = positional_rotate(q, pos, enc_cfg, rope)
        k = positional_rotate(k, pos, enc_cfg, rope)
        out = flash_attention(q, k, v, pos, pos, causal=False)
        h = h + _tp_out(out.reshape(B, S, -1) @ p["wo"], tp)
        h = h + _mlp(enc_cfg, p, rms_norm(h, p["ln2"], cfg.norm_eps))
    return rms_norm(h, parallel.leaf("encoder/final_norm",
                                     params["encoder"]["final_norm"]),
                    cfg.norm_eps)


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows of ``embed``. Split by vocabulary over the model
    axis, each rank looks up the tokens in its rows (zeros elsewhere) and
    the rows are all-reduced."""
    split = parallel.split_on("embed", 0, 2)
    table = parallel.leaf("embed", params["embed"], keep_model=split)
    tokens = tokens.long()
    if not split:
        return table[tokens]
    n = table.shape[0]
    local = tokens - parallel.model_rank() * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return parallel.reduce_from_model(torch.where(mine[..., None], rows, 0))


def unembed(params: Params, cfg: ModelConfig, h: torch.Tensor
            ) -> torch.Tensor:
    """Logits [..., V]; split by vocabulary over the model axis, this
    rank's columns [..., V / M]."""
    h = rms_norm(h, parallel.leaf("final_norm", params["final_norm"]),
                 cfg.norm_eps)
    if cfg.tie_embeddings:
        split = parallel.split_on("embed", 0, 2)
        head = parallel.leaf("embed", params["embed"], keep_model=split).T
    else:
        split = parallel.split_on("lm_head", 1, 2)
        head = parallel.leaf("lm_head", params["lm_head"], keep_model=split)
    return _tp_in(h, split) @ head


def hidden_states(params: Params, cfg: ModelConfig,
                  tokens: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None,
                  mode: str = "train", caches: Optional[Params] = None,
                  slots=None, kv_len=None, enc_states=None,
                  embeds: Optional[torch.Tensor] = None,
                  remat: bool = False) -> torch.Tensor:
    """The stack's output [B, T, d] before the final norm — the kNN-LM
    key/query — without the unembedding. ``embeds`` [B, T, d] stand in
    for the token lookup (a modality stub). ``enc_states`` [B, S, d]
    feed an encoder-decoder's cross-attention (without them its decoder
    runs alone)."""
    _check_block(cfg)
    h = embed_tokens(params, tokens) if embeds is None else embeds
    B, T = h.shape[:2]
    if positions is None:
        positions = torch.arange(T, device=h.device)[None].expand(B, T)
    return apply_stack(cfg, params["classes"], h, positions, mode, caches,
                       slots=slots, kv_len=kv_len, enc_states=enc_states,
                       remat=remat)


def forward(params: Params, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None, mode: str = "train",
            caches: Optional[Params] = None, return_hidden: bool = False,
            slots=None, kv_len=None, enc_states=None,
            embeds: Optional[torch.Tensor] = None, remat: bool = False):
    """Full forward over ``tokens`` [B, T] or ``embeds`` [B, T, d].
    Returns (logits [B, T, V], caches[, hidden [B, T, d]]); ``caches``
    are filled in place."""
    h = hidden_states(params, cfg, tokens, positions, mode, caches,
                      slots=slots, kv_len=kv_len, enc_states=enc_states,
                      embeds=embeds, remat=remat)
    logits = unembed(params, cfg, h)
    if return_hidden:
        return logits, caches, h
    return logits, caches


def nll_sum(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            remat: bool = True):
    """(the summed next-token negative log-likelihood over the valid
    labels, their count): ``lm_loss`` before its division, which a
    data-parallel step sums over ranks first."""
    enc_states = (encode(params, cfg, batch["enc_embeds"])
                  if "enc_embeds" in batch else None)
    logits, _ = forward(params, cfg, batch.get("tokens"),
                        positions=batch.get("positions"), mode="train",
                        enc_states=enc_states, embeds=batch.get("embeds"),
                        remat=remat)
    labels = batch["labels"].long()
    logits = logits.float()
    mask = labels >= 0
    if logits.shape[-1] == cfg.vocab_size:
        lse = torch.logsumexp(logits, -1)
        ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    else:                           # this rank's vocabulary columns
        n = logits.shape[-1]
        mx = parallel.max_over_model(logits.amax(-1))
        lse = torch.log(parallel.reduce_from_model(
            torch.exp(logits - mx[..., None]).sum(-1))) + mx
        local = labels - parallel.model_rank() * n
        mine = (local >= 0) & (local < n)
        ll = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        ll = parallel.reduce_from_model(torch.where(mine, ll, 0.0))
    return ((lse - ll) * mask).sum(), mask.sum()


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy, the mean over valid tokens (labels < 0
    are ignored). ``batch``: "tokens" [B, T] or "embeds" [B, T, d],
    "labels" [B, T], optional "positions" ([B, T], or [3, B, T] under
    M-RoPE) and "enc_embeds" [B, S, d] (an encoder-decoder's retrieved
    chunks, through ``encode``)."""
    total, count = nll_sum(params, cfg, batch, remat)
    return total / count.clamp(min=1)


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
