"""The dense assigned backbones in the port against the JAX package:
Qwen2-0.5B (GQA 14:2, QKV bias, tied), Phi-3-mini (MHA, untied),
Gemma-3-4B (5:1 local:global, ring caches on the local layers),
Llama-3-405B (GQA 128:8) and Qwen2-VL-72B (M-RoPE), at their reduced
sizes.

The registry (``ASSIGNED``, ``list_archs``, each config's fields), the
non-dense names' refusal, ``apply_mrope`` against the reference's with
three different position streams, and per backbone with the reference's
params converted leaf for leaf (QKV biases set to seeded non-zero
values first, or the bias path would add zeros): the train-mode
logits, and prefill followed by decode waves whose logits and hidden
states are held against the JAX ``decode_wave``'s; Gemma-3's positions
run past its window of 8, so its local rings wrap in prefill and in
decode. Float32 tests the algorithm (1e-5); bf16 rounds at the same
places in both packages but accumulates in another order: 2^-6 of the
output range.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.configs import get_arch as jax_arch
from repro.configs import list_archs as jax_list_archs
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

ARCHS = ("qwen2_0_5b", "phi3_mini_3_8b", "gemma3_4b", "llama3_405b",
         "qwen2_vl_72b")
NON_DENSE = ("seamless_m4t_medium", "hymba_1_5b", "dbrx_132b",
             "phi3_5_moe_42b", "rwkv6_3b")
DTYPES = ("float32", "bfloat16")
# one trace for every wave of a test (eager, each call traces the scan)
JAX_DECODE_WAVE = jax.jit(jtf.decode_wave, static_argnums=1,
                          static_argnames=("return_hidden", "kv_len"))


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, dtype):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    b = _np(b)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(a - b).max() <= 2 ** -6 * np.abs(b).max(), \
            np.abs(a - b).max()


def seeded_biases(jp, jcfg, seed=7):
    """The reference's params with every ``bq``/``bk``/``bv`` leaf set to
    seeded N(0, 0.5) values (both packages initialise them to zeros)."""
    if not jcfg.qkv_bias:
        return jp
    rng = np.random.default_rng(seed)
    classes = {}
    for cls, leaves in jp["classes"].items():
        leaves = dict(leaves)
        for name in ("bq", "bk", "bv"):
            leaves[name] = jnp.asarray(
                0.5 * rng.normal(size=leaves[name].shape), jnp.float32
            ).astype(leaves[name].dtype)
        classes[cls] = leaves
    return dict(jp, classes=classes)


def pair(arch, dtype, cfg=None):
    """(jcfg, jp, tcfg, tp): the reference's config at ``dtype`` (or
    ``cfg``), its params with seeded biases, and both converted."""
    jcfg = cfg or dataclasses.replace(jax_arch(arch).reduced, dtype=dtype)
    tcfg = convert.model_config(dataclasses.asdict(jcfg))
    jp = seeded_biases(jtf.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    tp = convert.lm_params(
        jax.tree.map(lambda x: np.array(x.astype(jnp.float32)), jp), tcfg)
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    arch, dtype = request.param
    return (arch, dtype) + pair(arch, dtype)


def test_assigned_names_and_shapes_equal_reference():
    assert tconfigs.ASSIGNED == JAX_ASSIGNED
    assert tconfigs.list_archs() == jax_list_archs()
    assert tconfigs.list_archs(include_paper=False) == \
        jax_list_archs(include_paper=False)
    from repro.configs import SHAPES
    assert tconfigs.SHAPES == SHAPES
    assert set(tconfigs.NOT_PORTED) == set(NON_DENSE)
    assert set(ARCHS) | set(NON_DENSE) == set(JAX_ASSIGNED)


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_fields_equal_reference(arch):
    j, t = jax_arch(arch), get_arch(arch)
    assert t.name == j.name and t.source == j.source
    assert set(t.skip_shapes) == set(j.skip_shapes)
    assert t.applicable_shapes() == j.applicable_shapes()
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
    assert dataclasses.asdict(t.reduced) == dataclasses.asdict(j.reduced)
    assert dataclasses.asdict(t.rag) == dataclasses.asdict(j.rag)
    assert t.rag.mode == "knnlm" and t.rag.interval == 1 and t.rag.k == 100


@pytest.mark.parametrize("arch", NON_DENSE)
def test_non_dense_get_arch_raises(arch):
    """The assigned backbones of the block families the port has not yet
    (MoE, hybrid, RWKV6, the audio encoder-decoder) raise, naming the
    ROADMAP item that ports them."""
    with pytest.raises(NotImplementedError, match="item 12b"):
        get_arch(arch)


@pytest.mark.parametrize("d_head,sections", [(16, (2, 3, 3)),
                                             (128, (16, 24, 24))])
def test_apply_mrope_matches_reference_with_distinct_streams(d_head,
                                                             sections):
    """Three different position streams (temporal, height, width), so a
    wrong section split shows; float32, 1e-6."""
    rng = np.random.default_rng(d_head)
    B, T, H = 2, 7, 3
    x = rng.normal(size=(B, T, H, d_head)).astype(np.float32)
    pos = np.stack([rng.integers(0, 50, size=(B, T)),
                    rng.integers(0, 9, size=(B, T)),
                    rng.integers(100, 400, size=(B, T))]).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                               sections)
    got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                              1e6, sections)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)
    # the dispatcher: [3, B, T] as given; each stream moves only its bands
    cfg = get_arch("qwen2_vl_72b").reduced
    if d_head == cfg.d_head:
        got2 = tlayers.positional_rotate(torch.from_numpy(x),
                                         torch.from_numpy(pos), cfg)
        np.testing.assert_array_equal(got2.numpy(), got.numpy())
    other = pos.copy()
    other[2] += 1                      # the width stream alone
    moved = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(other),
                                1e6, sections)
    changed = (moved != got).reshape(-1, d_head).any(0).numpy()
    half = d_head // 2
    band = np.zeros(half, bool)
    band[sum(sections[:2]):] = True
    assert (changed == np.concatenate([band, band])).all()
    with pytest.raises(ValueError, match="sum to"):
        tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            (1, 1, 1))


def test_mrope_with_equal_streams_is_rope():
    """Text: three equal streams (or a [B, T] input, which broadcasts)
    rotate exactly as 1-D RoPE."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 9, 4, 16)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 300, size=(2, 9)).astype(np.int32))
    cfg = get_arch("qwen2_vl_72b").reduced
    rope = tlayers.apply_rope(x, pos, cfg.rope_theta)
    three = tlayers.apply_mrope(x, pos[None].expand(3, 2, 9), cfg.rope_theta,
                                cfg.mrope_sections)
    torch.testing.assert_close(three, rope, rtol=0, atol=0)
    torch.testing.assert_close(tlayers.positional_rotate(x, pos, cfg), rope,
                               rtol=0, atol=0)


def test_converted_params_leaf_for_leaf(model):
    """Every leaf crosses (qwen2's non-zero biases, gemma3's local and
    global class stacks, phi3's untied ``lm_head``), and the port's own
    init has the same leaves."""
    arch, dtype, jcfg, jp, tcfg, tp = model
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    mine = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    n = 0
    for path, leaf in jleaves:
        node, own = tp, mine
        for k in path:
            node, own = node[k.key], own[k.key]
        assert tuple(node.shape) == tuple(own.shape) == leaf.shape
        assert str(node.dtype) == f"torch.{dtype}"
        np.testing.assert_array_equal(node.float().numpy(), _np(leaf))
        n += 1
    assert n == sum(len(c) for c in tp["classes"].values()) + 2 + \
        ("lm_head" in tp)
    assert ("lm_head" in tp) == (not jcfg.tie_embeddings)
    assert set(tp["classes"]) == set(jcfg.pattern_classes())
    if jcfg.qkv_bias:
        assert float(tp["classes"]["global"]["bq"].abs().max()) > 0.1


def test_forward_logits(model):
    """Train-mode logits; under M-RoPE also with three different position
    streams [3, B, T] through the whole model (masks follow the first)."""
    arch, dtype, jcfg, jp, tcfg, tp = model
    B, T = 2, 12
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    jl, _ = jtf.forward(jp, jcfg, tokens=jnp.asarray(toks), mode="train")
    tl, _ = ttf.forward(tp, tcfg, torch.from_numpy(toks), mode="train")
    _close(tl, jl, dtype)
    if jcfg.rope_mode == "mrope":
        t = np.broadcast_to(np.arange(T), (B, T))
        pos = np.stack([t, t // 4, t % 4]).astype(np.int32)
        jl, _ = jtf.forward(jp, jcfg, tokens=jnp.asarray(toks),
                            positions=jnp.asarray(pos), mode="train")
        tl, _ = ttf.forward(tp, tcfg, torch.from_numpy(toks),
                            positions=torch.from_numpy(pos), mode="train")
        _close(tl, jl, dtype)


def test_prefill_and_decode_waves(model):
    """Prefill 10 tokens into a 3-row pool, then 4 decode waves at
    positions 10-13 (kv_len 16 of a 32-slot pool), every wave's logits
    and hidden states and the pool after the last one against the JAX
    ``decode_wave``; gemma3's 8-slot rings wrap in both phases."""
    arch, dtype, jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(5)
    B, T0, S, steps = 3, 10, 32, 4
    toks = rng.integers(0, jcfg.vocab_size, size=(B, T0 + steps)
                        ).astype(np.int32)
    jc = jtf.init_cache(jcfg, B, S)
    tc = ttf.init_cache(tcfg, B, S)
    jl, jc = jtf.forward(jp, jcfg, tokens=jnp.asarray(toks[:, :T0]),
                         mode="prefill", caches=jc)
    tl, tc = ttf.forward(tp, tcfg, torch.from_numpy(toks[:, :T0]),
                         mode="prefill", caches=tc)
    _close(tl, jl, dtype)
    slots = np.array([2, 0, 1], np.int32)
    perm = np.argsort(slots)           # pool row r holds prompt row perm[r]
    # the wave reads pool rows out of order: permute both pools to match
    for leaves_t, leaves_j in ((tc["classes"], jc["classes"]),):
        for cls in leaves_t:
            for key in ("k", "v"):
                leaves_t[cls][key] = leaves_t[cls][key][:, perm].clone()
                leaves_j[cls][key] = leaves_j[cls][key][:, perm]
    for s in range(steps):
        pos = np.full((B,), T0 + s, np.int32)
        tok = toks[:, T0 + s:T0 + s + 1]
        jl, jc, jh = JAX_DECODE_WAVE(jp, jcfg, jc, jnp.asarray(tok),
                                     jnp.asarray(slots), jnp.asarray(pos),
                                     return_hidden=True, kv_len=16)
        tl, tc, th = ttf.decode_wave(tp, tcfg, tc, torch.from_numpy(tok),
                                     torch.from_numpy(slots),
                                     torch.from_numpy(pos),
                                     return_hidden=True, kv_len=16)
        _close(tl, jl, dtype)
        _close(th, jh, dtype)
    for cls in jcfg.pattern_classes():
        _close(tc["classes"][cls]["k"], jc["classes"][cls]["k"], dtype)
    if jcfg.window:
        assert tc["classes"]["local"]["k"].shape[2] == jcfg.window < T0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Prefill of T-1 tokens + one decode step agree with the train-mode
    forward's last logits (the port alone, the reference's 2e-2)."""
    cfg = get_arch(arch).reduced
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    B, T = 2, 12
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g)
    full, _ = ttf.forward(params, cfg, toks, mode="train")
    caches = ttf.init_cache(cfg, B, max_seq=16)
    ttf.forward(params, cfg, toks[:, :-1], mode="prefill", caches=caches)
    lg, _ = ttf.decode_step(params, cfg, caches, toks[:, -1:],
                            torch.full((B,), T - 1))
    np.testing.assert_allclose(lg.float().numpy(),
                               full[:, -1].float().numpy(),
                               rtol=2e-2, atol=2e-2)
