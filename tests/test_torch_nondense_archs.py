"""The non-dense assigned backbones in the port against the JAX package
at their reduced sizes: Hymba-1.5B (attention and a Mamba head in every
block, global and 8-slot ring layers), RWKV-6-3B (no attention: its
recurrent state is its cache), Phi-3.5-MoE and DBRX (MoE FFNs, 4
experts top-2 at this size), and SeamlessM4T-medium (a dense RETRO
encoder-decoder).

Per backbone, in float32 (1e-5; RWKV-6's chunked prefill 2e-5 of the
range, ``F32_RANGE_TOL``) and bfloat16 (2^-6 of the output range; 2^-5
for RWKV-6, ``BF16_TOL``): the
reference's params convert leaf for leaf, each keeping its
reference dtype (the MoE router and the Mamba head's ``a_log``,
``dt_bias``, ``d_skip`` stay float32 under bf16), and the port's own
init has the same leaves, shapes and dtypes; then a prefill of 3 rows
followed by 4 decode waves over a pool whose rows sit at slots
[2, 0, 1], every wave's logits and hidden states and the pool's leaves
after the last one (K/V and the recurrent state) held against the JAX
``decode_wave``'s. Hymba's prompts wrap its rings; RWKV-6's 64-token
prompt takes the chunked time mix, its decode steps the scan.

The pool (``KVCachePool``) with recurrent rows: ``grow_seq`` skips
RWKV-6's state and extends only K/V, ``grow_slots`` keeps every row,
and a reused slot carries nothing of the sequence before it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtf
from repro.serve.kvpool import KVCachePool as JaxPool
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import transformer as ttf
from repro_torch.serve import KVCachePool

ARCHS = ("hymba_1_5b", "rwkv6_3b", "phi3_5_moe_42b", "dbrx_132b",
         "seamless_m4t_medium")
DTYPES = ("float32", "bfloat16")
# bf16 tolerance, in parts of the output range: 2^-6, but 2^-5 for
# RWKV-6, whose 64-token prefill takes the chunked time mix. Its float32
# products of e^x and e^-x cancel, so the two packages' summation orders
# part by ~1e-5 of the range before the readout is rounded to bf16, and
# the flipped ulps then run through 4 layers: 1.62e-2 of the logits'
# range here (the scan path, 10-token prompts, is bit-equal to the
# reference in train mode).
BF16_TOL = {"rwkv6": 2 ** -5}
# float32 for RWKV-6's chunked prefill: within 2e-5 of each leaf's range
# (its chunked form and the reference's part from the exact scan by ~1e-5
# of the range each, tests/test_torch_ssm.py); 1e-5 elementwise otherwise
F32_RANGE_TOL = {"rwkv6": 2e-5}
JAX_DECODE_WAVE = jax.jit(jtf.decode_wave, static_argnums=1,
                          static_argnames=("return_hidden", "kv_len"))


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, dtype, tol=2 ** -6, f32_range_tol=None):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    b = _np(b)
    if dtype == "float32" and f32_range_tol is not None:
        assert np.abs(a - b).max() <= f32_range_tol * np.abs(b).max()
    elif dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), \
            np.abs(a - b).max()


def _key(k):
    return k.key if hasattr(k, "key") else k.name


def _node(tree, path):
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else getattr(tree, k)
    return tree


def _paths(tree):
    return [tuple(_key(k) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def pair(arch, dtype):
    jcfg = dataclasses.replace(jax_arch(arch).reduced, dtype=dtype)
    tcfg = convert.model_config(dataclasses.asdict(jcfg))
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params(
        jax.tree.map(lambda x: np.array(x.astype(jnp.float32)), jp), tcfg)
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    arch, dtype = request.param
    return (arch, dtype) + pair(arch, dtype)


def test_converted_params_leaf_for_leaf(model):
    arch, dtype, jcfg, jp, tcfg, tp = model
    mine = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert sorted(_paths(jp)) == sorted(_paths(tp)) == sorted(_paths(mine))
    f32 = set()
    for path, leaf in jleaves:
        path = tuple(_key(k) for k in path)
        node, own = _node(tp, path), _node(mine, path)
        want = "float32" if leaf.dtype == jnp.float32 else dtype
        assert tuple(node.shape) == tuple(own.shape) == leaf.shape
        assert str(node.dtype) == str(own.dtype) == f"torch.{want}", path
        np.testing.assert_array_equal(node.float().numpy(), _np(leaf))
        if leaf.dtype == jnp.float32 and dtype == "bfloat16":
            f32.add(path[-1])
    if dtype == "bfloat16":
        assert f32 == {"moe": {"router"},
                       "hybrid": {"a_log", "dt_bias", "d_skip"}}.get(
                           jcfg.block, set())
    if jcfg.block == "hybrid":
        assert type(tp["classes"]["global"]["mamba"]).__name__ == \
            "MambaParams"


def _all_leaves(caches):
    for cls, c in caches["classes"].items():
        for key in c:
            yield cls, key


def test_prefill_and_decode_waves(model):
    """Prefill T0 tokens into 3 rows, move them to pool slots [2, 0, 1],
    then 4 decode waves (kv_len 16 of an 80-slot pool); an
    encoder-decoder's cross-attention reads 8 encoder rows."""
    arch, dtype, jcfg, jp, tcfg, tp = model
    tol = BF16_TOL.get(jcfg.block, 2 ** -6)
    tol32 = F32_RANGE_TOL.get(jcfg.block)

    def close(a, b):
        _close(a, b, dtype, tol, tol32)
    rng = np.random.default_rng(5)
    B, S, steps = 3, 80, 4
    T0 = 64 if jcfg.block == "rwkv6" else 10
    toks = rng.integers(0, jcfg.vocab_size, size=(B, T0 + steps)
                        ).astype(np.int32)
    je = te = None
    if jcfg.arch == "encdec":
        x = rng.normal(size=(B, 8, jcfg.d_model)).astype(np.float32)
        xj = jnp.asarray(x).astype(jcfg.dtype)
        je = jtf.encode(jp, jcfg, xj)
        te = ttf.encode(tp, tcfg, torch.from_numpy(_np(xj)).to(
            tcfg.torch_dtype))
        close(te, je)
    jc = jtf.init_cache(jcfg, B, S)
    tc = ttf.init_cache(tcfg, B, S)
    assert sorted(_all_leaves(jc)) == sorted(_all_leaves(tc))
    jl, jc = jtf.forward(jp, jcfg, tokens=jnp.asarray(toks[:, :T0]),
                         mode="prefill", caches=jc, enc_states=je)
    tl, tc = ttf.forward(tp, tcfg, torch.from_numpy(toks[:, :T0]),
                         mode="prefill", caches=tc, enc_states=te)
    close(tl, jl)
    slots = np.array([2, 0, 1], np.int32)
    perm = np.argsort(slots)           # pool row r holds prompt row perm[r]
    for cls, key in _all_leaves(tc):
        assert tc["classes"][cls][key].dtype == {
            "float32": torch.float32, "bfloat16": torch.bfloat16}[
                str(jc["classes"][cls][key].dtype)]
        close(tc["classes"][cls][key], jc["classes"][cls][key])
        tc["classes"][cls][key] = tc["classes"][cls][key][:, perm].clone()
        jc["classes"][cls][key] = jc["classes"][cls][key][:, perm]
    for s in range(steps):
        pos = np.full((B,), T0 + s, np.int32)
        tok = toks[:, T0 + s:T0 + s + 1]
        jl, jc, jh = JAX_DECODE_WAVE(jp, jcfg, jc, jnp.asarray(tok),
                                     jnp.asarray(slots), jnp.asarray(pos),
                                     enc_states=je, return_hidden=True,
                                     kv_len=16)
        tl, tc, th = ttf.decode_wave(tp, tcfg, tc, torch.from_numpy(tok),
                                     torch.from_numpy(slots),
                                     torch.from_numpy(pos),
                                     return_hidden=True, kv_len=16,
                                     enc_states=te)
        close(tl, jl)
        close(th, jh)
    for cls, key in _all_leaves(tc):
        close(tc["classes"][cls][key], jc["classes"][cls][key])
    if jcfg.window:
        assert tc["classes"]["local"]["k"].shape[2] == jcfg.window < T0
    assert ttf.attention_layers(tcfg) == (0 if jcfg.block == "rwkv6"
                                          else jcfg.n_layers)


@pytest.mark.parametrize("arch", ["rwkv6_3b", "hymba_1_5b"])
def test_pool_growth_and_reuse_with_recurrent_rows(arch):
    """``grow_seq`` extends K/V only (RWKV-6 has none: no KeyError) and
    the reference's pool ends with the same leaf shapes; ``grow_slots``
    keeps every written row; a freed slot, reused, holds the new
    sequence's state only."""
    cfg = get_arch(arch).reduced
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    pool = KVCachePool(cfg, capacity=2, max_seq=16, seq_block=16)
    jpool = JaxPool(jax_arch(arch).reduced, capacity=2, max_seq=16,
                    seq_block=16)
    g = torch.Generator().manual_seed(1)

    def prefill(n):
        caches = ttf.init_cache(cfg, n, pool.max_seq)
        toks = torch.randint(0, cfg.vocab_size, (n, 9), generator=g)
        ttf.forward(params, cfg, toks, mode="prefill", caches=caches)
        return caches

    first = prefill(2)
    slots = pool.alloc(2)
    pool.write_prefill(slots, first)
    pool.grow_seq(40)
    jpool.grow_seq(40)
    pool.grow_slots(4)
    jpool.grow_slots(4)
    assert pool.max_seq == jpool.max_seq == 48
    for cls, key in _all_leaves(pool.caches):
        a = pool.caches["classes"][cls][key]
        assert tuple(a.shape) == jpool.caches["classes"][cls][key].shape
        assert a.shape[1] == 5
        src = first["classes"][cls][key]
        if key in ("k", "v") and a.shape[2] != src.shape[2]:
            torch.testing.assert_close(a[:, :2, :src.shape[2]], src,
                                       rtol=0, atol=0)
            assert (a[:, :2, src.shape[2]:] == 0).all()
        else:
            torch.testing.assert_close(a[:, :2], src, rtol=0, atol=0)
    state = "wkv" if cfg.block == "rwkv6" else "ssm"
    cls = cfg.pattern_classes()[0]
    assert pool.caches["classes"][cls][state][:, 0].abs().sum() > 0
    # free slot 0 and hand it to a new one-row sequence
    pool.release(slots[:1])
    again = pool.alloc(1)
    assert again.tolist() == [0]
    second = prefill(1)
    pool.write_prefill(again, second)
    for cls, key in _all_leaves(pool.caches):
        got = pool.caches["classes"][cls][key][:, 0]
        want = second["classes"][cls][key][:, 0]
        if key in ("k", "v"):
            got = got[:, :want.shape[1]]
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("field,value", [("block", "retnet"),
                                         ("arch", "encoder"),
                                         ("rope_mode", "alibi")])
def test_other_blocks_still_raise(field, value):
    """The four block families are served; any other block, arch or
    position mode raises before a tensor is made."""
    cfg = dataclasses.replace(get_arch("rwkv6_3b").reduced, **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        ttf.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match=field):
        ttf.init_cache(cfg, 2, 16)
