"""The paper's other three RALMs in the port against the JAX package:
Dec-L (a kNN-LM decoder) and the RETRO encoder-decoders EncDec-S and
EncDec-L, at their reduced sizes.

Registry fields, the parameter layout (the port's own init and the
reference's converted leaf for leaf), the encoder, train-mode and
prefill logits with encoder states, a decode wave over a slotted pool
with the wave's encoder rows, and prefill + decode against the
train-mode forward (the reference's
``test_smoke_prefill_decode_consistency``, 2e-2). Float32 tests the
algorithm (1e-5); bf16 rounds at the same places in both packages but
accumulates in another order: 2^-6 of the output range.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import transformer as ttf

ARCHS = ("dec_l", "encdec_s", "encdec_l")
ENCDEC = ("encdec_s", "encdec_l")
DTYPES = ("float32", "bfloat16")


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


def _leaves(tree, prefix=()):
    """{path: shape} of a nested dict of arrays / tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree.shape)}


def _pair(arch, dtype):
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
    return (arch, dtype) + _pair(arch, dtype)


def _enc_states(jcfg, jp, tcfg, tp, B, S, seed):
    """The same random encoder input through both packages' ``encode``."""
    x = np.random.default_rng(seed).normal(size=(B, S, jcfg.d_model)
                                           ).astype(np.float32)
    je = jtf.encode(jp, jcfg, jnp.asarray(x).astype(jcfg.dtype))
    te = ttf.encode(tp, tcfg, torch.from_numpy(_np(
        jnp.asarray(x).astype(jcfg.dtype))).to(tcfg.torch_dtype))
    return je, te


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_fields_equal_reference(arch):
    j, t = jax_arch(arch), get_arch(arch)
    assert t.name == j.name and t.source == j.source
    assert set(t.skip_shapes) == set(j.skip_shapes)
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
    assert dataclasses.asdict(t.reduced) == dataclasses.asdict(j.reduced)
    assert dataclasses.asdict(t.rag) == dataclasses.asdict(j.rag)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_reference_layout(arch):
    """The port's own init and the reference's: same leaf paths (the
    encoder tree and the cross-attention leaves of an encoder-decoder
    included) and shapes."""
    jcfg = jax_arch(arch).reduced
    tcfg = get_arch(arch).reduced
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttf.init_params(torch.Generator().manual_seed(0), tcfg)
    jl = {tuple(k.key for k in path): leaf.shape
          for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert _leaves(tp) == jl
    cross = {"lnx", "xwq", "xwk", "xwv", "xwo"}
    assert (cross <= set(tp["classes"]["global"])) == (arch in ENCDEC)
    assert ("encoder" in tp) == (arch in ENCDEC)


def test_converted_params_leaf_for_leaf(model):
    arch, dtype, jcfg, jp, tcfg, tp = model
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jleaves) == len(_leaves(tp))
    for path, leaf in jleaves:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype) == f"torch.{dtype}"
        np.testing.assert_array_equal(node.float().numpy(), _np(leaf))


def test_encode_and_forward_logits(model):
    """``encode`` (encoder-decoders), then the train-mode forward with
    those encoder states, and prefill's logits, hidden states and
    cross-KV cache."""
    arch, dtype, jcfg, jp, tcfg, tp = model
    B, T, S = 3, 12, 8
    je = te = None
    if jcfg.arch == "encdec":
        je, te = _enc_states(jcfg, jp, tcfg, tp, B, S, seed=3)
        assert tuple(te.shape) == (B, S, jcfg.d_model)
        _close(te, je, dtype)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    jl, _ = jtf.forward(jp, jcfg, tokens=jnp.asarray(toks), mode="train",
                        enc_states=je)
    tl, _ = ttf.forward(tp, tcfg, torch.from_numpy(toks), mode="train",
                        enc_states=te)
    _close(tl, jl, dtype)
    enc_len = S if jcfg.arch == "encdec" else 0
    jc = jtf.init_cache(jcfg, B, 16, enc_len=enc_len)
    tc = ttf.init_cache(tcfg, B, 16, enc_len=enc_len)
    jl, jc, jh = jtf.forward(jp, jcfg, tokens=jnp.asarray(toks),
                             mode="prefill", caches=jc, enc_states=je,
                             return_hidden=True)
    tl, tc, th = ttf.forward(tp, tcfg, torch.from_numpy(toks),
                             mode="prefill", caches=tc, enc_states=te,
                             return_hidden=True)
    _close(tl, jl, dtype)
    _close(th, jh, dtype)
    assert set(tc["classes"]["global"]) == set(jc["classes"]["global"])
    for key in tc["classes"]["global"]:
        _close(tc["classes"]["global"][key], jc["classes"]["global"][key],
               dtype)


def test_decode_wave_with_enc_states(model):
    """Three rows in pool slots [4, 1, 2] of a 6-row pool at ragged
    positions, one decode wave; an encoder-decoder's cross K/V are
    recomputed from the wave's encoder rows (a pool without ``xk``)."""
    arch, dtype, jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(1)
    P, S, W = 6, 32, 3
    jpool, tpool = jtf.init_cache(jcfg, P, S), ttf.init_cache(tcfg, P, S)
    assert set(tpool["classes"]["global"]) == {"k", "v"}
    fill = rng.normal(size=jpool["classes"]["global"]["k"].shape
                      ).astype(np.float32)
    for key in ("k", "v"):
        jpool["classes"]["global"][key] = jnp.asarray(fill).astype(jcfg.dtype)
        tpool["classes"]["global"][key] = torch.from_numpy(
            _np(jpool["classes"]["global"][key])).to(tcfg.torch_dtype)
    je = te = None
    if jcfg.arch == "encdec":
        je, te = _enc_states(jcfg, jp, tcfg, tp, W, 8, seed=4)
    slots = np.array([4, 1, 2], np.int32)
    pos = np.array([12, 3, 9], np.int32)
    tok = rng.integers(0, jcfg.vocab_size, size=(W, 1)).astype(np.int32)
    jl, jpool2, jh = jtf.decode_wave(
        jp, jcfg, jpool, jnp.asarray(tok), jnp.asarray(slots),
        jnp.asarray(pos), enc_states=je, return_hidden=True, kv_len=16)
    tl, tpool2, th = ttf.decode_wave(
        tp, tcfg, tpool, torch.from_numpy(tok), torch.from_numpy(slots),
        torch.from_numpy(pos), return_hidden=True, kv_len=16, enc_states=te)
    _close(tl, jl, dtype)
    _close(th, jh, dtype)
    _close(tpool2["classes"]["global"]["k"],
           jpool2["classes"]["global"]["k"], dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Prefill of T-1 tokens + one decode step agree with the train-mode
    forward's last logits (the port alone, the reference's 2e-2); an
    encoder-decoder caches its cross K/V at prefill (``enc_len`` 8)."""
    cfg = get_arch(arch).reduced
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    B, T = 2, 12
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g)
    enc_states, enc_len = None, 0
    if cfg.arch == "encdec":
        enc = torch.randn((B, 8, cfg.d_model), generator=g).to(torch.bfloat16)
        enc_states, enc_len = ttf.encode(params, cfg, enc), 8
    full, _ = ttf.forward(params, cfg, toks, mode="train",
                          enc_states=enc_states)
    caches = ttf.init_cache(cfg, B, max_seq=16, enc_len=enc_len)
    ttf.forward(params, cfg, toks[:, :-1], mode="prefill", caches=caches,
                enc_states=enc_states)
    lg, _ = ttf.decode_step(params, cfg, caches, toks[:, -1:],
                            torch.full((B,), T - 1), enc_states=enc_states)
    np.testing.assert_allclose(lg.float().numpy(),
                               full[:, -1].float().numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch,field", [
    ("dbrx_132b", "router"), ("hymba_1_5b", "mamba"), ("rwkv6_3b", "wkv"),
    ("phi3_5_moe_42b", "router")])
def test_other_families_init_layout_equals_reference(arch, field):
    """Every other block family (MoE, hybrid, RWKV-6) now initialises:
    the port's own params and caches have the reference's leaf paths,
    shapes and dtypes (the router and the Mamba head's float32 leaves
    included); ``field`` is a leaf only that family has."""
    jcfg = jax_arch(arch).reduced
    tcfg = convert.model_config(dataclasses.asdict(jcfg))
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttf.init_params(torch.Generator().manual_seed(0), tcfg)

    def leaves(tree):
        return {tuple(getattr(k, "key", getattr(k, "name", None))
                      for k in path): (tuple(x.shape), str(x.dtype))
                for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    jl = leaves(jp)
    tl = {p: (s, d.replace("torch.", "")) for p, (s, d) in leaves(tp).items()}
    assert tl == jl
    jc, tc = jtf.init_cache(jcfg, 3, 16), ttf.init_cache(tcfg, 3, 16)
    assert {p: (s, d.replace("torch.", "")) for p, (s, d)
            in leaves(tc).items()} == leaves(jc)
    names = {p[-1] for p in tl} | {p[-1] for p in leaves(tc)} | \
        {p[-2] for p in tl if len(p) > 2}
    assert field in names


def test_launcher_serves_dec_l_and_refuses_retro(capsys):
    """``--arch dec_l`` serves through the launcher (reduced, on the
    CPU); ``--arch encdec_*`` is refused before anything is built: the
    launcher's datastore has no chunk table."""
    from repro_torch.launch import serve as launch

    launch.main(["--arch", "dec_l", "--device", "cpu", "--reduced",
                 "--steps", "2", "--requests", "1"])
    assert "[serve] wave: 1 batches, 4 tokens" in capsys.readouterr().out
    for arch in ENCDEC:
        with pytest.raises(SystemExit):
            launch.parse_args(["--arch", arch, "--device", "cpu"])
        assert "no chunk table" in capsys.readouterr().err
