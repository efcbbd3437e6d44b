"""The port's dense decoder against ``repro.models.transformer`` on the
reduced Dec-S config: prefill logits and hidden states, and a decode
wave over a slotted pool with ragged positions and a ``kv_len`` crop.

Same params (the reference's init, converted leaf for leaf) and same
tokens go through both. Float32 (``dataclasses.replace(cfg,
dtype="float32")``) tests the algorithm: 1e-5. bf16 rounds at the same
places in both packages but accumulates in another order, so values may
differ by a bf16 rounding or two: 2^-6 of the output range.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.models import transformer as ttf

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": None}


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, dtype):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    b = _np(b)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, **TOL[dtype])
    else:
        assert np.abs(a - b).max() <= 2 ** -6 * np.abs(b).max(), \
            np.abs(a - b).max()


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    jcfg = dataclasses.replace(get_arch("dec_s").reduced, dtype=request.param)
    tcfg = convert.model_config(dataclasses.asdict(jcfg))
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params(
        jax.tree.map(lambda x: np.array(x.astype(jnp.float32)), jp), tcfg)
    return request.param, jcfg, jp, tcfg, tp


def test_param_layout_converts_leaf_for_leaf(model):
    dtype, jcfg, jp, tcfg, tp = model
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jleaves) == sum(len(c) for c in tp["classes"].values()) + 2
    for path, leaf in jleaves:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype) == f"torch.{dtype}"
        np.testing.assert_array_equal(node.float().numpy(), _np(leaf))


def test_prefill_logits_and_hidden(model):
    dtype, jcfg, jp, tcfg, tp = model
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(3, 12)).astype(np.int32)
    jc = jtf.init_cache(jcfg, 3, 16)
    tc = ttf.init_cache(tcfg, 3, 16)
    jl, jc, jh = jtf.forward(jp, jcfg, tokens=jnp.asarray(toks),
                             mode="prefill", caches=jc, return_hidden=True)
    tl, tc, th = ttf.forward(tp, tcfg, torch.from_numpy(toks),
                             mode="prefill", caches=tc, return_hidden=True)
    _close(tl, jl, dtype)
    _close(th, jh, dtype)
    _close(tc["classes"]["global"]["k"], jc["classes"]["global"]["k"], dtype)


def test_decode_wave_over_slotted_pool(model):
    """Three rows living in pool slots [4, 1, 2] of a 6-row pool, at
    ragged positions, one decode wave; with and without a kv_len crop."""
    dtype, jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(1)
    P, S = 6, 32
    jpool, tpool = jtf.init_cache(jcfg, P, S), ttf.init_cache(tcfg, P, S)
    fill = rng.normal(size=jpool["classes"]["global"]["k"].shape
                      ).astype(np.float32)
    for key in ("k", "v"):
        jpool["classes"]["global"][key] = jnp.asarray(fill).astype(jcfg.dtype)
        tpool["classes"]["global"][key] = torch.from_numpy(
            _np(jpool["classes"]["global"][key])).to(tcfg.torch_dtype)
    slots = np.array([4, 1, 2], np.int32)
    pos = np.array([12, 3, 9], np.int32)
    tok = rng.integers(0, jcfg.vocab_size, size=(3, 1)).astype(np.int32)
    for kv_len in (None, 16):
        jl, jpool2, jh = jtf.decode_wave(
            jp, jcfg, jpool, jnp.asarray(tok), jnp.asarray(slots),
            jnp.asarray(pos), return_hidden=True, kv_len=kv_len)
        tcopy = {"classes": {"global": {
            k: v.clone() for k, v in tpool["classes"]["global"].items()}}}
        tl, tpool2, th = ttf.decode_wave(
            tp, tcfg, tcopy, torch.from_numpy(tok), torch.from_numpy(slots),
            torch.from_numpy(pos), return_hidden=True, kv_len=kv_len)
        _close(tl, jl, dtype)
        _close(th, jh, dtype)
        # the in-place pool update wrote the same rows the reference did
        _close(tpool2["classes"]["global"]["k"],
               jpool2["classes"]["global"]["k"], dtype)
