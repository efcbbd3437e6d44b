"""The port's MoE FFN (``repro_torch.models.moe``) and gated-MLP
activation against the JAX package's, on the same numpy inputs.

Routing is float32 in both, so the chosen expert ids must be equal.
``moe_ffn`` is held within 1e-6 of the output range in float32 (the
two packages' GEMMs sum in other orders) and within 2^-6 of it in
bfloat16, at top-2 and top-4 (DBRX routes to four:
there the order in which a token's rows are added matters in bf16),
with SiLU and GELU, and in a case where a skewed router makes one
expert overflow its capacity, so that assignments are dropped. GELU is
the tanh form in both (``jax.nn.gelu``'s default).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close32(got, want, tol=1e-6):
    """float32: within ``tol`` of the output range (the two packages'
    GEMMs sum in other orders)."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _case(seed, N, d, f, E, skew=0.0):
    """Seeded x [N, d], router [d, E] (expert 0's column shifted by
    ``skew`` along x's mean direction) and expert weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, d)).astype(np.float32)
    router = rng.normal(scale=0.3, size=(d, E)).astype(np.float32)
    router[:, 0] += skew * np.sign(x.mean(0))
    wg = rng.normal(scale=0.2, size=(E, d, f)).astype(np.float32)
    wu = rng.normal(scale=0.2, size=(E, d, f)).astype(np.float32)
    wd = rng.normal(scale=0.2, size=(E, f, d)).astype(np.float32)
    return x, router, wg, wu, wd


def _both(arrays, dtype):
    """(jax arrays, torch tensors) at ``dtype``; the router stays f32."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    j = [jnp.asarray(a).astype(jnp.float32 if i == 1 else jdt)
         for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a).to(torch.float32 if i == 1 else tdt)
         for i, a in enumerate(arrays)]
    return j, t


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_route_topk_ids_exact(top_k):
    x, router, *_ = _case(top_k, 64, 32, 8, 16)
    jw, jids = jmoe.route_topk(jnp.asarray(x), jnp.asarray(router), top_k)
    tw, tids = tmoe.route_topk(torch.from_numpy(x), torch.from_numpy(router),
                               top_k)
    np.testing.assert_array_equal(tids.numpy(), np.array(jids))
    np.testing.assert_allclose(tw.numpy(), np.array(jw), rtol=1e-6,
                               atol=1e-6)
    assert tw.dtype == torch.float32


def test_route_topk_ties_take_the_lower_expert():
    """Equal logits: the lower expert id first, as ``lax.top_k``."""
    x = np.ones((3, 4), np.float32)
    router = np.zeros((4, 6), np.float32)
    router[:, 4] = 1.0
    _, jids = jmoe.route_topk(jnp.asarray(x), jnp.asarray(router), 3)
    _, tids = tmoe.route_topk(torch.from_numpy(x), torch.from_numpy(router),
                              3)
    np.testing.assert_array_equal(tids.numpy(), np.array(jids))
    assert tids[0].tolist() == [4, 0, 1]


@pytest.mark.parametrize("N,k,E", [(1, 2, 16), (7, 2, 16), (32, 2, 16),
                                   (32, 4, 16), (33, 4, 16), (1792, 2, 16),
                                   (5, 3, 4)])
def test_capacity_formula(N, k, E):
    """The reference's C = ceil(int(N k 1.25) / E), rounded up to 8."""
    want = int(max(1, -(-int(N * k * 1.25) // E)))
    assert tmoe.capacity(N, E, k) == -(-want // 8) * 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("top_k,skew", [(2, 0.0), (4, 0.0), (2, 3.0),
                                        (4, 3.0)],
                         ids=["top2", "top4", "top2-drops", "top4-drops"])
def test_moe_ffn_matches_reference(dtype, act, top_k, skew):
    N, d, f, E = (96, 32, 48, 8) if skew else (24, 32, 48, 8)
    arrays = _case(7 + top_k, N, d, f, E, skew)
    if skew:
        # the skewed router overflows expert 0: tokens are dropped
        _, ids = jmoe.route_topk(jnp.asarray(arrays[0]),
                                 jnp.asarray(arrays[1]), top_k)
        counts = np.bincount(np.array(ids).reshape(-1), minlength=E)
        assert counts.max() > tmoe.capacity(N, E, top_k)
    j, t = _both(arrays, dtype)
    want = _np(jmoe.moe_ffn(*j, top_k, act=act))
    got = tmoe.moe_ffn(*t, top_k, act=act)
    assert got.dtype == t[2].dtype and got.shape == (N, d)
    got = got.float().numpy()
    if dtype == "float32":
        _close32(got, want)
    else:
        assert np.abs(got - want).max() <= 2 ** -6 * np.abs(want).max()


def test_dropped_tokens_keep_zero_contribution():
    """One expert of capacity 8 and 16 tokens all routed to it (top-1):
    the first 8 tokens in order get the expert's output, the rest 0."""
    rng = np.random.default_rng(3)
    N, d, f, E = 16, 8, 12, 2
    x = np.abs(rng.normal(size=(N, d))).astype(np.float32)
    router = np.zeros((d, E), np.float32)
    router[:, 1] = 1.0
    wg, wu = (rng.normal(size=(E, d, f)).astype(np.float32) for _ in range(2))
    wd = rng.normal(size=(E, f, d)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, router, wg, wu, wd)]
    got = tmoe.moe_ffn(*args, top_k=1, capacity_factor=0.5)
    want = jmoe.moe_ffn(*(jnp.asarray(a) for a in (x, router, wg, wu, wd)),
                        top_k=1, capacity_factor=0.5)
    _close32(got.numpy(), np.array(want))
    assert tmoe.capacity(N, E, 1, 0.5) == 8
    assert (got[8:] == 0).all() and (got[:8] != 0).any(-1).all()


def test_moe_ffn_repeats_bit_equal():
    j, t = _both(_case(5, 64, 32, 48, 16), "bfloat16")
    a = tmoe.moe_ffn(*t, 4)
    b = tmoe.moe_ffn(*t, 4)
    assert torch.equal(a, b)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_swiglu_matches_reference(act):
    """float32, 1e-6: GELU is the tanh form on both sides (the exact erf
    form differs by up to ~4e-4)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(5, 7, 32)).astype(np.float32)
    wg, wu = (rng.normal(size=(32, 48)).astype(np.float32) for _ in range(2))
    wd = rng.normal(scale=0.2, size=(48, 32)).astype(np.float32)
    want = jlayers.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)), act)
    got = tlayers.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)),
                         act)
    _close32(got.numpy(), np.array(want))
    g = torch.linspace(-4, 4, 801)
    want_g = np.array(jlayers.jax.nn.gelu(jnp.asarray(g.numpy())))
    np.testing.assert_allclose(tlayers.activation(g, "gelu").numpy(), want_g,
                               rtol=1e-6, atol=1e-6)
