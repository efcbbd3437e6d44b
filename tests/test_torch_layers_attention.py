"""The port's layers and attention against the JAX package, on the CPU.

Inputs are made from numpy seeds and handed to both packages. Float32
comparisons are tight (they test the algorithm); the bf16 decode leg is
held to the reference's own ``ref`` leg, which rounds exactly where the
port's plain version rounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.kernel import fused_decode_attention
from repro.kernels.decode_attn.ops import (
    count_skipped_blocks as jax_count_skipped)
from repro.kernels.decode_attn.ref import ref_decode_attention as jax_ref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.kernels.decode_attn import ops as tda
from repro_torch.kernels.registry import KernelSpec
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

F32 = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def test_rms_norm_swiglu_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(_t(x), _t(scale)).numpy(),
        _np(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))), **F32)
    wg, wu = rng.normal(size=(2, 16, 24)).astype(np.float32) * 0.2
    wd = rng.normal(size=(24, 16)).astype(np.float32) * 0.2
    np.testing.assert_allclose(
        tlayers.swiglu(_t(x), _t(wg), _t(wu), _t(wd)).numpy(),
        _np(jlayers.swiglu(*map(jnp.asarray, (x, wg, wu, wd)))), **F32)
    q = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 100, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tlayers.apply_rope(_t(q), torch.from_numpy(pos), 1e4).numpy(),
        _np(jlayers.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kv,window", [(4, 0), (2, 0), (2, 3)])
def test_prefill_attention(kv, window):
    rng = np.random.default_rng(1)
    B, T, H, D = 2, 9, 4, 8
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, kv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, kv, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    ref = jattn.flash_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                causal=True, window=window)
    out = tattn.flash_attention(_t(q), _t(k), _t(v), torch.from_numpy(pos),
                                torch.from_numpy(pos), causal=True,
                                window=window)
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32)


@pytest.mark.parametrize("ring,T", [(False, 5), (True, 5), (True, 11)])
def test_prefill_and_update_cache_with_slots(ring, T):
    rng = np.random.default_rng(2)
    B, S, KV, D = 2, 8, 2, 4
    kn = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    vn = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    jk, jv = jattn.prefill_cache(jnp.zeros((B, S, KV, D)),
                                 jnp.zeros((B, S, KV, D)),
                                 jnp.asarray(kn), jnp.asarray(vn), ring=ring)
    tk, tv = torch.zeros((B, S, KV, D)), torch.zeros((B, S, KV, D))
    tattn.prefill_cache(tk, tv, _t(kn), _t(vn), ring=ring)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    # one-token update into a pool of 5 rows through slots
    pool = rng.normal(size=(5, S, KV, D)).astype(np.float32)
    new = rng.normal(size=(3, 1, KV, D)).astype(np.float32)
    slots = np.array([4, 0, 2], np.int32)
    position = np.array([3, 7, 6], np.int32) + (9 if ring else 0)
    jpk, _ = jattn.update_cache(jnp.asarray(pool), jnp.asarray(pool),
                                jnp.asarray(new), jnp.asarray(new),
                                jnp.asarray(position), ring=ring,
                                slots=jnp.asarray(slots))
    tpk, tpv = _t(pool), _t(pool)
    tattn.update_cache(tpk, tpv, _t(new), _t(new),
                       torch.from_numpy(position), ring=ring,
                       slots=torch.from_numpy(slots))
    np.testing.assert_array_equal(tpk.numpy(), _np(jpk))


def _decode_inputs(seed, B, S, H, KV, D, dtype):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    pos = rng.integers(0, 3 * S, size=(B,)).astype(np.int32)
    jx = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    tx = [_t(np.array(a.astype(jnp.float32)),
             torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
          for a in jx]
    return jx, tx, pos


@pytest.mark.parametrize("kv", [4, 2])
@pytest.mark.parametrize("window,ring", [(0, False), (0, True), (5, False),
                                         (16, True)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_decode_attention_matches_ref_leg(kv, window, ring, dtype):
    """The port's plain version is the reference's grouped ref leg, bf16
    roundings included: float32 agrees to float32 noise, bf16 to one
    bf16 rounding of the output (2^-8 relative)."""
    B, S, H, D = 3, 16, 4, 8
    (jq, jk, jv), (tq, tk, tv), pos = _decode_inputs(3, B, S, H, kv, D,
                                                      dtype)
    if not ring:
        pos = pos % S
    ref = jax_ref(jq, jk, jv, jnp.asarray(pos), window=window, ring=ring)
    out = tda.decode_attention(tq, tk, tv, torch.from_numpy(pos),
                               window=window, ring=ring)
    tol = F32 if dtype == jnp.float32 else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(out.float().numpy(), _np(ref), **tol)


def test_plain_decode_through_slots_and_kv_len():
    """Slots + kv_len crop read the same rows the reference gathers."""
    rng = np.random.default_rng(4)
    P, S, KV, H, D = 6, 32, 2, 4, 8
    kp = rng.normal(size=(P, S, KV, D)).astype(np.float32)
    vp = rng.normal(size=(P, S, KV, D)).astype(np.float32)
    q = rng.normal(size=(3, 1, H, D)).astype(np.float32)
    slots = np.array([5, 1, 3], np.int32)
    pos = np.array([10, 3, 15], np.int32)
    ref = jax_ref(jnp.asarray(q), jnp.asarray(kp[:, :16][slots]),
                  jnp.asarray(vp[:, :16][slots]), jnp.asarray(pos))
    out = tda.decode_attention(_t(q), _t(kp), _t(vp), torch.from_numpy(pos),
                               slots=torch.from_numpy(slots), kv_len=16)
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32)


def test_pallas_kernel_against_plain_version():
    """The reference's Pallas kernel (interpret mode) stays float32 until
    its final division; the port's plain version rounds the scores and
    the softmax weights to bf16 like the ref leg. The gap is those
    roundings: within 2^-5 of the output range."""
    B, S, H, KV, D = 2, 16, 4, 2, 8
    (jq, jk, jv), (tq, tk, tv), pos = _decode_inputs(5, B, S, H, KV, D,
                                                      jnp.bfloat16)
    pos = pos % S
    pal = fused_decode_attention(jq, jk, jv, jnp.asarray(pos), tile_b=1,
                                 blk=8, interpret=True)
    out = tda.decode_attention(tq, tk, tv, torch.from_numpy(pos))
    ref = _np(pal)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 2 ** -5 * np.abs(ref).max() + 1e-3, err


@pytest.mark.parametrize("window,ring", [(0, False), (5, False), (8, True)])
def test_count_skipped_blocks_matches_reference(window, ring):
    pos = np.array([3, 40, 17, 63, 8, 9, 0, 31], np.int32)
    for tile_b in (1, 2, 4):
        assert tda.count_skipped_blocks(pos, 64, 16, tile_b, window, ring) \
            == jax_count_skipped(pos, 64, 16, tile_b, window, ring)
    assert KernelSpec().pick_block_seq(464) == 116
    assert KernelSpec(tile_n=16).pick_block_seq(64) == 16
