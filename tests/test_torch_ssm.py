"""The port's state-space mixers (``repro_torch.models.ssm``) against the
JAX package's, on the same numpy parameters and inputs, in float32
within 1e-5.

Mamba (Hymba's parallel head): ``mamba_scan`` at T 12 and 40 from zero
state, 12 tokens as 7 then 5 resumed from the carried (ssm, conv)
state, and single steps (``mamba_decode``, T 1), with non-trivial
``a_log``, ``dt_bias`` and ``d_skip`` (each head's skip repeats over
its dh channels: ``jnp.repeat``, not a tile).

RWKV-6: ``rwkv6_time_mix`` (the scan) at T 12 from a non-zero state,
``rwkv6_time_mix_chunked`` at T 64 with chunk 32 (the chunked form,
within 2e-5 of the output range: its factors e^x and e^-x cancel, and
on these inputs the reference's own chunked form parts from its scan by
6.3e-5, 1.05e-5 of the range, the port's by 2.9e-5) and at T 32 (its
fallback to the scan, 1e-5), ``rwkv6_channel_mix``, and
``_group_norm`` (no Bessel correction), plus one bfloat16 case of the
chunked form at the serve path's dtype (2^-6 of the output range).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got.float()), np.array(want),
                               rtol=tol, atol=tol)


def _pair(cls_j, cls_t, arrays, dtype="float32", f32=()):
    """The same numpy leaves as the reference's and the port's
    NamedTuple, at ``dtype`` (fields in ``f32`` stay float32)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    j = cls_j(**{k: jnp.asarray(a).astype(jnp.float32 if k in f32 else jdt)
                 for k, a in arrays.items()})
    t = cls_t(**{k: torch.from_numpy(a).to(torch.float32 if k in f32
                                           else tdt)
                 for k, a in arrays.items()})
    return j, t


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

B, D_MODEL, H, DH, DS, CW = 2, 16, 2, 8, 4, 4
D_IN = H * DH


def mamba_arrays(seed=0):
    rng = np.random.default_rng(seed)

    def v(*shape, s=0.2):
        return (rng.normal(size=shape) * s).astype(np.float32)
    return dict(w_in=v(D_MODEL, 2 * D_IN), conv_w=v(CW, D_IN),
                w_bcdt=v(D_IN, 2 * DS + H), a_log=v(H, DS, s=0.5),
                dt_bias=v(H, s=0.5), d_skip=1.0 + v(H, s=0.5),
                w_out=v(D_IN, D_MODEL))


MAMBA_F32 = ("a_log", "dt_bias", "d_skip")


@pytest.fixture(scope="module")
def mamba():
    j, t = _pair(jssm.MambaParams, tssm.MambaParams, mamba_arrays(),
                 f32=MAMBA_F32)
    x = np.random.default_rng(1).normal(size=(B, 12, D_MODEL)
                                        ).astype(np.float32)
    return j, t, x


@pytest.mark.parametrize("T", [12, 40])
def test_mamba_scan_from_zero_state(mamba, T):
    """T 12 is one block of the port's precomputed terms, T 40 a full
    block of 32 and a ragged one."""
    j, t, _ = mamba
    x = np.random.default_rng(T).normal(size=(B, T, D_MODEL)
                                        ).astype(np.float32)
    jy, (jh, jc) = jssm.mamba_scan(j, jnp.asarray(x))
    ty, (th, tc) = tssm.mamba_scan(t, torch.from_numpy(x))
    _close(ty, jy)
    _close(th, jh)
    _close(tc, jc)
    assert th.dtype == torch.float32 and tuple(th.shape) == (B, H, DH, DS)
    assert tuple(tc.shape) == (B, CW - 1, D_IN)


def test_mamba_scan_resumes_from_carried_state(mamba):
    """7 tokens, then 5 from the carried state: the reference's split,
    and the port's one-shot scan of all 12."""
    j, t, x = mamba
    _, js = jssm.mamba_scan(j, jnp.asarray(x[:, :7]))
    jy2, (jh, jc) = jssm.mamba_scan(j, jnp.asarray(x[:, 7:]), js)
    _, ts = tssm.mamba_scan(t, torch.from_numpy(x[:, :7]))
    ty2, (th, tc) = tssm.mamba_scan(t, torch.from_numpy(x[:, 7:]), ts)
    _close(ty2, jy2)
    _close(th, jh)
    _close(tc, jc)
    ty, _ = tssm.mamba_scan(t, torch.from_numpy(x))
    _close(ty[:, 7:], jy2)


def test_mamba_decode_steps(mamba):
    """T 1 at a time from zeros (the decode path) against the
    reference's steps."""
    j, t, x = mamba
    js = (jnp.zeros((B, H, DH, DS), jnp.float32),
          jnp.zeros((B, CW - 1, D_IN), jnp.float32))
    ts = (torch.zeros((B, H, DH, DS)), torch.zeros((B, CW - 1, D_IN)))
    for step in range(4):
        jy, js = jssm.mamba_decode(j, jnp.asarray(x[:, step:step + 1]), js)
        ty, ts = tssm.mamba_decode(t, torch.from_numpy(x[:, step:step + 1]),
                                   ts)
        _close(ty, jy)
        _close(ts[0], js[0])


def test_mamba_d_skip_repeats_per_head():
    """d_skip [H] scales channel c by d_skip[c // dh] (repeat_interleave);
    a tiled repeat would scale by d_skip[c % H]."""
    arrays = mamba_arrays(3)
    arrays["d_skip"] = np.array([0.0, 5.0], np.float32)
    j, t = _pair(jssm.MambaParams, tssm.MambaParams, arrays, f32=MAMBA_F32)
    x = np.random.default_rng(4).normal(size=(B, 5, D_MODEL)
                                        ).astype(np.float32)
    jy, _ = jssm.mamba_scan(j, jnp.asarray(x))
    ty, _ = tssm.mamba_scan(t, torch.from_numpy(x))
    _close(ty, jy)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

RD, RH, RDH, RF = 32, 4, 8, 64


def rwkv_arrays(seed=0):
    rng = np.random.default_rng(seed)
    D = RH * RDH

    def v(*shape, s=0.2):
        return (rng.normal(size=shape) * s).astype(np.float32)
    return dict(
        mu_r=v(RD, s=0.5), mu_k=v(RD, s=0.5), mu_v=v(RD, s=0.5),
        mu_g=v(RD, s=0.5), mu_w=v(RD, s=0.5),
        w_r=v(RD, D), w_k=v(RD, D), w_v=v(RD, D), w_g=v(RD, D), w_o=v(D, RD),
        w0=v(D, s=0.5), w_lora_a=v(RD, 64), w_lora_b=v(64, D),
        bonus_u=v(RH, RDH, s=0.5), ln_x=1.0 + v(D),
        mu_ck=v(RD, s=0.5), mu_cr=v(RD, s=0.5),
        w_ck=v(RD, RF), w_cv=v(RF, RD), w_cr=v(RD, RD))


def rwkv_state(seed, dtype="float32"):
    """A non-zero state (wkv, shift_t, shift_c) for both packages."""
    rng = np.random.default_rng(seed)
    wkv = (0.3 * rng.normal(size=(B, RH, RDH, RDH))).astype(np.float32)
    st, sc = (rng.normal(size=(B, RD)).astype(np.float32) for _ in range(2))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    j = jssm.RWKVState(jnp.asarray(wkv), jnp.asarray(st).astype(jdt),
                       jnp.asarray(sc).astype(jdt))
    t = tssm.RWKVState(torch.from_numpy(wkv), torch.from_numpy(st).to(tdt),
                       torch.from_numpy(sc).to(tdt))
    return j, t


@pytest.fixture(scope="module")
def rwkv():
    return _pair(jssm.RWKV6Params, tssm.RWKV6Params, rwkv_arrays())


def _x(T, seed=5, dtype="float32"):
    x = np.random.default_rng(seed).normal(size=(B, T, RD)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(
        getattr(torch, dtype))


def test_rwkv6_time_mix_scan(rwkv):
    j, t = rwkv
    js, ts = rwkv_state(6)
    jx, tx = _x(12)
    jy, jwkv, jsh = jssm.rwkv6_time_mix(j, jx, js, RH)
    ty, twkv, tsh = tssm.rwkv6_time_mix(t, tx, ts, RH)
    _close(ty, jy)
    _close(twkv, jwkv)
    _close(tsh, jsh)
    assert twkv.dtype == torch.float32


@pytest.mark.parametrize("T", [64, 32], ids=["chunked", "fallback"])
def test_rwkv6_time_mix_chunked(rwkv, T):
    """T 64 / chunk 32 runs the chunked form; T 32 (one chunk) falls
    back to the scan, bit for bit in the port."""
    j, t = rwkv
    js, ts = rwkv_state(7)
    jx, tx = _x(T, seed=8)
    jy, jwkv, _ = jssm.rwkv6_time_mix_chunked(j, jx, js, RH, chunk=32)
    ty, twkv, _ = tssm.rwkv6_time_mix_chunked(t, tx, ts, RH, chunk=32)
    if T == 64:
        for got, want in ((ty, jy), (twkv, jwkv)):
            want = np.array(want)
            assert np.abs(got.numpy() - want).max() <= \
                2e-5 * np.abs(want).max()
    else:
        _close(ty, jy)
        _close(twkv, jwkv)
    if T == 32:
        sy, swkv, _ = tssm.rwkv6_time_mix(t, tx, ts, RH)
        assert torch.equal(ty, sy) and torch.equal(twkv, swkv)


def test_rwkv6_time_mix_chunked_bf16(rwkv):
    """The serve path's dtype: bf16 leaves and activations, float32
    state; 2^-6 of the output range."""
    j, t = _pair(jssm.RWKV6Params, tssm.RWKV6Params, rwkv_arrays(),
                 dtype="bfloat16")
    js, ts = rwkv_state(9, "bfloat16")
    jx, tx = _x(64, seed=10, dtype="bfloat16")
    jy, jwkv, _ = jssm.rwkv6_time_mix_chunked(j, jx, js, RH, chunk=32)
    ty, twkv, _ = tssm.rwkv6_time_mix_chunked(t, tx, ts, RH, chunk=32)
    want = np.array(jy.astype(jnp.float32))
    assert np.abs(ty.float().numpy() - want).max() <= \
        2 ** -6 * np.abs(want).max()
    wk = np.array(jwkv)
    assert np.abs(twkv.numpy() - wk).max() <= 2 ** -6 * np.abs(wk).max()


def test_rwkv6_channel_mix(rwkv):
    j, t = rwkv
    js, ts = rwkv_state(11)
    jx, tx = _x(12, seed=12)
    jy, jsh = jssm.rwkv6_channel_mix(j, jx, js.shift_c)
    ty, tsh = tssm.rwkv6_channel_mix(t, tx, ts.shift_c)
    _close(ty, jy)
    _close(tsh, jsh)


def test_group_norm_has_no_bessel_correction():
    rng = np.random.default_rng(13)
    y = rng.normal(size=(2, 3, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    want = jssm._group_norm(jnp.asarray(y), jnp.asarray(scale), 4)
    got = tssm._group_norm(torch.from_numpy(y), torch.from_numpy(scale), 4)
    _close(got, want)


def test_rwkv6_chunked_stays_finite_at_the_fastest_decay():
    """Every channel at the clamp (w = e^-8 a step): the reference's
    mid-chunk split overflows float32 (a half chunk spans 16 x 8 = 128 in
    log) and its chunked output is not finite; the port's chunked form
    keeps each pair's decay within float32 and agrees with the
    reference's scan within 2e-5 of the output range, as the chunked
    form does elsewhere."""
    arrays = rwkv_arrays(14)
    arrays["w0"] = np.full_like(arrays["w0"], 3.0)      # e^3 > 8: clamped
    j, t = _pair(jssm.RWKV6Params, tssm.RWKV6Params, arrays)
    js, ts = rwkv_state(15)
    jx, tx = _x(64, seed=16)
    jy, _, _ = jssm.rwkv6_time_mix_chunked(j, jx, js, RH, chunk=32)
    assert not np.isfinite(np.array(jy)).all()
    want, want_wkv, _ = jssm.rwkv6_time_mix(j, jx, js, RH)
    ty, twkv, _ = tssm.rwkv6_time_mix_chunked(t, tx, ts, RH, chunk=32)
    assert torch.isfinite(ty).all()
    for got, ref in ((ty, want), (twkv, want_wkv)):
        ref = np.array(ref)
        assert np.abs(got.numpy() - ref).max() <= 2e-5 * np.abs(ref).max()
