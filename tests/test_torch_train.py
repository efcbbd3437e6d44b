"""The port's training forward and backward against the JAX package on
the CPU.

  * ``flash_attention``: the blocked online softmax and its FA2 backward
    against the reference's ``flash_attention`` and ``jax.vjp`` at
    ``q_block = k_block = 8``, so that several blocks, a short last
    block (the reference pads it), GQA, sliding windows, causal and
    non-causal masks and fully masked rows all occur: output and dq, dk, dv within 1e-5 of each
    one's range (float32). Within one 512-wide block the forward is the
    single masked softmax the port served with before, bit for bit.
  * ``lm_loss`` and its gradients against ``jax.value_and_grad(lm_loss)``
    for the reduced Dec-S, EncDec-S (with ``enc_embeds``) and Qwen2-VL
    (``embeds`` and [3, B, T] M-RoPE positions), one label masked
    (``test_torch_train_nondense.py``: Hymba, Phi-3.5-MoE, RWKV-6): in float32 the loss within 1e-6
    relative and every gradient leaf within 2e-5 of its range; Dec-S in
    bfloat16 within 2^-5 of the range (the loss within 2^-10 relative).
    Every leaf gets a gradient (but Qwen2-VL's untied ``embed``, which a
    batch of embeds does not read: zeros, as JAX gives).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf

F32_GRAD_TOL = 2e-5          # of each gradient leaf's range
BF16_TOL = 2 ** -5           # of each gradient leaf's range
BF16_LOSS_RTOL = 2 ** -10


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _range_err(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_keyed(tree):
    """The reference checkpoint's keys -> leaves."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", getattr(
            p, "name", p)))) for p in path)] = leaf
    return out


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # B, T, S, H, KV, causal, window, q offset, k offset
    "causal_gqa": (2, 20, 20, 4, 2, True, 0, 0, 0),
    "window": (2, 20, 20, 4, 2, True, 5, 0, 0),
    "noncausal_padded": (2, 13, 21, 4, 4, False, 0, 0, 0),
    "mqa_window": (2, 20, 20, 4, 1, True, 3, 0, 0),
    "history": (2, 16, 30, 4, 2, True, 4, 10, 0),
    "masked_rows": (2, 17, 19, 4, 2, True, 0, 0, 5),
}


def _flash_inputs(B, T, S, H, KV, qoff, koff, seed=0):
    rng = np.random.default_rng(seed)
    D = 8
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    do = rng.normal(size=(B, T, H, D)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(T) + qoff, (B, T)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(S) + koff, (B, S)).astype(np.int32)
    return q, k, v, do, qpos.copy(), kpos.copy()


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_and_vjp_match_reference(case):
    B, T, S, H, KV, causal, window, qoff, koff = FLASH_CASES[case]
    q, k, v, do, qpos, kpos = _flash_inputs(B, T, S, H, KV, qoff, koff)

    def jf(q, k, v):
        return jattn.flash_attention(q, k, v, jnp.asarray(qpos),
                                     jnp.asarray(kpos), causal=causal,
                                     window=window, q_block=8, k_block=8)
    jout, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tout = tattn.flash_attention(tq, tk, tv, torch.from_numpy(qpos),
                                 torch.from_numpy(kpos), causal=causal,
                                 window=window, q_block=8, k_block=8)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(do))
    assert _range_err(tout, jout) <= 1e-5
    for name, g, jg in zip("qkv", tgrads, jgrads):
        assert _range_err(g, jg) <= 1e-5, name
    if case == "masked_rows":       # query positions 0-4 see no key
        assert float(tout.detach()[:, :5].abs().max()) == 0.0
        assert float(tgrads[0][:, :5].abs().max()) == 0.0


def _one_softmax(q, k, v, qpos, kpos, causal, window):
    """The port's attention before it was blocked: one masked softmax
    over the whole score row."""
    qkv = q.shape[2] // k.shape[2]
    k, v = tattn._repeat_kv(k, qkv), tattn._repeat_kv(v, qkv)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    msk = tattn._mask(qpos, kpos, causal, window)[:, None]
    s = torch.where(msk, s, tattn.NEG_INF)
    mx = s.amax(-1, keepdim=True)
    p = torch.where(msk, torch.exp(s - mx), torch.zeros_like(s))
    sm = p.sum(-1, keepdim=True)
    pv = torch.einsum("bhts,bshd->bhtd", p.to(v.dtype).float(), v.float())
    return (pv / torch.clamp(sm, min=1e-20)).permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_within_one_block_is_the_single_softmax(dtype):
    for case in ("causal_gqa", "window", "noncausal_padded", "masked_rows"):
        B, T, S, H, KV, causal, window, qoff, koff = FLASH_CASES[case]
        q, k, v, _, qpos, kpos = _flash_inputs(B, T, S, H, KV, qoff, koff, 1)
        q, k, v = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
        qpos, kpos = torch.from_numpy(qpos), torch.from_numpy(kpos)
        with torch.no_grad():
            got = tattn.flash_attention(q, k, v, qpos, kpos, causal, window)
        assert torch.equal(got, _one_softmax(q, k, v, qpos, kpos, causal,
                                             window)), case


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------

# the dense ones here; test_torch_train_nondense.py takes Hymba,
# Phi-3.5-MoE and RWKV-6 (each file stays near a minute on one worker)
LOSS_MODELS = ("dec_s", "encdec_s", "qwen2_vl_72b")


def pair(arch, dtype):
    jcfg = dataclasses.replace(jax_arch(arch).reduced, dtype=dtype)
    tcfg = convert.model_config(dataclasses.asdict(jcfg))
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params(
        jax.tree.map(lambda x: np.array(x.astype(jnp.float32)), jp), tcfg)
    return jcfg, jp, tcfg, tp


def loss_batch(jcfg, tcfg, B=2, T=16, seed=1):
    """The same batch for both packages: tokens (or embeds and [3, B, T]
    positions for a vision frontend), labels with one masked, and an
    encoder-decoder's enc_embeds."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, size=(B, T + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, 3] = -1
    arrays = {"labels": labels}
    floats = {}
    if jcfg.frontend == "vision":
        floats["embeds"] = rng.normal(size=(B, T, jcfg.d_model))
        pos = np.stack([np.arange(T), np.arange(T) // 4, np.arange(T) % 4])
        arrays["positions"] = np.broadcast_to(
            pos[:, None], (3, B, T)).astype(np.int32).copy()
    else:
        arrays["tokens"] = toks[:, :-1].copy()
    if jcfg.arch == "encdec":
        floats["enc_embeds"] = rng.normal(size=(B, 8, jcfg.d_model))
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    for k, v in floats.items():
        jb[k] = jnp.asarray(v.astype(np.float32)).astype(jcfg.dtype)
        tb[k] = torch.from_numpy(_np(jb[k])).to(tcfg.torch_dtype)
    return jb, tb


def port_loss_and_grads(tcfg, tp, tb, remat=True):
    keyed = tree_lib.keyed(tp)
    for leaf in keyed.values():
        leaf.requires_grad_(True)
    loss = ttf.lm_loss(tp, tcfg, tb, remat=remat)
    grads = torch.autograd.grad(loss, list(keyed.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(keyed, grads))


def check_loss_and_grads(arch, dtype):
    jcfg, jp, tcfg, tp = pair(arch, dtype)
    jb, tb = loss_batch(jcfg, tcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, jcfg, jb)))(jp)
    loss, grads = port_loss_and_grads(tcfg, tp, tb)
    jgrads = jax_keyed(jgrads)
    assert sorted(grads) == sorted(jgrads)
    if dtype == "float32":
        assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    else:
        assert abs(float(loss) - float(jloss)) <= BF16_LOSS_RTOL * abs(
            float(jloss))
    tol = F32_GRAD_TOL if dtype == "float32" else BF16_TOL
    for key, g in grads.items():
        assert g is not None and g.shape == jgrads[key].shape, key
        if not (key == "embed" and "embeds" in tb):   # lookup unused
            assert float(g.float().abs().max()) > 0, key
        assert _range_err(g, jgrads[key]) <= tol, key


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in LOSS_MODELS]
                         + [("dec_s", "bfloat16")])
def test_lm_loss_and_grads_match_reference(arch, dtype):
    check_loss_and_grads(arch, dtype)
