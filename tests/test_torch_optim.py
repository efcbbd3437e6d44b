"""The port's optimiser and gradient compression against the JAX package
(``repro.optim``) on the CPU.

  * ``apply_updates`` on a seeded tree (a dict with 1-D and 2-D leaves, a
    bf16 leaf and a ``MambaParams`` subtree) for four steps against the
    JAX function: with float32 states the parameters and moments within
    1e-6 of each leaf's range; with bfloat16 states within 2^-7 of it (a
    last-bit difference in the float32 math can move a moment's rounding
    by one bf16 ulp); the metrics within 1e-6 relative. Updates happen in
    place: the returned trees are the given tensors.
  * ``lr_schedule`` over 0-120 and ``clip_by_global_norm`` against the
    JAX functions (1e-6 relative).
  * The reference's own checks on the port: convergence on a quadratic
    (float32 and bf16 states), weight decay on matrices only, clipping,
    the schedule's shape; int8 round trip within scale / 2 and inside
    [-127, 127]; stochastic rounding unbiased (mean within 0.05 of 30).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from repro.models.ssm import MambaParams as JaxMamba
from repro.optim import adamw as jadamw
from repro_torch import tree as tree_lib
from repro_torch.models.ssm import MambaParams
from repro_torch.optim import adamw
from repro_torch.optim.compression import dequantize_int8, quantize_int8


def seeded_tree(rng, scale=1.0):
    """numpy leaves: {"w" [5, 3], "b" [3], "e" [4, 2] (bf16 in the model),
    "mamba": MambaParams}."""
    def a(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"w": a(5, 3), "b": a(3), "e": a(4, 2),
            "mamba": dict(w_in=a(3, 4), conv_w=a(2, 2), w_bcdt=a(2, 5),
                          a_log=a(2, 2), dt_bias=a(2), d_skip=a(2),
                          w_out=a(2, 3))}


def to_jax(t):
    out = {k: jnp.asarray(v) for k, v in t.items() if k != "mamba"}
    out["e"] = out["e"].astype(jnp.bfloat16)
    out["mamba"] = JaxMamba(**{k: jnp.asarray(v)
                               for k, v in t["mamba"].items()})
    return out


def to_port(t):
    out = {k: torch.tensor(v) for k, v in t.items() if k != "mamba"}
    out["e"] = out["e"].bfloat16()
    out["mamba"] = MambaParams(**{k: torch.tensor(v)
                                  for k, v in t["mamba"].items()})
    return out


def range_err(mine, ref):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = mine.float().numpy()
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("state_dtype,tol", [("float32", 1e-6),
                                             ("bfloat16", 2 ** -7)])
def test_apply_updates_matches_reference(state_dtype, tol):
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
               grad_clip=1.0, state_dtype=state_dtype)
    p0 = seeded_tree(rng)
    jp, tp = to_jax(p0), to_port(p0)
    jo = jadamw.init_opt_state(jp, jadamw.AdamWConfig(**cfg))
    to = adamw.init_opt_state(tp, adamw.AdamWConfig(**cfg))
    leaves_before = [id(x) for x in tree_lib.leaves((tp, to.m, to.v))]
    for _ in range(4):
        g = seeded_tree(rng, scale=0.3)
        jp, jo, jm = jadamw.apply_updates(jp, to_jax(g), jo,
                                          jadamw.AdamWConfig(**cfg))
        tp, to, tm = adamw.apply_updates(tp, to_port(g), to,
                                         adamw.AdamWConfig(**cfg))
        for key in ("grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                1e-6 * abs(float(jm[key])), key
    assert [id(x) for x in tree_lib.leaves((tp, to.m, to.v))] == leaves_before
    assert int(to.step) == int(jo.step) == 4
    assert tp["e"].dtype == torch.bfloat16
    assert to.m["w"].dtype == getattr(torch, state_dtype)
    assert isinstance(tp["mamba"], MambaParams)
    for mine, ref in ((tp, jp), (to.m, jo.m), (to.v, jo.v)):
        for a, b in zip(tree_lib.leaves(mine), jax.tree.leaves(ref)):
            assert range_err(a, b) <= tol


def test_lr_schedule_and_clip_match_reference():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for s in range(121):
        want = float(jadamw.lr_schedule(jnp.asarray(s), jadamw.AdamWConfig(
            **cfg)))
        got = float(adamw.lr_schedule(torch.tensor(s), adamw.AdamWConfig(
            **cfg)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), s
    rng = np.random.default_rng(1)
    for scale in (0.01, 10.0):
        g = seeded_tree(rng, scale)
        jc, jn = jadamw.clip_by_global_norm(to_jax(g), 1.0)
        tc, tn = adamw.clip_by_global_norm(to_port(g), 1.0)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        for a, b in zip(tree_lib.leaves(tc), jax.tree.leaves(jc)):
            assert range_err(a, b) <= 1e-6


def quadratic(target, state_dtype, clip):
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200, grad_clip=clip,
                            state_dtype=state_dtype)
    params = {"w": torch.zeros(len(target))}
    state = adamw.init_opt_state(params, cfg)
    target = torch.tensor(target)
    for _ in range(150):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw.apply_updates(params, g, state, cfg)
    return params["w"], state, target


def test_adamw_converges_on_quadratic():
    w, _, target = quadratic([1.0, -2.0, 3.0], "float32", 100.0)
    assert float((w - target).abs().max()) <= 0.15
    w, state, target = quadratic([0.5, -1.5], "bfloat16", 1.0)
    assert state.m["w"].dtype == torch.bfloat16
    assert float((w - target).abs().max()) <= 0.2


def test_weight_decay_only_on_matrices():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=1.0, warmup_steps=0,
                            total_steps=10, state_dtype="float32")
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    g = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    p2, _, _ = adamw.apply_updates(params, g,
                                   adamw.init_opt_state(params, cfg), cfg)
    assert float(p2["w"].mean()) < 1.0
    assert float(p2["b"].mean()) == 1.0


def test_grad_clip_and_schedule_shape():
    clipped, norm = adamw.clip_by_global_norm({"a": torch.ones(100) * 10},
                                              1.0)
    assert abs(float(norm) - 100.0) < 1e-3
    assert abs(float(clipped["a"].norm()) - 1.0) < 1e-4
    c2, _ = adamw.clip_by_global_norm({"a": torch.ones(4) * 0.1}, 1.0)
    np.testing.assert_allclose(c2["a"].numpy(), 0.1, rtol=1e-5)
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    lrs = [float(adamw.lr_schedule(torch.tensor(s), cfg)) for s in range(101)]
    assert lrs[0] == 0.0 and abs(lrs[10] - 1e-3) < 1e-6
    assert lrs[100] <= 1e-4 * 1.01
    assert all(b <= a + 1e-9 for a, b in zip(lrs[10:], lrs[11:]))


@given(st.integers(0, 200))
def test_int8_roundtrip_error_bound(seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(256, generator=g) * (seed + 1)
    q, scale = quantize_int8(x)
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    back = dequantize_int8(q, scale)
    assert float((back - x).abs().max()) <= float(scale) * 0.5 + 1e-6
    qs, _ = quantize_int8(x, torch.Generator().manual_seed(seed))
    assert int(qs.abs().max()) <= 127
    assert float((dequantize_int8(qs, scale) - x).abs().max()) <= \
        float(scale) + 1e-6


def test_stochastic_rounding_unbiased():
    x = torch.full((20000,), 0.3)
    q, scale = quantize_int8(x * 100, torch.Generator().manual_seed(0))
    back = dequantize_int8(q, scale)
    assert abs(float(back.mean()) - 30.0) < 0.05
    q2, _ = quantize_int8(x * 100, torch.Generator().manual_seed(0))
    assert torch.equal(q, q2)
