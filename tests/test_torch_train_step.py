"""The port's training step (``launch.steps.build_train_step``: lm_loss,
the backward, gradient accumulation, AdamW in place) against the JAX
package's ``build_train_step`` on a one-device mesh, reduced Dec-S in
float32 with float32 Adam states:

  * three steps: the loss, the gradient norm and the learning rate of
    each within 1e-5 relative, and the parameters and both moments after
    the third within 1e-3 of each leaf's range (Adam's normalised step
    turns a last-bit gradient difference near zero into up to ``lr``);
  * ``microbatches=2`` against the JAX step with the same micro-batches,
    and against the port's ``microbatches=1`` (the same mean, summed in
    another order) within the same bounds;
  * ``remat=True`` changes no bit of the loss or of any gradient;
  * ``default_microbatches`` equals the reference's for every
    registered model and shape at 1, 8 and 256 data-parallel ranks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh_for
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.launch.steps import build_train_step, default_microbatches
from repro_torch.optim import adamw as tadamw
from test_torch_train import (jax_keyed, loss_batch, pair,
                              port_loss_and_grads)

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20, state_dtype="float32")
STEPS = 3


def batches(vocab, n=STEPS, B=4, T=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, size=(B, T + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:]})
    return out


def run_port(tcfg, tp, microbatches):
    opt = tadamw.init_opt_state(tp, tadamw.AdamWConfig(**OPT))
    step = build_train_step(tcfg, tadamw.AdamWConfig(**OPT),
                            microbatches=microbatches)
    logs = []
    for b in batches(tcfg.vocab_size):
        tp, opt, m = step(tp, opt, {k: torch.from_numpy(v.copy())
                                    for k, v in b.items()})
        logs.append({k: float(v) for k, v in m.items()})
    return tp, opt, logs


@pytest.fixture(scope="module")
def reference():
    """The JAX step's trajectory at microbatches 1 and 2, from the seeded
    init."""
    jcfg, np0, tcfg, _ = pair("dec_s", "float32")
    np0 = jax.tree.map(np.array, np0)       # the step donates its inputs
    spec = dataclasses.replace(jax_arch("dec_s"), model=jcfg)
    mesh = make_mesh_for(jax.devices()[:1], data=1)
    out = {}
    for micro in (1, 2):
        jstep, _, _ = jsteps.build_train_step(
            spec, "train_4k", mesh, jadamw.AdamWConfig(**OPT), remat=True,
            microbatches=micro)
        jp = jax.tree.map(jnp.array, np0)
        jo = jadamw.init_opt_state(jp, jadamw.AdamWConfig(**OPT))
        logs = []
        for b in batches(jcfg.vocab_size):
            jp, jo, m = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
            logs.append({k: float(v) for k, v in m.items()})
        out[micro] = (jp, jo, logs)
    return jcfg, tcfg, np0, out


def fresh_port(np0, tcfg):
    """Port params from copies: converted tensors share their arrays'
    memory, and the step updates them in place."""
    return convert.lm_params(jax.tree.map(np.copy, np0), tcfg)


def close_trajectory(logs, want):
    for got, ref in zip(logs, want):
        for key in ("loss", "grad_norm", "lr"):
            assert abs(got[key] - ref[key]) <= 1e-5 * abs(ref[key]), key


def close_trees(tree, jtree, tol=1e-3):
    mine, ref = tree_lib.keyed(tree), jax_keyed(jtree)
    assert sorted(mine) == sorted(ref)
    for key, leaf in mine.items():
        want = np.array(ref[key], np.float32)
        err = np.abs(leaf.detach().float().numpy() - want).max()
        assert err <= tol * max(np.abs(want).max(), 1e-30), key


@pytest.mark.parametrize("micro", [1, 2])
def test_train_steps_match_reference(reference, micro):
    jcfg, tcfg, np0, out = reference
    jp, jo, jlogs = out[micro]
    tp, topt, logs = run_port(tcfg, fresh_port(np0, tcfg), micro)
    close_trajectory(logs, jlogs)
    close_trees(tp, jp)
    close_trees((topt.m, topt.v), (jo.m, jo.v))
    assert int(topt.step) == int(jo.step) == STEPS


def test_microbatches_match_one_batch(reference):
    _, tcfg, np0, _ = reference
    p1, _, logs1 = run_port(tcfg, fresh_port(np0, tcfg), 1)
    p2, _, logs2 = run_port(tcfg, fresh_port(np0, tcfg), 2)
    close_trajectory(logs2, logs1)
    close_trees(p2, jax.tree.map(lambda t: t.detach().numpy(), p1))


def test_opt_state_converts_from_reference():
    jcfg, jp, tcfg, _ = pair("hymba_1_5b", "float32")
    for dtype in ("float32", "bfloat16"):
        jo = jadamw.init_opt_state(jp, jadamw.AdamWConfig(state_dtype=dtype))
        jo = jo._replace(m=jax.tree.map(lambda x: x + 0.375, jo.m),
                         step=jnp.asarray(7, jnp.int32))
        to = convert.opt_state(jax.tree.map(np.array, jo))
        assert int(to.step) == 7 and to.step.dtype == torch.int32
        assert type(to.m["classes"]["global"]["mamba"]).__name__ == \
            "MambaParams"
        for key, leaf in tree_lib.keyed((to.m, to.v)).items():
            assert str(leaf.dtype) == f"torch.{dtype}", key
        close_trees((to.m, to.v), (jo.m, jo.v), tol=0.0)


def test_remat_is_bit_equal():
    jcfg, _, tcfg, tp = pair("dec_s", "float32")
    _, tb = loss_batch(jcfg, tcfg)
    loss_r, grads_r = port_loss_and_grads(tcfg, tp, tb, remat=True)
    loss, grads = port_loss_and_grads(tcfg, tp, tb, remat=False)
    assert torch.equal(loss_r, loss)
    for key in grads:
        assert torch.equal(grads_r[key], grads[key]), key


def test_default_microbatches_match_reference():
    class Mesh:                 # what the reference reads of a mesh
        def __init__(self, data):
            self.shape = {"data": data, "model": 1}
            self.axis_names = ("data", "model")

    for name in list_archs():
        for shape in SHAPES:
            for world in (1, 8, 256):
                assert default_microbatches(get_arch(name), shape, world) \
                    == jsteps.default_microbatches(jax_arch(name), shape,
                                                   Mesh(world)), \
                    (name, shape, world)
