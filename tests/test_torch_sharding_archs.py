"""The sharded training step on the other block families, on gloo ranks
on the CPU, each against the port's one-rank step (float32, 3 steps;
``test_torch_sharding.py``'s bounds: loss, gradient norm and lr within
1e-5 relative, parameters and moments within 1e-4 of each leaf's range;
local shapes and resident bytes as the dry run counts them):

  * EncDec-S at 1 x 2, with seeded ``enc_embeds`` so that the encoder
    and the cross-attention train split over "model";
  * the reduced Qwen2-0.5B at 1 x 4: 2 KV heads of 16 cannot split 4
    ways, and ``sanitize`` still splits ``wk``'s 32 columns (8 each,
    half a head): the attention gathers its leaves and runs replicated,
    the MLP and the vocabulary split;
  * the reduced Hymba at 1 x 2: the Mamba leaves gathered, the
    attention and MLP split, the untied head by vocabulary.

And the two small reference functions of the same slice:
``moe.load_balance_loss`` against the JAX function within 1e-6 (uniform,
collapsed and random routers, top-1 and top-2), and
``approx_topk_math.resource_saving`` equal to the reference's over a
grid of K, queues and eps.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import approx_topk_math as japprox
from repro.models import moe as jmoe
from repro_torch.core import approx_topk_math as tapprox
from repro_torch.models import moe as tmoe
from test_torch_sharding import (STEPS, cfg_of, check_layout, close_runs,
                                 restore, run_mesh, run_one)

CASES = {
    "encdec_s": (1, 2, ("--enc-len", "8")),
    "qwen2_0_5b": (1, 4, ()),
    "hymba_1_5b": (1, 2, ()),
}


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_follows_one_rank(tmp_path, monkeypatch, arch):
    data, model, extra = CASES[arch]
    ranks, out = run_mesh(tmp_path, monkeypatch, arch, data, model, extra)
    one, one_ck = run_one(tmp_path, arch, extra)
    cfg, ocfg = cfg_of(arch)
    close_runs(ranks, one, restore(out / "ckpt", cfg, ocfg, STEPS),
               restore(one_ck, cfg, ocfg, STEPS))
    check_layout(ranks, cfg, ocfg, data, model)


def test_load_balance_loss_matches_reference():
    E = 4
    x = np.repeat(np.eye(E, dtype=np.float32), 8, axis=0)
    rng = np.random.default_rng(0)
    routers = {
        "uniform": np.zeros((E, E), np.float32),
        "collapsed": np.ones((E, E), np.float32)
        * np.array([10., 0, 0, 0], np.float32)[None],
        "random": rng.normal(size=(E, E)).astype(np.float32),
    }
    import torch
    got = {}
    for name, rw in routers.items():
        for k in (1, 2):
            want = float(jmoe.load_balance_loss(jnp.asarray(x),
                                                jnp.asarray(rw), k))
            got[name, k] = float(tmoe.load_balance_loss(
                torch.from_numpy(x), torch.from_numpy(rw), k))
            assert got[name, k] == pytest.approx(want, rel=1e-6, abs=1e-6)
    assert got["collapsed", 1] > got["uniform", 1] >= 0.99


def test_resource_saving_matches_reference():
    for K in (10, 50, 100, 200):
        for nq in (1, 2, 8, 16, 32, 128):
            for eps in (0.001, 0.01, 0.1):
                assert tapprox.resource_saving(K, nq, eps) == \
                    japprox.resource_saving(K, nq, eps), (K, nq, eps)
