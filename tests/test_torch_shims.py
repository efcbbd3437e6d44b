"""The port's deprecated shims against the JAX package, on the CPU, on
``tests/test_serve.py``'s ``tiny_ralm`` recipe (the reference's index,
converted):

  * ``core.generate``: ``RetrievalEngine`` and ``generate`` warn with
    ``DeprecationWarning``, as the reference's do, and ``generate``'s
    greedy tokens equal the JAX ``generate``'s;
  * ``core.coordinator.DisaggregatedRuntime`` warns, and over two CPU
    memory-node processes its ``generate_pipelined`` tokens equal the
    port's monolithic engine's and the JAX monolithic
    ``generate_batches``' (the JAX disaggregated engine fails on this
    host: ROADMAP Queue 3 item 2); its ``search`` equals the monolithic
    retriever's, ``decode`` advances caches, ``times`` fill, the meshes
    are the backend's, and no node outlives ``close()``.
"""
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.generate import RetrievalEngine as JaxRetrievalEngine
from repro.core.generate import generate as jax_generate
from repro.serve import RalmEngine as JaxEngine
from repro_torch.core.coordinator import DisaggregatedRuntime
from repro_torch.core.generate import RetrievalEngine, generate
from repro_torch.models import transformer as ttf
from repro_torch.serve import LocalRetriever, RalmEngine
from test_torch_serve import tiny_ralm  # noqa: F401  (a fixture)


def _gone(pids) -> bool:
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        return False
    return True


@pytest.mark.parametrize("steps", [6])
def test_generate_shim_matches_jax_generate(tiny_ralm, steps):  # noqa: F811
    t = tiny_ralm
    jccfg = t["ds"].search_config(nprobe=4, k=8, backend="ref")
    tccfg = t["tds"].search_config(nprobe=4, k=8)
    with pytest.warns(DeprecationWarning, match="RetrievalEngine"):
        jret = JaxRetrievalEngine(params=t["ds"].params,
                                  shards=t["ds"].shards, cfg=jccfg,
                                  payload_tokens=t["ds"].payload_tokens)
    with pytest.warns(DeprecationWarning, match="RetrievalEngine"):
        tret = RetrievalEngine(params=t["tds"].params,
                               shards=t["tds"].shards, cfg=tccfg,
                               payload_tokens=t["tds"].payload_tokens)
    assert isinstance(tret, LocalRetriever)
    prompt = t["corpus"][:2, :8]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jout = np.asarray(jax_generate(t["params"], t["cfg"], t["rag"],
                                       jnp.asarray(prompt), steps=steps,
                                       engine=jret))
    with pytest.warns(DeprecationWarning, match="generate is deprecated"):
        tout = generate(t["tparams"], t["tcfg"], t["trag"],
                        torch.from_numpy(prompt), steps=steps, engine=tret)
    assert tout.shape == (2, 8 + steps)
    np.testing.assert_array_equal(tout, jout)
    api = RalmEngine.monolithic(t["tparams"], t["tcfg"], t["trag"],
                                tret).generate(torch.from_numpy(prompt),
                                               steps=steps)
    np.testing.assert_array_equal(tout, api)


def test_disaggregated_runtime_matches_monolithic(tiny_ralm):  # noqa: F811
    t = tiny_ralm
    rng = np.random.default_rng(0)
    prompts = [t["corpus"][:4, :8],
               rng.integers(0, 64, size=(2, 8), dtype=np.int32)]
    jeng = JaxEngine.monolithic(
        t["params"], t["cfg"], t["rag"], retriever=t["ds"].retriever(
            t["ds"].search_config(nprobe=4, k=8, backend="ref")))
    out_j = jeng.generate_batches([jnp.asarray(p) for p in prompts],
                                  steps=8)
    tccfg = t["tds"].search_config(nprobe=4, k=8)
    tprompts = [torch.from_numpy(p) for p in prompts]
    local = t["tds"].retriever(tccfg)
    out_m = RalmEngine.monolithic(t["tparams"], t["tcfg"], t["trag"],
                                  retriever=local).generate_batches(
        tprompts, steps=8)
    with pytest.warns(DeprecationWarning, match="DisaggregatedRuntime"):
        rt = DisaggregatedRuntime(
            t["tcfg"], t["trag"], t["tparams"], t["tds"].params,
            t["tds"].shards, tccfg, payload_tokens=t["tds"].payload_tokens,
            lm_devices=1, ret_devices=2)
    with rt:
        assert rt.lm_mesh.size == 1 and rt.ret_mesh.size == 2
        assert rt.ret_mesh.devices == ("cpu", "cpu")
        out_d = rt.generate_pipelined(tprompts, steps=8)
        q = torch.randn(5, t["tcfg"].d_model,
                        generator=torch.Generator().manual_seed(1))
        d, i = rt.search(q)
        d0, i0 = local.search(q)
        caches = ttf.init_cache(t["tcfg"], 2, max_seq=16)
        logits, caches, hidden = rt.decode(
            caches, torch.from_numpy(prompts[0][:2, :1]),
            torch.zeros(2, dtype=torch.int32))
        times = rt.times
        pids = rt.engine.retriever.router.fabric.pids
    assert _gone(pids)
    for j, m, dd in zip(out_j, out_m, out_d):
        np.testing.assert_array_equal(m, np.asarray(j))
        np.testing.assert_array_equal(dd, m)
    assert torch.equal(i, i0)
    np.testing.assert_allclose(d.numpy(), d0.numpy(), rtol=1e-5, atol=1e-5)
    assert logits.shape == (2, t["tcfg"].vocab_size)
    assert hidden.shape == (2, t["tcfg"].d_model)
    assert caches["classes"]["global"]["k"][:, :, 0].abs().sum() > 0
    assert len(times.decode_s) > 0 and len(times.search_s) > 0
