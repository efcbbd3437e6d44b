"""The non-dense assigned decoders served by the port's engine against
the JAX engine, end to end on the CPU: RWKV-6-3B (its recurrent state in
the KV pool's rows, no attention) and the MoE backbones Phi-3.5-MoE and
DBRX (4 experts top-2 at the reduced size; a wave's padded bucket sets
the experts' capacity), at their reduced sizes with vocab 64.

The recipe of ``tests/test_torch_assigned_serve.py`` (the
deterministic-bigram corpus, k 8, lam 0.999, prompts of 12 and 9 tokens
with 10 and 8 steps; the datastore built by the reference's builder and
converted). The JAX engine runs once per rag mode (kNN-LM, and
``mode="none"``) in a module fixture, fused with synchronous retrieval;
the port's wave engine is held to its greedy tokens fused (synchronous
and asynchronous), staged, and with ``mode="none"``. Speculation is
turned off with a warning for RWKV-6, as in the reference: its state
cannot be rewound.
Hymba and SeamlessM4T serve in files of their own.
"""
import numpy as np
import pytest

from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import RagConfig as JaxRagConfig
from repro.serve import RalmEngine as JaxEngine
from repro.serve import RalmRequest as JaxRequest
from repro_torch.serve import EngineConfig, RagConfig, RalmEngine, RalmRequest
from test_torch_assigned_serve import _run, make_backbone

MODES = ("wave_sync", "wave_async", "staged", "lm_alone")
RAG = dict(mode="knnlm", interval=1, k=8, lam=0.999, temperature=1.0)


def jax_tokens(t):
    """The JAX engine's greedy tokens per rag mode (fused, synchronous)
    and its decode waves."""
    import jax.numpy as jnp

    out = {}
    for rag_mode in ("knnlm", "none"):
        jeng = JaxEngine.from_config(
            JaxEngineConfig(model=t["cfg"],
                            rag=JaxRagConfig(**dict(RAG, mode=rag_mode))),
            t["params"], t["ds"], t["ds"].search_config(nprobe=4, k=8))
        out[rag_mode] = (_run(jeng, JaxRequest, jnp.asarray, t["corpus"]),
                         jeng.decode_dispatches)
    return out


def port_engine(t, mode, **kw):
    fused = mode != "staged"
    rag = dict(RAG, mode="none" if mode == "lm_alone" else "knnlm")
    return RalmEngine.from_config(
        EngineConfig(model=t["tcfg"], rag=RagConfig(**rag),
                     async_retrieval=mode != "wave_sync", **kw),
        t["tparams"], t["tds"],
        t["tds"].search_config(nprobe=4, k=8, fused=fused), device="cpu")


def check_mode(t, want, mode):
    """One port engine at ``mode`` against the JAX engine's tokens."""
    import torch

    teng = port_engine(t, mode)
    jout, jwaves = want["none" if mode == "lm_alone" else "knnlm"]
    tout = _run(teng, RalmRequest, torch.from_numpy, t["corpus"])
    for j, o in zip(jout, tout):
        np.testing.assert_array_equal(o, j)
    assert teng.decode_dispatches == jwaves == 9
    if mode == "staged":
        st = teng.retriever.service.stats
        assert st.scan_dispatches == t["tds"].num_shards * st.num_batches
    if mode == "lm_alone":
        # retrieval acts: the kNN-LM's tokens differ from the LM's alone
        assert any((a != b).any() for a, b in zip(want["knnlm"][0], jout))
    return teng


@pytest.fixture(scope="module",
                params=("rwkv6_3b", "phi3_5_moe_42b", "dbrx_132b"))
def backbone(request):
    t = make_backbone(request.param)
    return t, jax_tokens(t)


@pytest.mark.parametrize("mode", MODES)
def test_greedy_tokens_match_jax_engine(backbone, mode):
    t, want = backbone
    teng = check_mode(t, want, mode)
    if t["cfg"].block == "rwkv6":
        assert set(teng.pool.caches["classes"]["global"]) == {"wkv", "st",
                                                              "sc"}


def test_speculation_refused_for_recurrent_state():
    t = make_backbone("rwkv6_3b")
    with pytest.warns(RuntimeWarning, match="recurrent-state"):
        eng = port_engine(t, "wave_async", speculate_k=1)
    assert eng.speculate_k == 0
