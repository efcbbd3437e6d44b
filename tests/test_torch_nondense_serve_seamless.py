"""SeamlessM4T-medium (a dense RETRO encoder-decoder; its audio frontend
is a stub in both packages and not on the serve path) served by the
port's engine against the JAX engine on the CPU, at its reduced size
with vocab 64.

The RETRO recipe of ``tests/test_torch_retro.py``: the decoder's own
keys over the deterministic-bigram corpus, a chunk table of the 4 tokens
after each key, ``RagConfig(mode="retro", interval=4, k=2,
chunk_len=4)``, and ``xwv``/``xwo`` scaled by 40 so that retrieval moves
tokens. The JAX engine runs once per rag mode (RETRO, and
``mode="none"``) in a module fixture, fused with synchronous retrieval;
the port's wave engine is held to its greedy tokens and per-step
retrieval ids fused (synchronous and asynchronous) and staged, and to
its ``mode="none"`` tokens, which must differ from the retrieved run's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import transformer as jtf
from repro.serve import DatastoreBuilder as JaxBuilder
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import RagConfig as JaxRagConfig
from repro.serve import RalmEngine as JaxEngine
from repro.serve import RalmRequest as JaxRequest
from repro_torch import convert
from repro_torch.serve import EngineConfig, RagConfig, RalmEngine, RalmRequest
from test_torch_retro import (CHUNK, XSCALE, _convert_ds, _convert_params,
                              _corpus, _run, _same_traces, chunk_table)

MODES = ("wave_sync", "wave_async", "staged", "lm_alone")
RAG = dict(mode="retro", interval=4, k=2, chunk_len=CHUNK)


@pytest.fixture(scope="module")
def seamless():
    cfg = dataclasses.replace(get_arch("seamless_m4t_medium").reduced,
                              vocab_size=64)
    assert cfg.arch == "encdec" and cfg.frontend == "audio"
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    g = params["classes"]["global"]
    g["xwv"] = (g["xwv"].astype(jnp.float32) * XSCALE).astype(g["xwv"].dtype)
    g["xwo"] = (g["xwo"].astype(jnp.float32) * XSCALE).astype(g["xwo"].dtype)
    corpus = _corpus()
    builder = JaxBuilder(dim=cfg.d_model, nlist=8, m=8, list_cap=512)
    keys, nxt = builder.corpus_keys(params, cfg, corpus)
    ds = builder.build(keys, payload_tokens=nxt,
                       chunk_table=chunk_table(corpus, CHUNK))
    tcfg = convert.model_config(dataclasses.asdict(cfg))
    t = dict(cfg=cfg, params=params, corpus=corpus, ds=ds, tcfg=tcfg,
             tparams=_convert_params(params, tcfg), tds=_convert_ds(ds))
    want = {}
    for mode in ("retro", "none"):
        jeng = JaxEngine.from_config(
            JaxEngineConfig(model=cfg, rag=JaxRagConfig(**dict(RAG,
                                                               mode=mode))),
            params, ds, ds.search_config(nprobe=4, k=2))
        want[mode] = _run(jeng, JaxRequest, jnp.asarray, corpus) + (
            jeng.decode_dispatches,)
    return t, want


@pytest.mark.parametrize("mode", MODES)
def test_greedy_tokens_match_jax_engine(seamless, mode):
    t, want = seamless
    rag = dict(RAG, mode="none" if mode == "lm_alone" else "retro")
    teng = RalmEngine.from_config(
        EngineConfig(model=t["tcfg"], rag=RagConfig(**rag),
                     async_retrieval=mode != "wave_sync"),
        t["tparams"], t["tds"],
        t["tds"].search_config(nprobe=4, k=2, fused=mode != "staged"),
        device="cpu")
    jout, jtr, jwaves = want["none" if mode == "lm_alone" else "retro"]
    tout, ttr = _run(teng, RalmRequest, torch.from_numpy, t["corpus"])
    for j, o in zip(jout, tout):
        np.testing.assert_array_equal(o, j)
    _same_traces(jtr, ttr)
    assert teng.decode_dispatches == jwaves
    if mode == "lm_alone":
        assert ttr == [[], []]
        differ = sum(int((a != b).sum())
                     for a, b in zip(want["retro"][0], tout))
        assert differ > 0
    else:
        assert [e["step"] for e in ttr[0]] == [0, 4, 8]
        assert tuple(teng.pool.enc.shape) == (teng.pool.capacity + 1,
                                              2 * CHUNK, t["cfg"].d_model)
    if mode == "staged":
        st = teng.retriever.service.stats
        assert st.scan_dispatches == t["tds"].num_shards * st.num_batches
