"""The port's serving engine against the JAX engine, end to end on the CPU.

The ``tiny_ralm`` recipe of ``tests/test_serve.py`` is rebuilt here: a
reduced Dec-S LM (vocab 64) and a kNN-LM datastore over a
deterministic-bigram corpus, built by the reference's
``DatastoreBuilder`` and converted leaf for leaf. Greedy tokens must be
identical to the JAX ``RalmEngine.from_config`` output, with synchronous
and asynchronous retrieval, for two concurrent requests under wave
decode.
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
from repro_torch.models import transformer as ttf
from repro_torch.serve import (DatastoreBuilder, EngineConfig, RagConfig,
                               RalmEngine, RalmRequest)


def _corpus():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 64, size=(64,))]
    for _ in range(31):
        seqs.append((3 * seqs[-1] + 1) % 64)
    return np.stack(seqs, axis=1).astype(np.int32)


@pytest.fixture(scope="module")
def tiny_ralm():
    cfg = dataclasses.replace(get_arch("dec_s").reduced, vocab_size=64)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    corpus = _corpus()
    ds = JaxBuilder(dim=cfg.d_model, nlist=8, m=8,
                    list_cap=512).from_corpus(params, cfg, corpus)
    rag = JaxRagConfig(mode="knnlm", interval=1, k=8, lam=0.999,
                       temperature=1.0)
    tcfg = convert.model_config(dataclasses.asdict(cfg))
    tparams = convert.lm_params(
        jax.tree.map(lambda x: np.array(x.astype(jnp.float32)), params),
        tcfg)
    tds = convert.datastore(
        dataclasses.asdict(ds.index_cfg), np.array(ds.params.coarse_centroids),
        np.array(ds.params.codebooks),
        [(np.array(s.codes), np.array(s.ids), np.array(s.list_len))
         for s in ds.shards],
        payload_tokens=np.array(ds.payload_tokens),
        num_vectors=ds.num_vectors)
    return dict(cfg=cfg, params=params, corpus=corpus, ds=ds, rag=rag,
                tcfg=tcfg, tparams=tparams, tds=tds,
                trag=RagConfig(**dataclasses.asdict(rag)))


def _run(engine, request_cls, prompt_fn, corpus):
    rids = [engine.submit(request_cls(prompt=prompt_fn(corpus[:2, :8]),
                                      steps=8)),
            engine.submit(request_cls(prompt=prompt_fn(corpus[2:5, :6]),
                                      steps=6))]
    by_id = {r.request_id: np.asarray(r.tokens) for r in engine.run()}
    return [by_id[r] for r in rids]


@pytest.mark.parametrize("async_retrieval", [False, True])
def test_greedy_tokens_match_jax_engine(tiny_ralm, async_retrieval):
    t = tiny_ralm
    jeng = JaxEngine.from_config(
        JaxEngineConfig(model=t["cfg"], rag=t["rag"],
                        async_retrieval=async_retrieval),
        t["params"], t["ds"], t["ds"].search_config(nprobe=4, k=8))
    teng = RalmEngine.from_config(
        EngineConfig(model=t["tcfg"], rag=t["trag"],
                     async_retrieval=async_retrieval),
        t["tparams"], t["tds"], t["tds"].search_config(nprobe=4, k=8),
        device="cpu")
    jout = _run(jeng, JaxRequest, jnp.asarray, t["corpus"])
    tout = _run(teng, RalmRequest, torch.from_numpy, t["corpus"])
    for j, o in zip(jout, tout):
        np.testing.assert_array_equal(o, j)
    assert teng.decode_dispatches == jeng.decode_dispatches == 7
    if async_retrieval:
        st = teng.retriever.service.stats
        assert st.num_batches == st.scan_dispatches == 8
        assert st.max_coalesced == 5


@pytest.mark.parametrize("async_retrieval", [False, True])
def test_staged_scan_tokens_match_jax_engine(tiny_ralm, async_retrieval):
    """A staged deployment (``search_config(fused=False)``: the IVF probe,
    then one ``pq_adc_topk`` scan per shard) gives the JAX engine's
    greedy tokens with ``kernel_fused=False``, and counts one scan
    dispatch per shard per flush."""
    t = tiny_ralm
    jeng = JaxEngine.from_config(
        JaxEngineConfig(model=t["cfg"], rag=t["rag"],
                        async_retrieval=async_retrieval, kernel_fused=False),
        t["params"], t["ds"], t["ds"].search_config(nprobe=4, k=8))
    teng = RalmEngine.from_config(
        EngineConfig(model=t["tcfg"], rag=t["trag"],
                     async_retrieval=async_retrieval),
        t["tparams"], t["tds"],
        t["tds"].search_config(nprobe=4, k=8, fused=False), device="cpu")
    pipeline = teng.retriever.service.pipeline
    assert not pipeline.cfg.fused and pipeline.stacked is None
    jout = _run(jeng, JaxRequest, jnp.asarray, t["corpus"])
    tout = _run(teng, RalmRequest, torch.from_numpy, t["corpus"])
    for j, o in zip(jout, tout):
        np.testing.assert_array_equal(o, j)
    st = teng.retriever.service.stats
    S = t["tds"].num_shards
    assert S == 2 and st.scan_dispatches == S * st.num_batches
    if async_retrieval:
        assert st.num_batches == 8


def test_torch_twin_of_serve_ralm_example():
    """``examples/serve_ralm.py`` with the port alone: the port's own
    init and datastore build, two request batches in flight; the
    untrained LM + datastore reproduce the memorized continuation."""
    cfg = dataclasses.replace(
        convert.model_config(dataclasses.asdict(
            get_arch("dec_s").reduced)), vocab_size=64)
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    corpus = _corpus()
    ds = DatastoreBuilder(dim=cfg.d_model, nlist=8, m=8, list_cap=512,
                          device="cpu").from_corpus(params, cfg, corpus)
    assert ds.num_vectors == 64 * 31
    assert (ds.payload_tokens.numpy() == corpus[:, 1:].reshape(-1)).all()
    rag = RagConfig(mode="knnlm", interval=1, k=8, lam=0.999,
                    temperature=1.0)
    engine = RalmEngine.monolithic(
        params, cfg, rag, retriever=ds.retriever(ds.search_config(nprobe=4,
                                                                  k=8)))
    outs = engine.generate_batches([corpus[:4, :8], corpus[4:8, :8]], steps=8)
    for out, rows in zip(outs, (slice(0, 4), slice(4, 8))):
        assert (out[:, 8:16] == corpus[rows, 8:16]).mean() == 1.0
    assert engine.pool.stats.mean_wave() == 8.0


def test_fixed_pool_mid_run_admission_matches_jax(tiny_ralm):
    """kv_slots=4: a request admitted mid-run joins the wave, a short one
    finishes early and frees its slots, a queued one waits for them.
    Completion order and tokens equal the JAX engine's."""
    t, c = tiny_ralm, tiny_ralm["corpus"]

    def scenario(engine, req, conv):
        ra = engine.submit(req(prompt=conv(c[:2, :8]), steps=6))
        engine.step()
        engine.step()
        rb = engine.submit(req(prompt=conv(c[2:4, :5]), steps=2))
        rc = engine.submit(req(prompt=conv(c[4:6, :6]), steps=3))
        done, deferred = [], False
        while engine.scheduler.has_work:
            done.extend(engine.step())
            deferred |= len(engine.scheduler.queue) > 0
        assert deferred
        assert [r.request_id for r in done] == [rb, ra, rc]
        by_id = {r.request_id: np.asarray(r.tokens) for r in done}
        return [by_id[r] for r in (ra, rb, rc)]

    jeng = JaxEngine.monolithic(
        t["params"], t["cfg"], t["rag"],
        t["ds"].retriever(t["ds"].search_config(nprobe=4, k=8)), kv_slots=4)
    teng = RalmEngine.monolithic(
        t["tparams"], t["tcfg"], t["trag"],
        t["tds"].retriever(t["tds"].search_config(nprobe=4, k=8)),
        kv_slots=4)
    for j, o in zip(scenario(jeng, JaxRequest, jnp.asarray),
                    scenario(teng, RalmRequest, torch.from_numpy)):
        np.testing.assert_array_equal(o, j)
    st = teng.pool.stats
    assert teng.pool.num_free == 4 and st.high_water == 4
    assert st.slot_grows == 0
    with pytest.raises(ValueError, match="never fit"):
        teng.submit(RalmRequest(prompt=torch.from_numpy(c[:5, :8]), steps=2))


def test_sampled_request_beside_a_greedy_one(tiny_ralm):
    """A sampled request draws from its own generator (same seed, same
    tokens) and does not perturb a greedy request in the same wave."""
    t, c = tiny_ralm, tiny_ralm["corpus"]

    def run(seed):
        eng = RalmEngine.monolithic(
            t["tparams"], t["tcfg"], t["trag"],
            t["tds"].retriever(t["tds"].search_config(nprobe=4, k=8)))
        rs = eng.submit(RalmRequest(prompt=torch.from_numpy(c[:2, :8]),
                                    steps=5, greedy=False,
                                    rng=torch.Generator().manual_seed(seed)))
        rg = eng.submit(RalmRequest(prompt=torch.from_numpy(c[2:4, :8]),
                                    steps=5))
        by_id = {r.request_id: r.tokens for r in eng.run()}
        return by_id[rs], by_id[rg]

    s1, g1 = run(7)
    s2, g2 = run(7)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(g1, g2)
    assert s1.shape == (2, 13) and ((s1 >= 0) & (s1 < 64)).all()
    np.testing.assert_array_equal(s1[:, :8], c[:2, :8])
    solo = RalmEngine.monolithic(
        t["tparams"], t["tcfg"], t["trag"],
        t["tds"].retriever(t["tds"].search_config(nprobe=4, k=8))
    ).generate(torch.from_numpy(c[2:4, :8]), steps=5)
    np.testing.assert_array_equal(g1, solo)
