"""The port's per-sequence loop (``EngineConfig.wave_decode=False``), the
reference's parity oracle, against the JAX package and against the
port's own wave path.

  * ``transformer.decode_step`` (one token per row over per-request
    caches, no slots, no ``kv_len`` crop) against the JAX
    ``decode_step`` on the reduced Dec-S config: float32 within 1e-5,
    bf16 within 2^-6 of the output range (the two packages round at the
    same places but accumulate in another order);
  * per-sequence greedy tokens equal to the port's wave tokens and to
    the JAX engine's per-sequence tokens on the ``tiny_ralm`` recipe;
  * the twins of ``tests/test_kvpool.py``'s wave-vs-oracle tests (one
    dispatch per wave, mixed prompt lengths, mid-run admission, slot
    reuse, autogrow), with the port's per-sequence loop as the oracle;
  * ``test_forced_mismatch_rollback_matches_oracle`` and
    ``test_speculation_requires_wave_decode`` in their reference form
    (``tests/test_speculation.py``).
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
from repro.serve import RagConfig as JaxRagConfig
from repro.serve import RalmEngine as JaxEngine
from repro.serve import RalmRequest as JaxRequest
from repro_torch import convert
from repro_torch.models import transformer as ttf
from repro_torch.retrieval import ServiceConfig
from repro_torch.serve import EngineConfig, RagConfig, RalmEngine, RalmRequest


# ---------------------------------------------------------------------------
# decode_step against the reference
# ---------------------------------------------------------------------------

def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, dtype):
    a, b = a.float().numpy(), _np(b)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(a - b).max() <= 2 ** -6 * np.abs(b).max(), \
            np.abs(a - b).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    """Three rows, each over its own cache row (prefilled with random
    keys and values), at ragged positions: logits, hidden states and the
    in-place cache update equal the reference's."""
    jcfg = dataclasses.replace(get_arch("dec_s").reduced, dtype=dtype)
    tcfg = convert.model_config(dataclasses.asdict(jcfg))
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params(
        jax.tree.map(lambda x: np.array(x.astype(jnp.float32)), jp), tcfg)
    rng = np.random.default_rng(2)
    B, S = 3, 32
    jc, tc = jtf.init_cache(jcfg, B, S), ttf.init_cache(tcfg, B, S)
    for key in ("k", "v"):
        fill = rng.normal(size=jc["classes"]["global"][key].shape)
        jc["classes"]["global"][key] = jnp.asarray(
            fill.astype(np.float32)).astype(jcfg.dtype)
        tc["classes"]["global"][key] = torch.from_numpy(
            _np(jc["classes"]["global"][key])).to(tcfg.torch_dtype)
    pos = np.array([7, 30, 0], np.int32)
    tok = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
    jl, jc2, jh = jtf.decode_step(jp, jcfg, jc, jnp.asarray(tok),
                                  jnp.asarray(pos), return_hidden=True)
    tl, tc2, th = ttf.decode_step(tp, tcfg, tc, torch.from_numpy(tok),
                                  torch.from_numpy(pos), return_hidden=True)
    assert tuple(tl.shape) == (B, jcfg.vocab_size)
    assert tuple(th.shape) == (B, jcfg.d_model)
    _close(tl, jl, dtype)
    _close(th, jh, dtype)
    for key in ("k", "v"):
        _close(tc2["classes"]["global"][key], jc2["classes"]["global"][key],
               dtype)


# ---------------------------------------------------------------------------
# the serving recipe
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_ralm():
    cfg = dataclasses.replace(get_arch("dec_s").reduced, vocab_size=64)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    corpus = [rng.integers(0, 64, size=(64,))]
    for _ in range(31):
        corpus.append((3 * corpus[-1] + 1) % 64)
    corpus = np.stack(corpus, axis=1).astype(np.int32)
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
                jccfg=ds.search_config(nprobe=4, k=8, backend="ref"),
                tcfg=tcfg, tparams=tparams, tds=tds,
                tccfg=tds.search_config(nprobe=4, k=8),
                trag=RagConfig(**dataclasses.asdict(rag)))


def _engine(t, async_retrieval=False, spec_k=0, **kw):
    if async_retrieval or spec_k:
        ret = t["tds"].async_retriever(
            t["tccfg"], service_cfg=ServiceConfig(measure=False))
    else:
        ret = t["tds"].retriever(t["tccfg"])
    return RalmEngine.monolithic(t["tparams"], t["tcfg"], t["trag"],
                                 retriever=ret, speculate_k=spec_k, **kw)


def oracle_tokens(t, prompt, steps):
    """The port's per-sequence loop (one decode per request)."""
    eng = _engine(t, wave=False)
    return eng.generate(torch.from_numpy(np.asarray(prompt)), steps=steps)


def _run(eng, prompts, steps):
    jax_engine = isinstance(eng, JaxEngine)
    req, conv = ((JaxRequest, jnp.asarray) if jax_engine
                 else (RalmRequest, torch.from_numpy))
    rids = [eng.submit(req(prompt=conv(p), steps=steps)) for p in prompts]
    by_id = {r.request_id: np.asarray(r.tokens) for r in eng.run()}
    return [by_id[r] for r in rids]


@pytest.mark.parametrize("async_retrieval", [False, True])
def test_per_sequence_tokens_match_wave_and_jax(tiny_ralm, async_retrieval):
    """Three requests of ragged lengths decoded together: the port's
    per-sequence tokens equal its wave tokens and the JAX engine's
    per-sequence tokens; one decode per request per step after step 0."""
    t = tiny_ralm
    c = t["corpus"]
    prompts = [c[0:2, :6], c[2:4, :9], c[4:5, :4]]
    steps = 7
    if async_retrieval:
        jret = t["ds"].async_retriever(t["jccfg"])
    else:
        jret = t["ds"].retriever(t["jccfg"])
    jeng = JaxEngine.monolithic(t["params"], t["cfg"], t["rag"],
                                retriever=jret, wave=False)
    want = _run(jeng, prompts, steps)
    per_seq = _engine(t, async_retrieval, wave=False)
    got = _run(per_seq, prompts, steps)
    wave = _run(_engine(t, async_retrieval), prompts, steps)
    for a, b, w in zip(got, want, wave):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, w)
    assert per_seq.decode_dispatches == len(prompts) * (steps - 1)
    assert per_seq.pool is None


def test_per_sequence_from_config_and_cancel(tiny_ralm):
    """``EngineConfig(wave_decode=False)`` builds the per-sequence loop;
    a cancelled request finishes at the next step, flagged, and its own
    caches are dropped; the other request's tokens are unchanged."""
    t = tiny_ralm
    eng = RalmEngine.from_config(
        EngineConfig(model=t["tcfg"], rag=t["trag"], wave_decode=False,
                     async_retrieval=True, retrieval_measure=False),
        t["tparams"], t["tds"], t["tccfg"], device="cpu")
    assert not eng.wave
    c = t["corpus"]
    keep = eng.submit(RalmRequest(prompt=torch.from_numpy(c[0:2, :8]),
                                  steps=6))
    drop = eng.submit(RalmRequest(prompt=torch.from_numpy(c[2:4, :8]),
                                  steps=6))
    done = eng.step() + eng.step()
    seq = next(s for s in eng.scheduler.active
               if s.request.request_id == drop)
    assert seq.caches is not None
    assert eng.scheduler.cancel(drop)
    done += eng.run()
    by_id = {r.request_id: r for r in done}
    assert by_id[drop].cancelled and by_id[drop].steps == 2
    assert seq.caches is None
    assert not by_id[keep].cancelled
    np.testing.assert_array_equal(by_id[keep].tokens,
                                  oracle_tokens(t, c[0:2, :8], 6))


# ---------------------------------------------------------------------------
# twins of tests/test_kvpool.py: the wave path against the oracle
# ---------------------------------------------------------------------------

def test_one_decode_dispatch_per_wave(tiny_ralm):
    """Three concurrent requests: one decode per scheduler wave, versus
    one per request per step on the per-sequence loop."""
    t = tiny_ralm
    c = t["corpus"]
    eng = _engine(t)
    for i in range(3):
        eng.submit(RalmRequest(prompt=torch.from_numpy(c[i:i + 1, :8]),
                               steps=4))
    assert eng.step() == [] and eng.decode_dispatches == 0
    eng.step()
    assert eng.decode_dispatches == 1
    eng.run()
    assert eng.decode_dispatches == 3
    assert eng.pool.stats.mean_wave() == pytest.approx(3.0)
    oracle = _engine(t, wave=False)
    for i in range(3):
        oracle.submit(RalmRequest(prompt=torch.from_numpy(c[i:i + 1, :8]),
                                  steps=4))
    oracle.run()
    assert oracle.decode_dispatches == 9


def test_wave_parity_mixed_prompt_lengths(tiny_ralm):
    t = tiny_ralm
    c = t["corpus"]
    specs = [(c[:2, :5], 6), (c[2:4, :8], 6), (c[4:5, :11], 4)]
    eng = _engine(t)
    rids = [eng.submit(RalmRequest(prompt=torch.from_numpy(p), steps=s))
            for p, s in specs]
    by_id = {r.request_id: r.tokens for r in eng.run()}
    for rid, (p, s) in zip(rids, specs):
        np.testing.assert_array_equal(by_id[rid], oracle_tokens(t, p, s))


def test_wave_parity_mid_run_admission_and_early_finishers(tiny_ralm):
    t = tiny_ralm
    c = t["corpus"]
    eng = _engine(t, kv_slots=4)
    ra = eng.submit(RalmRequest(prompt=torch.from_numpy(c[:2, :8]), steps=6))
    eng.step()
    eng.step()
    rb = eng.submit(RalmRequest(prompt=torch.from_numpy(c[2:4, :5]),
                                steps=2))
    rc = eng.submit(RalmRequest(prompt=torch.from_numpy(c[4:6, :6]),
                                steps=3))
    completions = []
    deferred = False
    while eng.scheduler.has_work:
        completions.extend(eng.step())
        deferred |= len(eng.scheduler.queue) > 0
    assert deferred
    assert [r.request_id for r in completions] == [rb, ra, rc]
    by_id = {r.request_id: r.tokens for r in completions}
    np.testing.assert_array_equal(by_id[ra], oracle_tokens(t, c[:2, :8], 6))
    np.testing.assert_array_equal(by_id[rb], oracle_tokens(t, c[2:4, :5], 2))
    np.testing.assert_array_equal(by_id[rc], oracle_tokens(t, c[4:6, :6], 3))
    assert eng.pool.num_free == 4
    assert eng.pool.stats.high_water == 4
    assert eng.pool.stats.slot_grows == 0


def test_wave_parity_slot_reuse_back_to_back(tiny_ralm):
    t = tiny_ralm
    c = t["corpus"]
    eng = _engine(t, kv_slots=2)
    out1 = eng.generate(torch.from_numpy(c[:2, :8]), steps=5)
    out2 = eng.generate(torch.from_numpy(c[6:8, :7]), steps=5)
    assert eng.pool.stats.allocs == 4 and eng.pool.stats.releases == 4
    np.testing.assert_array_equal(out1, oracle_tokens(t, c[:2, :8], 5))
    np.testing.assert_array_equal(out2, oracle_tokens(t, c[6:8, :7], 5))


def test_wave_pool_autogrow_parity(tiny_ralm):
    t = tiny_ralm
    c = t["corpus"]
    eng = _engine(t)
    ra = eng.submit(RalmRequest(prompt=torch.from_numpy(c[:2, :6]), steps=3))
    eng.step()
    big = c[2:12, :12]
    rb = eng.submit(RalmRequest(prompt=torch.from_numpy(big), steps=6))
    by_id = {r.request_id: r.tokens for r in eng.run()}
    assert eng.pool.stats.slot_grows >= 1 and eng.pool.stats.seq_grows >= 1
    np.testing.assert_array_equal(by_id[ra], oracle_tokens(t, c[:2, :6], 3))
    np.testing.assert_array_equal(by_id[rb], oracle_tokens(t, big, 6))


# ---------------------------------------------------------------------------
# speculation against the per-sequence oracle
# ---------------------------------------------------------------------------

def test_forced_mismatch_rollback_matches_oracle(tiny_ralm):
    """Poison every speculation seed (dists 0, ids 0: one constant wrong
    payload token) so verification must reject and roll back; the stream
    must still equal the per-sequence oracle with blocking searches."""
    t = tiny_ralm
    prompt = t["corpus"][0:2, :4]
    oracle = oracle_tokens(t, prompt, 8)
    eng = _engine(t, spec_k=1)
    eng.submit(RalmRequest(prompt=torch.from_numpy(prompt), steps=8))
    done = []
    while eng.scheduler.has_work:
        done += eng.step()
        for seq in eng.scheduler.active:
            if seq.last_neighbors is not None:
                d, i = seq.last_neighbors
                seq.last_neighbors = (torch.zeros_like(d),
                                      torch.zeros_like(i))
    np.testing.assert_array_equal(oracle, done[0].tokens)
    st_ = eng.spec_stats
    assert st_.spec_rollbacks >= 1
    assert st_.spec_replay.count == st_.spec_rollbacks


def test_speculation_requires_wave_decode(tiny_ralm):
    t = tiny_ralm
    with pytest.warns(RuntimeWarning, match="wave"):
        eng = _engine(t, spec_k=1, wave=False)
    assert eng.speculate_k == 0 and eng._spec_depth == 0
