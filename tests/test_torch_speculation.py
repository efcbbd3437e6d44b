"""Speculative retrieval in the port, replayed from ``tests/test_speculation.py``.

The ``tiny_ralm`` recipe of ``tests/test_serve.py`` (a reduced Dec-S LM,
vocab 64, over a deterministic-bigram corpus) is built by the reference
and converted leaf for leaf. The corpus is speculation-hostile: the
stale neighbours almost always predict another token than the real
ones, so nearly every point rolls back and the rollback path runs all
the time. The claim is GREEDY PARITY: the port's tokens with
speculation equal its tokens without it and the JAX engine's without
it, and the port's speculation counters equal the JAX speculating
engine's on the same traffic.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_arch
from repro.models import transformer as jtf
from repro.retrieval import ServiceConfig as JaxServiceConfig
from repro.retrieval.stats import RetrievalStats as JaxStats
from repro.serve import DatastoreBuilder as JaxBuilder
from repro.serve import RagConfig as JaxRagConfig
from repro.serve import RalmEngine as JaxEngine
from repro.serve import RalmRequest as JaxRequest
from repro_torch import convert
from repro_torch.models import transformer as ttf
from repro_torch.retrieval import RetrievalStats, ServiceConfig
from repro_torch.serve import (EngineConfig, RagConfig, RalmEngine,
                               RalmRequest)

SPEC_COUNTERS = ("spec_issued", "spec_verified", "spec_accepted",
                 "spec_rollbacks", "spec_discarded", "spec_replayed_steps")


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
                tccfg=tds.search_config(nprobe=4, k=8))


def _build(t, spec_k, *, jax_engine=False, lam=None, interval=None,
           verify=True, cache=0):
    """A speculating (or not) engine over an async retriever, the port's
    or the reference's."""
    rag = t["rag"]
    if lam is not None:
        rag = dataclasses.replace(rag, lam=lam)
    if interval is not None:
        rag = dataclasses.replace(rag, interval=interval)
    if jax_engine:
        ret = t["ds"].async_retriever(t["jccfg"], service_cfg=JaxServiceConfig(
            measure=False, cache_entries=cache))
        return JaxEngine.monolithic(t["params"], t["cfg"], rag, retriever=ret,
                                    speculate_k=spec_k,
                                    speculate_verify=verify)
    ret = t["tds"].async_retriever(t["tccfg"], service_cfg=ServiceConfig(
        measure=False, cache_entries=cache))
    return RalmEngine.monolithic(t["tparams"], t["tcfg"],
                                 RagConfig(**dataclasses.asdict(rag)),
                                 retriever=ret, speculate_k=spec_k,
                                 speculate_verify=verify)


def _run(eng, prompts, steps=8, stagger=0):
    """Submit ``prompts`` (the first at once, the rest after ``stagger``
    scheduler steps, so waves mix sequences at different depths) and
    return tokens per request in submission order."""
    jax_engine = isinstance(eng, JaxEngine)
    req, conv = ((JaxRequest, jnp.asarray) if jax_engine
                 else (RalmRequest, torch.from_numpy))
    done = []
    rids = [eng.submit(req(prompt=conv(prompts[0]), steps=steps))]
    for _ in range(stagger):
        done += eng.step()
    rids += [eng.submit(req(prompt=conv(p), steps=steps))
             for p in prompts[1:]]
    done += eng.run()
    by_id = {r.request_id: np.asarray(r.tokens) for r in done}
    return [by_id[r] for r in rids]


def _prompts(corpus, n=2):
    return [corpus[2 * i:2 * i + 2, :4] for i in range(n)]


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _counters(eng):
    st_ = eng.spec_stats
    return {k: getattr(st_, k) for k in SPEC_COUNTERS}


# ---------------------------------------------------------------------------
# greedy parity: speculation + verification == speculation off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [1, 2])
def test_greedy_parity(tiny_ralm, spec_k):
    prompts = _prompts(tiny_ralm["corpus"])
    jax_base = _run(_build(tiny_ralm, 0, jax_engine=True), prompts)
    base = _run(_build(tiny_ralm, 0), prompts)
    eng = _build(tiny_ralm, spec_k)
    spec = _run(eng, prompts)
    _assert_same(base, jax_base)
    _assert_same(spec, jax_base)
    jeng = _build(tiny_ralm, spec_k, jax_engine=True)
    _assert_same(_run(jeng, prompts), jax_base)
    st_ = eng.spec_stats
    assert st_.spec_issued > 0 and st_.spec_verified > 0
    assert st_.spec_accepted + st_.spec_rollbacks == st_.spec_verified
    assert _counters(eng) == _counters(jeng)
    # a point verified after its sequence's last decode has no KV to drop
    assert 0 < eng.pool.stats.rewinds <= st_.spec_rollbacks
    assert eng.retriever.service.num_inflight == 0


def test_greedy_parity_lm_dominant_mix(tiny_ralm):
    """Low lam: the LM logits weigh in the mix, so accept/reject flips
    on small distance changes; parity must survive the rollbacks."""
    prompts = _prompts(tiny_ralm["corpus"])
    jax_base = _run(_build(tiny_ralm, 0, jax_engine=True, lam=0.25), prompts)
    eng = _build(tiny_ralm, 1, lam=0.25)
    _assert_same(_run(eng, prompts), jax_base)
    _assert_same(_run(_build(tiny_ralm, 0, lam=0.25), prompts), jax_base)
    assert eng.spec_stats.spec_verified > 0


@pytest.mark.parametrize("interval,spec_k,stagger", [
    (1, 1, 2),     # every step due, waves at mixed depths
    (2, 2, 1),     # sparse retrieval, deeper outstanding window
    (3, 1, 0),     # interval coprime with the wave count
])
def test_greedy_parity_staggered(tiny_ralm, interval, spec_k, stagger):
    prompts = _prompts(tiny_ralm["corpus"])
    jax_base = _run(_build(tiny_ralm, 0, jax_engine=True, interval=interval),
                    prompts, steps=9, stagger=stagger)
    base = _run(_build(tiny_ralm, 0, interval=interval), prompts, steps=9,
                stagger=stagger)
    spec = _run(_build(tiny_ralm, spec_k, interval=interval), prompts,
                steps=9, stagger=stagger)
    _assert_same(base, jax_base)
    _assert_same(spec, jax_base)


_BASELINES = {}


@settings(max_examples=5, deadline=None)
@given(st.integers(1, 3), st.integers(1, 2), st.integers(0, 2),
       st.sampled_from([0.999, 0.5]))
def test_greedy_parity_random(tiny_ralm, interval, spec_k, stagger, lam):
    """Property form of the parity claim over random (interval, depth,
    stagger, lam) corners; baselines (the port without speculation) are
    memoized per corner."""
    key = (interval, stagger, lam)
    if key not in _BASELINES:
        _BASELINES[key] = _run(_build(tiny_ralm, 0, lam=lam,
                                      interval=interval),
                               _prompts(tiny_ralm["corpus"]), steps=7,
                               stagger=stagger)
    eng = _build(tiny_ralm, spec_k, lam=lam, interval=interval)
    spec = _run(eng, _prompts(tiny_ralm["corpus"]), steps=7, stagger=stagger)
    _assert_same(spec, _BASELINES[key])


# ---------------------------------------------------------------------------
# forced mismatch: rollback replay == the engine without speculation
# ---------------------------------------------------------------------------

def test_forced_mismatch_rollback_matches_oracle(tiny_ralm):
    """Poison every speculation seed with garbage neighbours (dists 0,
    ids 0: one constant wrong payload token) so verification must reject
    and roll back; the stream must still equal the JAX engine's without
    speculation (the port has no per-sequence loop to be the oracle)."""
    t = tiny_ralm
    prompt = t["corpus"][0:2, :4]
    oracle = _run(_build(t, 0, jax_engine=True), [prompt])[0]

    eng = _build(t, 1)
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


def test_no_verify_adopts_stale_neighbors(tiny_ralm):
    """verify=False trusts the speculated tokens outright: no rollbacks
    and no verifications, as in the reference."""
    eng = _build(tiny_ralm, 1, verify=False)
    jeng = _build(tiny_ralm, 1, jax_engine=True, verify=False)
    prompts = _prompts(tiny_ralm["corpus"])
    _assert_same(_run(eng, prompts), _run(jeng, prompts))
    st_ = eng.spec_stats
    assert st_.spec_issued > 0
    assert st_.spec_rollbacks == 0 and st_.spec_verified == 0
    assert _counters(eng) == _counters(jeng)


# ---------------------------------------------------------------------------
# eligibility gates
# ---------------------------------------------------------------------------

def test_sampled_requests_never_speculate(tiny_ralm):
    """Sampling consumes generator state a rollback cannot restore: the
    per-row gate keeps sampled requests on the waiting path."""
    eng = _build(tiny_ralm, 1)
    eng.submit(RalmRequest(
        prompt=torch.from_numpy(tiny_ralm["corpus"][0:2, :4]), steps=6,
        greedy=False, rng=torch.Generator().manual_seed(7)))
    eng.run()
    assert eng.spec_stats.spec_issued == 0


def test_engine_caps_depth_for_windowed_models(tiny_ralm):
    t = tiny_ralm
    wcfg = dataclasses.replace(t["tcfg"], window=8, layer_pattern=("local",))
    wparams = ttf.init_params(torch.Generator().manual_seed(0), wcfg)
    ret = t["tds"].async_retriever(t["tccfg"],
                                   service_cfg=ServiceConfig(measure=False))
    eng = RalmEngine.monolithic(wparams, wcfg, RagConfig(mode="knnlm", k=8),
                                retriever=ret, speculate_k=3)
    assert eng.speculate_k == 3 and eng._spec_depth == 1


@pytest.mark.parametrize("recurrent", [dict(ssm_state=16),
                                       dict(block="rwkv6")])
def test_recurrent_blocks_disable_speculation(tiny_ralm, recurrent):
    t = tiny_ralm
    rcfg = dataclasses.replace(t["tcfg"], **recurrent)
    with pytest.warns(RuntimeWarning, match="recurrent"):
        eng = RalmEngine.monolithic(t["tparams"], rcfg, RagConfig(k=8),
                                    speculate_k=2)
    assert eng.speculate_k == 0 and eng._spec_depth == 0


def test_from_config_needs_async_retrieval(tiny_ralm):
    """speculate_k and retrieval_cache live on the RetrievalService: a
    synchronous retriever warns and runs without them."""
    t = tiny_ralm
    trag = RagConfig(**dataclasses.asdict(t["rag"]))
    with pytest.warns(RuntimeWarning) as rec:
        eng = RalmEngine.from_config(
            EngineConfig(model=t["tcfg"], rag=trag, speculate_k=2,
                         retrieval_cache=64),
            t["tparams"], t["tds"], t["tccfg"], device="cpu")
    msgs = " ".join(str(w.message) for w in rec)
    assert "retrieval_cache" in msgs and "speculate_k" in msgs
    assert eng.speculate_k == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng = RalmEngine.from_config(
            EngineConfig(model=t["tcfg"], rag=trag, async_retrieval=True,
                         speculate_k=2, speculate_verify=False,
                         retrieval_cache=64),
            t["tparams"], t["tds"], t["tccfg"], device="cpu")
    assert eng.speculate_k == 2 and not eng.speculate_verify
    assert eng.retriever.service.cache.capacity == 64


# ---------------------------------------------------------------------------
# KV-pool rewind
# ---------------------------------------------------------------------------

def _force(eng, seq, toks):
    """Teacher-forced wave decode: consume ``seq.cur``, record the
    logits, emit the forced token. Returns the logits per step."""
    outs = []
    for tok in toks:
        logits, _ = eng.dispatch_wave([seq])[0]
        outs.append(logits.float().numpy())
        eng._emit(seq, torch.full((seq.cur.shape[0],), tok,
                                  dtype=torch.int32))
    return outs


def test_kvpool_rewind_replay_matches_fresh_decode(tiny_ralm):
    """Rewind is bookkeeping only for linear caches: after rewinding a
    3-step speculation and replaying a DIFFERENT continuation, the
    logits equal a fresh sequence's that decoded that continuation."""
    t = tiny_ralm
    eng = RalmEngine.monolithic(t["tparams"], t["tcfg"],
                                RagConfig(mode="none"))
    prompt = torch.from_numpy(t["corpus"][0:2, :4])
    seq = eng.start(RalmRequest(prompt=prompt, steps=8))
    _force(eng, seq, [7, 11, 13, 17])       # step 0 + speculated 1..3
    assert seq.step == 4
    eng.pool.rewind(seq.slots, keep_len=seq.t0 + 1, old_len=seq.t0 + 3)
    seq.step = 2                             # back to after token 7
    seq.cur = torch.full((2, 1), 21, dtype=torch.int32)
    replayed = _force(eng, seq, [23, 29])

    fresh = eng.start(RalmRequest(prompt=prompt, steps=8))
    ref = _force(eng, fresh, [7, 21, 23, 29])
    np.testing.assert_array_equal(replayed[0], ref[2])
    np.testing.assert_array_equal(replayed[1], ref[3])
    ps = eng.pool.stats
    assert ps.rewinds == 1 and ps.rewound_tokens == 2 * 2


def test_kvpool_rewind_rejections(tiny_ralm):
    t = tiny_ralm
    eng = RalmEngine.monolithic(t["tparams"], t["tcfg"],
                                RagConfig(mode="none"))
    seq = eng.start(RalmRequest(
        prompt=torch.from_numpy(t["corpus"][0:2, :4]), steps=4))
    pool = eng.pool
    with pytest.raises(ValueError, match="keep_len"):
        pool.rewind(seq.slots, keep_len=0, old_len=4)
    with pytest.raises(ValueError, match="keep_len"):
        pool.rewind(seq.slots, keep_len=6, old_len=4)
    with pytest.raises(ValueError, match="keep_len"):
        pool.rewind(seq.slots, keep_len=4, old_len=pool.max_seq + 1)
    # recurrent state cannot be rewound at all
    pool.cfg = dataclasses.replace(t["tcfg"], ssm_state=16)
    with pytest.raises(ValueError, match="recurrent"):
        pool.rewind(seq.slots, keep_len=4, old_len=5)
    # ring caches alias mod the window: depth 1 ok, deeper rejected
    pool.cfg = dataclasses.replace(t["tcfg"], window=4,
                                   layer_pattern=("local",))
    pool.rewind(seq.slots, keep_len=4, old_len=5)
    with pytest.raises(ValueError, match="window"):
        pool.rewind(seq.slots, keep_len=4, old_len=6)
    assert pool.stats.rewinds == 1 and pool.stats.rewound_tokens == 2


# ---------------------------------------------------------------------------
# settling points: flush_speculation, spec_finalize, release
# ---------------------------------------------------------------------------

def test_flush_and_finalize_leave_no_points(tiny_ralm):
    """Mid-run, ``flush_speculation`` force-verifies every outstanding
    point; ``spec_finalize`` does it for one sequence; ``release``
    discards what is left. Tokens still equal the run without
    speculation, and no handle stays in the in-flight table."""
    t = tiny_ralm
    prompts = _prompts(t["corpus"])
    base = _run(_build(t, 0), prompts, steps=8)
    eng = _build(t, 2)
    rids = [eng.submit(RalmRequest(prompt=torch.from_numpy(p), steps=8))
            for p in prompts]
    done = []
    for _ in range(3):
        done += eng.step()
    active = eng.scheduler.active
    assert any(s.spec_points for s in active)
    eng.flush_speculation()
    assert not any(s.spec_points for s in active)
    done += eng.step()
    seq = next(s for s in active if s.spec_points)
    eng.spec_finalize(seq)
    assert not seq.spec_points
    done += eng.run()
    by_id = {r.request_id: r.tokens for r in done}
    _assert_same([by_id[r] for r in rids], base)
    assert eng.retriever.service.num_inflight == 0

    # release discards (and cancels) whatever is outstanding
    eng.submit(RalmRequest(prompt=torch.from_numpy(prompts[0]), steps=8))
    for _ in range(3):
        eng.step()
    (seq,) = eng.scheduler.active
    n_points = len(seq.spec_points)
    assert n_points > 0
    discarded = eng.spec_stats.spec_discarded
    eng.release(seq)
    assert not seq.spec_points and seq.slots is None
    assert eng.spec_stats.spec_discarded == discarded + n_points
    assert eng.retriever.service.num_inflight == 0


# ---------------------------------------------------------------------------
# stats plane
# ---------------------------------------------------------------------------

def test_spec_stats_snapshot_and_rates():
    stats = RetrievalStats()
    snap = stats.snapshot()
    jsnap = JaxStats().snapshot()
    assert set(snap["speculation"]) == set(jsnap["speculation"])
    for key in ("spec_wait", "spec_replay"):
        assert set(snap["speculation"][key]) <= set(jsnap["speculation"][key])
    assert set(snap) <= set(jsnap)
    assert snap["cache_stale"] == 0 and snap["fault"]["spec_flushed"] == 0
    stats.spec_verified = 4
    stats.spec_accepted = 3
    stats.spec_rollbacks = 1
    assert stats.spec_acceptance_rate() == pytest.approx(0.75)
    assert stats.spec_rollback_rate() == pytest.approx(0.25)
    stats.spec_wait.add(2e-6)
    stats.spec_wait.add(4e-6)
    s = stats.snapshot()["speculation"]["spec_wait"]
    assert s["count"] == 2 and s["mean_us"] == pytest.approx(3.0)
    assert s["max_us"] == pytest.approx(4.0)


# ---------------------------------------------------------------------------
# a search flush that raises, seen from the engine
# ---------------------------------------------------------------------------

class ScanFailure(RuntimeError):
    pass


def _boom(*args, **kwargs):
    raise ScanFailure("scan failed")


def _failing_wave(eng):
    """One scheduler wave, phase by phase, whose search flush raises."""
    active = eng.scheduler.active
    decoded = eng.dispatch_wave(active)
    if eng.speculate_k > 0:
        eng.spec_harvest(active, decoded)
    searches = eng.dispatch_search_wave(active, decoded)
    pipeline = eng.retriever.service.pipeline
    pipeline.scan = _boom
    with pytest.raises(ScanFailure):
        eng.flush_searches()
    del pipeline.scan
    eng.finish_wave(active, decoded, searches)
    return active[0], decoded[0][0]


@pytest.mark.parametrize("spec_k", [0, 1])
def test_failed_flush_serves_the_bare_lm(tiny_ralm, spec_k):
    """The due row of a wave whose flush raised is served the sentinel:
    without speculation it emits the bare LM's greedy token; with it, the
    point settles against the sentinel (counted, never a seed). Either
    way ``partial_steps`` counts the step, and tokens, counters and
    ``partial_steps`` equal the JAX engine's under the same failure."""
    t = tiny_ralm
    runs = []
    for jax_engine in (False, True):
        eng = _build(t, spec_k, jax_engine=jax_engine)
        conv = jnp.asarray if jax_engine else torch.from_numpy
        req = JaxRequest if jax_engine else RalmRequest
        eng.submit(req(prompt=conv(t["corpus"][0:2, :4]), steps=6))
        eng.step()
        eng.step()
        seq, logits = _failing_wave(eng)
        if spec_k == 0:
            if not jax_engine:
                logits = logits.float()
            bare = np.argmax(np.asarray(logits, np.float32), axis=-1)
            np.testing.assert_array_equal(np.asarray(seq.cur)[:, 0], bare)
        (resp,) = eng.run()
        stats = eng.spec_stats
        runs.append((np.asarray(resp.tokens), resp.partial_steps,
                     _counters(eng), stats.ft_spec_flushed))
    (tok, partial, counters, flushed), jax_run = runs
    np.testing.assert_array_equal(tok, jax_run[0])
    assert (partial, counters, flushed) == jax_run[1:]
    assert partial == 1 and flushed == (1 if spec_k else 0)
