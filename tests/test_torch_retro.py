"""RETRO serving in the port against the JAX engine, end to end on the CPU.

The recipe: the reduced EncDec-S (vocab 64), a datastore keyed by the
decoder's own hidden states over a deterministic-bigram corpus, whose
chunk table row i holds the 4 tokens after key i's position in its
document (PAD 0 past its end); ``RagConfig(mode="retro", interval=4,
k=2, chunk_len=4)``. At the seeded init the cross-attention is too weak
to move a greedy token, so ``xwv`` and ``xwo`` are scaled by 40 in the
shared params: retrieval then changes tokens (checked against a
``mode="none"`` run), and token parity means the retrieved chunks were
the same.

Greedy tokens and per-step retrieval ids must equal the JAX engine's
under wave decode with synchronous and asynchronous retrieval, with the
staged scan, and on the per-sequence loop; the pooled encoder rows agree
within bf16 rounding. Reduced Dec-L's kNN-LM engine is held to the JAX
engine's tokens too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import rag as jrag
from repro.models import transformer as jtf
from repro.serve import DatastoreBuilder as JaxBuilder
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import RagConfig as JaxRagConfig
from repro.serve import RalmEngine as JaxEngine
from repro.serve import RalmRequest as JaxRequest
from repro.serve.kvpool import KVCachePool as JaxPool
from repro_torch import convert
from repro_torch.core import rag as trag
from repro_torch.serve import (EngineConfig, KVCachePool, RagConfig,
                               RalmEngine, RalmRequest)

XSCALE = 40.0          # xwv and xwo: enough for retrieval to move tokens
CHUNK = 4


def _corpus():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 64, size=(64,))]
    for _ in range(31):
        seqs.append((3 * seqs[-1] + 1) % 64)
    return np.stack(seqs, axis=1).astype(np.int32)         # [64 docs, 32]


def chunk_table(corpus, chunk_len):
    """Row i = the ``chunk_len`` tokens after key i's position (key i is
    document i // (L-1), position i % (L-1)), PAD 0 past the end."""
    n, L = corpus.shape
    padded = np.concatenate(
        [corpus, np.zeros((n, chunk_len), np.int32)], axis=1)
    idx = np.arange(L - 1)[:, None] + 1 + np.arange(chunk_len)[None, :]
    return padded[:, idx].reshape(n * (L - 1), chunk_len)


def _convert_ds(ds):
    return convert.datastore(
        dataclasses.asdict(ds.index_cfg), np.array(ds.params.coarse_centroids),
        np.array(ds.params.codebooks),
        [(np.array(s.codes), np.array(s.ids), np.array(s.list_len))
         for s in ds.shards],
        payload_tokens=np.array(ds.payload_tokens),
        chunk_table=None if ds.chunk_table is None
        else np.array(ds.chunk_table),
        num_vectors=ds.num_vectors)


def _convert_params(params, tcfg):
    return convert.lm_params(
        jax.tree.map(lambda x: np.array(x.astype(jnp.float32)), params),
        tcfg)


@pytest.fixture(scope="module")
def retro():
    cfg = dataclasses.replace(get_arch("encdec_s").reduced, vocab_size=64)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    g = params["classes"]["global"]
    g["xwv"] = (g["xwv"].astype(jnp.float32) * XSCALE).astype(g["xwv"].dtype)
    g["xwo"] = (g["xwo"].astype(jnp.float32) * XSCALE).astype(g["xwo"].dtype)
    corpus = _corpus()
    builder = JaxBuilder(dim=cfg.d_model, nlist=8, m=8, list_cap=512)
    keys, nxt = builder.corpus_keys(params, cfg, corpus)
    ds = builder.build(keys, payload_tokens=nxt,
                       chunk_table=chunk_table(corpus, CHUNK))
    rag = JaxRagConfig(mode="retro", interval=4, k=2, chunk_len=CHUNK)
    tcfg = convert.model_config(dataclasses.asdict(cfg))
    return dict(cfg=cfg, params=params, corpus=corpus, ds=ds, rag=rag,
                tcfg=tcfg, tparams=_convert_params(params, tcfg),
                tds=_convert_ds(ds), trag=RagConfig(**dataclasses.asdict(rag)))


def _prompts(corpus):
    return [corpus[:2, :8], corpus[2:5, :6]]


def _run(engine, request_cls, conv, corpus, steps=(10, 9)):
    traces = [[], []]
    rids = [engine.submit(request_cls(prompt=conv(p), steps=s, trace=tr))
            for p, s, tr in zip(_prompts(corpus), steps, traces)]
    by_id = {r.request_id: np.asarray(r.tokens) for r in engine.run()}
    return [by_id[r] for r in rids], traces


def _engines(t, **kw):
    fused = kw.pop("fused", True)
    jr, tr = kw.pop("jrag", t["rag"]), kw.pop("trag", t["trag"])
    jeng = JaxEngine.from_config(
        JaxEngineConfig(model=t["cfg"], rag=jr, kernel_fused=fused, **kw),
        t["params"], t["ds"], t["ds"].search_config(nprobe=4, k=2))
    teng = RalmEngine.from_config(
        EngineConfig(model=t["tcfg"], rag=tr, **kw),
        t["tparams"], t["tds"],
        t["tds"].search_config(nprobe=4, k=2, fused=fused), device="cpu")
    return jeng, teng


def _same_traces(jtr, ttr):
    assert len(jtr) == len(ttr)
    for ja, ta in zip(jtr, ttr):
        assert [e["step"] for e in ja] == [e["step"] for e in ta]
        for je, te in zip(ja, ta):
            np.testing.assert_array_equal(te["ids"], je["ids"])


@pytest.mark.parametrize("mode", ["wave_sync", "wave_async", "staged",
                                  "per_sequence"])
def test_retro_tokens_and_ids_match_jax_engine(retro, mode):
    t = retro
    kw = dict(wave_sync={}, wave_async=dict(async_retrieval=True),
              staged=dict(async_retrieval=True, fused=False),
              per_sequence=dict(wave_decode=False))[mode]
    jeng, teng = _engines(t, **kw)
    jout, jtr = _run(jeng, JaxRequest, jnp.asarray, t["corpus"])
    tout, ttr = _run(teng, RalmRequest, torch.from_numpy, t["corpus"])
    for j, o in zip(jout, tout):
        np.testing.assert_array_equal(o, j)
    _same_traces(jtr, ttr)
    # retrieval at steps 0, 4, 8 of both requests
    assert [e["step"] for e in ttr[0]] == [0, 4, 8]
    assert teng.decode_dispatches == jeng.decode_dispatches
    if mode != "per_sequence":
        # the last encoder rows each slot received: width k * chunk_len
        assert tuple(teng.pool.enc.shape) == (teng.pool.capacity + 1,
                                              2 * CHUNK, t["cfg"].d_model)
        je = np.array(jeng.pool.enc.astype(jnp.float32))
        te = teng.pool.enc.float().numpy()
        assert np.abs(te - je).max() <= 2 ** -6 * np.abs(je).max()


def test_retrieval_moves_tokens(retro):
    """The scaled cross-attention makes retrieval matter: the same engine
    without retrieval (``mode="none"``, and RETRO without a retriever,
    which keeps the neutral encoder rows at RETRO's width) emits other
    tokens, and the retrieved run's tokens part from it after a
    retrieval step."""
    t = retro
    _, teng = _engines(t)
    tout, _ = _run(teng, RalmRequest, torch.from_numpy, t["corpus"])
    none = RagConfig(**dict(dataclasses.asdict(t["rag"]), mode="none"))
    _, noeng = _engines(t, trag=none)
    nout, ntr = _run(noeng, RalmRequest, torch.from_numpy, t["corpus"])
    assert ntr == [[], []]
    assert noeng.pool.enc.shape[1] == 8        # the neutral floor
    bare = RalmEngine.monolithic(t["tparams"], t["tcfg"], t["trag"])
    bout, btr = _run(bare, RalmRequest, torch.from_numpy, t["corpus"])
    assert btr == [[], []] and bare.pool.enc.shape[1] == 2 * CHUNK
    for base in (nout, bout):
        differ = sum(int((a != b).sum()) for a, b in zip(tout, base))
        assert differ > 0
        # step 0's token comes from the prefill (neutral encoder states
        # in both runs): equal; the first retrieval acts from step 1 on
        for a, b, p in zip(tout, base, _prompts(t["corpus"])):
            np.testing.assert_array_equal(a[:, :p.shape[1] + 1],
                                          b[:, :p.shape[1] + 1])


def test_fixed_pool_admission_reuses_a_freed_enc_row(retro):
    """kv_slots=3: the third request waits for the first to finish and
    takes its slots, whose encoder rows hold that request's last
    retrieval; admission rewrites them with neutral rows, so its tokens
    equal its solo run's, and all tokens equal the JAX engine's."""
    t, c = retro, retro["corpus"]

    def scenario(engine, req, conv):
        ra = engine.submit(req(prompt=conv(c[:2, :8]), steps=6))
        rb = engine.submit(req(prompt=conv(c[2:3, :7]), steps=9))
        rc = engine.submit(req(prompt=conv(c[3:5, :6]), steps=7))
        done, deferred = [], False
        while engine.scheduler.has_work:
            done.extend(engine.step())
            deferred |= len(engine.scheduler.queue) > 0
        assert deferred
        by_id = {r.request_id: np.asarray(r.tokens) for r in done}
        return [by_id[r] for r in (ra, rb, rc)]

    def monolithic(eng_cls, params, cfg, rag, ds, **kw):
        return eng_cls.monolithic(
            params, cfg, rag, ds.retriever(ds.search_config(nprobe=4, k=2)),
            **kw)

    jeng = monolithic(JaxEngine, t["params"], t["cfg"], t["rag"], t["ds"],
                      kv_slots=3)
    teng = monolithic(RalmEngine, t["tparams"], t["tcfg"], t["trag"],
                      t["tds"], kv_slots=3)
    tout = scenario(teng, RalmRequest, torch.from_numpy)
    for j, o in zip(scenario(jeng, JaxRequest, jnp.asarray), tout):
        np.testing.assert_array_equal(o, j)
    assert teng.pool.stats.high_water == 3 and teng.pool.num_free == 3
    solo = monolithic(RalmEngine, t["tparams"], t["tcfg"], t["trag"],
                      t["tds"], kv_slots=3)
    np.testing.assert_array_equal(
        solo.generate(torch.from_numpy(c[3:5, :6]), steps=7), tout[2])


def test_retro_neighbor_tokens_and_chunk_resolve(retro):
    """Chunk gathers with missing ids (-1) give PAD-0 rows, in both
    packages and through both retrievers; a retriever without a chunk
    table raises as the reference's does."""
    t = retro
    ids = np.array([[3, -1], [-1, 0], [1982, 7]], np.int32)
    want = np.array(jrag.retro_neighbor_tokens(t["ds"].chunk_table,
                                               jnp.asarray(ids)))
    got = trag.retro_neighbor_tokens(t["tds"].chunk_table,
                                     torch.from_numpy(ids))
    assert tuple(got.shape) == (3, 2, CHUNK) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[ids < 0] == 0).all() and (want[ids >= 0] != 0).any()
    jret = t["ds"].retriever(t["ds"].search_config(nprobe=4, k=2))
    scfg = t["tds"].search_config(nprobe=4, k=2)
    for ret in (t["tds"].retriever(scfg), t["tds"].async_retriever(scfg)):
        np.testing.assert_array_equal(
            ret.resolve(torch.from_numpy(ids), kind="chunks").numpy(),
            np.array(jret.resolve(jnp.asarray(ids), kind="chunks")))
        np.testing.assert_array_equal(
            ret.resolve(torch.from_numpy(ids), kind="tokens").numpy(),
            np.array(jret.resolve(jnp.asarray(ids), kind="tokens")))
        with pytest.raises(ValueError, match="unknown payload kind"):
            ret.resolve(torch.from_numpy(ids), kind="embeddings")
    bare = dataclasses.replace(t["tds"], chunk_table=None)
    with pytest.raises(ValueError, match="retriever has no chunk_table"):
        bare.retriever(scfg).resolve(torch.from_numpy(ids), kind="chunks")
    moved = t["tds"].to("cpu")
    assert torch.equal(moved.chunk_table, t["tds"].chunk_table)


def test_width_errors_match_reference(retro):
    """``k * chunk_len < 8`` fails wave construction, and a pooled enc
    write of another width fails, with the reference's messages."""
    t = retro
    small = dict(dataclasses.asdict(t["rag"]), k=1, chunk_len=4)
    msgs = []
    for eng_cls, params, cfg, rag_cls in (
            (JaxEngine, t["params"], t["cfg"], JaxRagConfig),
            (RalmEngine, t["tparams"], t["tcfg"], RagConfig)):
        with pytest.raises(ValueError, match="k \\* rag.chunk_len >= 8") as e:
            eng_cls.monolithic(params, cfg, rag_cls(**small))
        msgs.append(str(e.value))
        eng_cls.monolithic(params, cfg, rag_cls(**small), wave=False)
    assert msgs[0] == msgs[1]
    msgs = []
    for pool, rows in ((JaxPool(t["cfg"], 2, 16),
                        lambda s: jnp.zeros(s, jnp.bfloat16)),
                       (KVCachePool(t["tcfg"], 2, 16),
                        lambda s: torch.zeros(s, dtype=torch.bfloat16))):
        pool.write_enc(np.array([0]), rows((1, 8, 64)))
        with pytest.raises(ValueError, match="pooled enc rows") as e:
            pool.write_enc(np.array([1]), rows((1, 4, 64)))
        msgs.append(str(e.value))
        pool.grow_slots(4)
        assert tuple(pool.gather_enc(np.array([0, 4])).shape) == (2, 8, 64)
    assert msgs[0] == msgs[1]


def test_per_sequence_retro_with_small_chunks(retro):
    """``k * chunk_len < 8`` runs on the per-sequence loop (its encoder
    states change width from the neutral 8 to 4 at the first retrieval)
    and gives the JAX engine's tokens."""
    t = retro
    small = dict(dataclasses.asdict(t["rag"]), k=1, chunk_len=4)
    jeng, teng = _engines(t, wave_decode=False, jrag=JaxRagConfig(**small),
                          trag=RagConfig(**small))
    jout, jtr = _run(jeng, JaxRequest, jnp.asarray, t["corpus"])
    tout, ttr = _run(teng, RalmRequest, torch.from_numpy, t["corpus"])
    for j, o in zip(jout, tout):
        np.testing.assert_array_equal(o, j)
    _same_traces(jtr, ttr)


def test_dec_l_reduced_engine_matches_jax():
    """Reduced Dec-L, the kNN-LM recipe of ``tests/test_serve.py``
    (vocab 64, k 8, lam 0.999): greedy tokens equal the JAX engine's.
    Retrieval runs at the same steps; the ids are not compared: the
    bigram corpus repeats contexts, so neighbours tie or nearly tie, and
    queries that differ by a bf16 rounding order them differently."""
    cfg = dataclasses.replace(get_arch("dec_l").reduced, vocab_size=64)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    corpus = _corpus()
    ds = JaxBuilder(dim=cfg.d_model, nlist=8, m=8,
                    list_cap=512).from_corpus(params, cfg, corpus)
    rag = JaxRagConfig(mode="knnlm", interval=1, k=8, lam=0.999,
                       temperature=1.0)
    tcfg = convert.model_config(dataclasses.asdict(cfg))
    jeng = JaxEngine.from_config(
        JaxEngineConfig(model=cfg, rag=rag, async_retrieval=True), params,
        ds, ds.search_config(nprobe=4, k=8))
    tds = _convert_ds(ds)
    teng = RalmEngine.from_config(
        EngineConfig(model=tcfg, rag=RagConfig(**dataclasses.asdict(rag)),
                     async_retrieval=True), _convert_params(params, tcfg),
        tds, tds.search_config(nprobe=4, k=8), device="cpu")
    jout, jtr = _run(jeng, JaxRequest, jnp.asarray, corpus, steps=(8, 6))
    tout, ttr = _run(teng, RalmRequest, torch.from_numpy, corpus,
                     steps=(8, 6))
    for j, o in zip(jout, tout):
        np.testing.assert_array_equal(o, j)
    assert [[e["step"] for e in tr] for tr in ttr] == \
        [[e["step"] for e in tr] for tr in jtr] == [list(range(8)),
                                                    list(range(6))]
    # the memorised continuation of the bigram corpus
    assert (tout[0][:, 8:] == corpus[:2, 8:16]).mean() == 1.0
