"""The port's query-result cache and the service's cache and failure
paths, against the JAX package.

The ``QueryCache`` cases of ``tests/test_retrieval.py`` and
``tests/test_speculation.py`` run on both caches, and a seeded random
operation sequence must give equal outputs and counters on the two.
The service cases run on a reference-trained index converted leaf for
leaf: a cache hit skips the kernel, a half-hit batch sends only its
missed rows to the scan and stitches them back in submit order (ids
equal to a cacheless service's and the JAX service's, distances within
1e-5 relative), ``stale_lookup`` serves any generation, ``cancel``
retires an entry, and a flush whose scan raises completes its handles
with the missing-neighbour sentinel, flagged partial, and re-raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ivfpq as jivf
from repro.core.chamvs import ChamVSConfig as JaxChamVSConfig
from repro.retrieval import QueryCache as JaxQueryCache
from repro.retrieval import RetrievalService as JaxService
from repro.retrieval import ServiceConfig as JaxServiceConfig
from repro_torch import convert
from repro_torch.core.chamvs import ChamVSConfig
from repro_torch.retrieval import QueryCache, RetrievalService, ServiceConfig

CACHES = pytest.mark.parametrize("cache_cls", [QueryCache, JaxQueryCache],
                                 ids=["torch", "jax"])


def _rows(*vals, d=4):
    return np.stack([np.full((d,), v, np.float32) for v in vals])


def _cache_rows(n, dim=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# QueryCache: the reference's cases, on both caches
# ---------------------------------------------------------------------------

@CACHES
def test_cache_hit_miss_counters(cache_cls):
    c = cache_cls(capacity=8)
    q = _rows(1.0, 2.0)
    assert c.get_batch(q) is None and c.misses == 2 and c.hits == 0
    c.put_batch(q, np.zeros((2, 3)), np.ones((2, 3), np.int32))
    got = c.get_batch(q)
    assert got is not None and c.hits == 2
    assert got[0].shape == (2, 3) and (got[1] == 1).all()


@CACHES
def test_cache_batch_lookup_is_all_or_nothing(cache_cls):
    c = cache_cls(capacity=8)
    c.put_batch(_rows(1.0), np.zeros((1, 3)), np.zeros((1, 3), np.int32))
    assert c.get_batch(_rows(1.0, 9.0)) is None
    assert c.misses == 2 and c.hits == 0


@CACHES
def test_cache_eviction_is_lru_order(cache_cls):
    c = cache_cls(capacity=2)

    def mk(v):
        return _rows(v), np.full((1, 2), v), np.full((1, 2), int(v))

    for v in (1.0, 2.0):
        c.put_batch(*mk(v))
    assert c.get_batch(_rows(1.0)) is not None   # refresh 1 -> LRU is 2
    c.put_batch(*mk(3.0))                        # evicts 2, not 1
    assert len(c) == 2
    assert c.contains(_rows(1.0)[0]) and c.contains(_rows(3.0)[0])
    assert not c.contains(_rows(2.0)[0])
    c2 = cache_cls(capacity=2)                   # untouched: FIFO
    for v in (1.0, 2.0, 3.0):
        c2.put_batch(*mk(v))
    assert not c2.contains(_rows(1.0)[0])
    assert c2.contains(_rows(2.0)[0]) and c2.contains(_rows(3.0)[0])


@CACHES
def test_cache_quantization_radius(cache_cls):
    c = cache_cls(capacity=4, quant=1e-2)
    c.put_batch(_rows(1.0), np.zeros((1, 2)), np.zeros((1, 2), np.int32))
    assert c.get_batch(_rows(1.001)) is not None    # same grid cell
    assert c.get_batch(_rows(1.4)) is None          # different cell


@CACHES
def test_query_cache_partial_hits(cache_cls):
    cache = cache_cls(capacity=8, partial=True)
    q = _cache_rows(4)
    assert cache.get_batch(q) is None
    cache.put_batch(q[:2], np.ones((2, 3)), np.arange(6).reshape(2, 3))
    dists, ids, hit = cache.get_batch(q)
    assert hit.tolist() == [True, True, False, False]
    assert (ids[~hit] == -1).all() and (dists[~hit] == 0).all()
    assert (ids[0] == [0, 1, 2]).all()
    assert cache.hits == 2 and cache.misses == 6


@CACHES
def test_query_cache_legacy_all_or_nothing(cache_cls):
    cache = cache_cls(capacity=8)
    q = _cache_rows(3)
    cache.put_batch(q[:2], np.zeros((2, 3)), np.zeros((2, 3), np.int32))
    assert cache.get_batch(q) is None
    assert cache.misses == 3 and cache.hits == 0
    out = cache.get_batch(q[:2])
    assert out is not None and cache.hits == 2


@CACHES
def test_query_cache_generations_and_stale_serving(cache_cls):
    cache = cache_cls(capacity=8, partial=True)
    q = _cache_rows(2)
    cache.put_batch(q, np.ones((2, 3)), np.zeros((2, 3), np.int32))
    cache.mark_stale()
    assert cache.get_batch(q) is None
    assert cache.stale == 2 and cache.misses == 2
    assert cache.contains(q[0], any_generation=True)
    assert not cache.contains(q[0])
    stale = cache.get_stale(q)
    assert stale is not None and cache.stale_served == 2
    assert cache.get_stale(_cache_rows(2, seed=9)) is None
    cache.put_batch(q, np.ones((2, 3)), np.zeros((2, 3), np.int32))
    assert cache.get_batch(q) is not None


@pytest.mark.parametrize("partial", [False, True])
def test_query_cache_same_operations_same_answers(partial):
    """A seeded random sequence of puts, fresh and stale lookups and
    generation bumps over a small key pool: the two caches give equal
    outputs and equal counters after every operation."""
    rng = np.random.default_rng(11)
    pool = _cache_rows(12, dim=6, seed=3)
    caches = [QueryCache(5, partial=partial),
              JaxQueryCache(5, partial=partial)]
    for _ in range(200):
        op = rng.integers(0, 4)
        q = pool[rng.choice(12, size=rng.integers(1, 5), replace=False)]
        if op == 0:
            d = rng.normal(size=(len(q), 3)).astype(np.float32)
            i = rng.integers(0, 99, size=(len(q), 3)).astype(np.int32)
            outs = [c.put_batch(q, d, i) for c in caches]
        elif op == 1:
            outs = [c.get_batch(q) for c in caches]
        elif op == 2:
            outs = [c.get_stale(q) for c in caches]
        else:
            outs = [c.mark_stale() for c in caches]
        a, b = outs
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        for name in ("hits", "misses", "stale", "stale_served",
                     "generation"):
            assert getattr(caches[0], name) == getattr(caches[1], name)
        assert len(caches[0]) == len(caches[1])
        assert [caches[0].contains(r) for r in pool] == \
            [caches[1].contains(r) for r in pool]


# ---------------------------------------------------------------------------
# the service's cache path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(2048, 32)).astype(np.float32)
    cfg = jivf.IVFPQConfig(dim=32, nlist=16, m=8, list_cap=256)
    params = jivf.train_ivfpq(jax.random.PRNGKey(0), jnp.asarray(vecs[:1024]),
                              cfg, kmeans_iters=4)
    shards = jivf.build_shards(params, vecs, cfg, num_shards=2)
    tparams = convert.ivfpq_params(np.array(params.coarse_centroids),
                                   np.array(params.codebooks))
    tshards = convert.ivfpq_shards(
        [(np.array(s.codes), np.array(s.ids), np.array(s.list_len))
         for s in shards])
    tcfg = ChamVSConfig(ivfpq=convert.index_config(dataclasses.asdict(cfg)),
                        nprobe=8, k=10)
    jcfg = JaxChamVSConfig(ivfpq=cfg, nprobe=8, k=10, backend="ref")
    queries = rng.normal(size=(8, 32)).astype(np.float32)
    return dict(params=params, shards=shards, jcfg=jcfg, tparams=tparams,
                tshards=tshards, tcfg=tcfg, queries=queries)


def _service(ix, **kw):
    return RetrievalService.local(ix["tparams"], ix["tshards"], ix["tcfg"],
                                  ServiceConfig(measure=False, **kw))


def test_service_cache_hit_skips_kernel(small_index):
    """A cached query batch completes at submit with NO new dispatch and
    identical results, in the kernels' dtypes."""
    q = torch.from_numpy(small_index["queries"][:3])
    svc = _service(small_index, cache_entries=64)
    d0, i0 = svc.search(q)
    assert svc.stats.num_batches == 1 and svc.stats.cache_misses == 3
    h = svc.submit(q)
    assert h.done() and h.is_ready()
    d1, i1 = h.result()
    assert svc.stats.num_batches == 1 and svc.stats.scan_dispatches == 1
    assert svc.stats.cache_hits == 3
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    assert d1.dtype == torch.float32 and i1.dtype == torch.int32
    assert svc.num_inflight == 0


@pytest.mark.parametrize("cache_partial", [True, False])
def test_service_partial_batch_stitch(small_index, cache_partial):
    """A batch whose even rows hit the cache sends ONLY the odd rows to
    the scan (per-row mode); the stitched batch equals the cacheless
    service's and the JAX cached service's. All-or-nothing mode scans
    the whole batch."""
    ix = small_index
    rng = np.random.default_rng(3)
    qa = rng.normal(size=(4, 32)).astype(np.float32)
    new = rng.normal(size=(2, 32)).astype(np.float32)
    qb = np.stack([qa[0], new[0], qa[2], new[1]])

    svc = _service(ix, cache_entries=32, cache_partial=cache_partial)
    assert svc.cache.partial == cache_partial
    svc.search(torch.from_numpy(qa))
    rows0, disp0 = svc.stats.batched_rows, svc.stats.scan_dispatches
    h = svc.submit(torch.from_numpy(qb))
    assert not h.done() and svc.num_pending_rows == (2 if cache_partial
                                                     else 4)
    svc.flush()
    dists, ids = h.result()
    assert svc.stats.scan_dispatches == disp0 + 1
    assert svc.stats.batched_rows - rows0 == (2 if cache_partial else 4)
    assert svc.stats.cache_hits == (2 if cache_partial else 0)

    bd, bi = _service(ix).search(torch.from_numpy(qb))
    assert torch.equal(ids, bi) and torch.equal(dists, bd)
    jsvc = JaxService.local(ix["params"], ix["shards"], ix["jcfg"],
                            JaxServiceConfig(cache_entries=32, measure=False,
                                             cache_partial=cache_partial))
    jsvc.search(jnp.asarray(qa))
    jd, ji = jsvc.search(jnp.asarray(qb))
    assert jsvc.stats.cache_hits == svc.stats.cache_hits
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_allclose(dists.numpy(), np.asarray(jd), rtol=1e-5)


def test_service_stale_lookup(small_index):
    q = torch.from_numpy(small_index["queries"][:2])
    svc = _service(small_index, cache_entries=32)
    assert svc.stale_lookup(q) is None             # cold
    _, i0 = svc.search(q)
    svc.mark_cache_stale()
    hits0 = svc.stats.cache_hits
    got = svc.stale_lookup(q)                      # serves any generation
    assert got is not None and torch.equal(got[1], i0)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert svc.stats.cache_hits == hits0           # not a demand hit
    h = svc.submit(q)                              # the fresh lookup misses
    assert not h.done() and svc.stats.cache_stale == 2
    h.result()
    assert _service(small_index).stale_lookup(q) is None   # no cache


def test_cancel_retires_the_entry(small_index):
    """A cancelled handle leaves the in-flight table at once; its pending
    rows are still computed and thrown away at the next flush."""
    q = torch.from_numpy(small_index["queries"])
    svc = _service(small_index)
    h1, h2 = svc.submit(q[:3]), svc.submit(q[3:])
    assert svc.num_inflight == 2 and h1.ticket != h2.ticket
    h1.cancel()
    assert svc.num_inflight == 1
    svc.flush()
    assert svc.stats.batched_rows == 8
    d, i = h2.result()
    assert svc.num_inflight == 0 and i.shape == (5, 10)


# ---------------------------------------------------------------------------
# a flush that raises
# ---------------------------------------------------------------------------

class ScanFailure(RuntimeError):
    pass


def _boom(*args, **kwargs):
    raise ScanFailure("scan failed")


def test_failed_flush_completes_handles_with_sentinel(small_index):
    """The scan raises: ``flush`` re-raises, every pending handle is done
    with (+inf, -1) in the kernels' dtypes and flagged partial, and the
    in-flight table drains, as the JAX service does under the same
    raising scan. The next flush runs normally."""
    ix = small_index
    q = ix["queries"]
    svc = _service(ix, cache_entries=16)
    svc.search(torch.from_numpy(q[:1]))            # row 0 now cached
    svc.pipeline.scan = _boom
    handles = [svc.submit(torch.from_numpy(q[:3])),
               svc.submit(torch.from_numpy(q[3:]))]
    with pytest.raises(ScanFailure):
        svc.flush()
    jsvc = JaxService.local(ix["params"], ix["shards"], ix["jcfg"],
                            JaxServiceConfig(measure=False))
    jsvc.pipeline.scan = _boom
    jhandles = [jsvc.submit(jnp.asarray(q[:3])), jsvc.submit(jnp.asarray(q[3:]))]
    with pytest.raises(ScanFailure):
        jsvc.flush()
    for h, jh in zip(handles, jhandles):
        assert h.done() and h.partial and h.live_fraction == 0.0
        assert jh.partial
        d, i = h.result()
        assert d.dtype == torch.float32 and i.dtype == torch.int32
        assert torch.isinf(d).all() and (d > 0).all() and (i == -1).all()
        jd, ji = jh.result()
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert svc.num_inflight == 0 and jsvc.num_inflight == 0
    assert svc.num_pending_rows == 0
    del svc.pipeline.scan                          # the real scan again
    d, i = svc.search(torch.from_numpy(q[5:]))
    assert torch.isfinite(d).all() and (i >= 0).all()
