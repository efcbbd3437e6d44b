"""The port's retrieval path against the JAX package, on a reference-built
index (residual and non-residual, 2 shards).

Probe ids, scan ids and merged ids must be identical; distances agree
within 1e-5 relative (the two packages sum in different orders). The
build side is held to the reference with the reference's trained
quantizers (or initial centroids) injected, since ``jax.random`` and
``torch.Generator`` draw different numbers from the same seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ivfpq as jivf
from repro.core import kmeans as jkm
from repro.core.chamvs import ChamVSConfig as JaxChamVSConfig
from repro.kernels.chamvs_scan.kernel import fused_scan as jax_fused_scan
from repro.kernels.chamvs_scan.ref import ref_chamvs_scan as jax_ref_scan
from repro.retrieval import merge as jmerge
from repro.retrieval.service import RetrievalService as JaxService
from repro_torch import convert
from repro_torch.core import ivfpq as tivf
from repro_torch.core import kmeans as tkm
from repro_torch.core.chamvs import ChamVSConfig, shard_search, stack_shards
from repro_torch.kernels.chamvs_scan import ops as tcs
from repro_torch.kernels.ivf_scan import ops as tiv
from repro_torch.retrieval import merge as tmerge
from repro_torch.retrieval.service import RetrievalService, ServiceConfig

REL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.array(x)


@pytest.fixture(scope="module", params=[False, True], ids=["flat", "resid"])
def index(request):
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(2048, 32)).astype(np.float32)
    cfg = jivf.IVFPQConfig(dim=32, nlist=16, m=8, list_cap=160,
                           residual=request.param)
    params = jivf.train_ivfpq(jax.random.PRNGKey(0), jnp.asarray(vecs), cfg,
                              kmeans_iters=5)
    shards = jivf.build_shards(params, vecs, cfg, num_shards=2)
    tparams = convert.ivfpq_params(_np(params.coarse_centroids),
                                   _np(params.codebooks))
    tshards = convert.ivfpq_shards(
        [(_np(s.codes), _np(s.ids), _np(s.list_len)) for s in shards])
    tcfg = convert.index_config(dataclasses.asdict(cfg))
    queries = (vecs[:12] + 0.05 * rng.normal(size=(12, 32))).astype(
        np.float32)
    return dict(vecs=vecs, cfg=cfg, params=params, shards=shards,
                tparams=tparams, tshards=tshards, tcfg=tcfg, queries=queries)


def test_probe_ids_and_luts(index):
    q = index["queries"]
    jd, ji = jivf.scan_ivf_index(index["params"], jnp.asarray(q), 4)
    td, ti = tiv.ivf_index_scan(torch.from_numpy(q),
                                index["tparams"].coarse_centroids, 4)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_allclose(td.numpy(), _np(jd), **REL)
    td2, ti2 = tivf.scan_ivf_index(index["tparams"], torch.from_numpy(q), 4)
    assert torch.equal(ti2, ti) and torch.equal(td2, td)
    jl = jivf.compute_luts(index["params"], jnp.asarray(q), ji, index["cfg"])
    tl = tivf.compute_luts(index["tparams"], torch.from_numpy(q), ti,
                           index["tcfg"])
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=1e-5, atol=1e-5)


def test_fused_scan_against_pallas_and_ref(index):
    """The plain fused scan (stacked tables + probe ids) equals the
    reference's Pallas kernel (interpret mode) and its vmapped ref."""
    q = index["queries"]
    _, ji = jivf.scan_ivf_index(index["params"], jnp.asarray(q), 4)
    jl = jivf.compute_luts(index["params"], jnp.asarray(q), ji, index["cfg"])
    st = [index["shards"][i] for i in range(2)]
    codes = jnp.stack([s.codes for s in st])[:, ji]
    gids = jnp.stack([s.ids for s in st])[:, ji]
    lens = jnp.stack([s.list_len for s in st])[:, ji]
    kk = JaxChamVSConfig(ivfpq=index["cfg"], k=10).k_prime(2)
    pd, pi = jax_fused_scan(jl, codes, gids, lens, kk, tile_q=4,
                            interpret=True)
    rd, ri = jax_ref_scan(jl, codes, gids, lens, kk)
    tst = stack_shards(index["tshards"])
    tl = tivf.compute_luts(index["tparams"], torch.from_numpy(q),
                           torch.from_numpy(_np(ji)), index["tcfg"])
    td, ti = tcs.fused_scan(tl, tst.codes, tst.ids, tst.list_len,
                            torch.from_numpy(_np(ji)), kk)
    for d, i in ((pd, pi), (rd, ri)):
        np.testing.assert_array_equal(ti.numpy(), _np(i))
        np.testing.assert_allclose(td.numpy(), _np(d), **REL)
    # the staged per-shard oracle agrees too
    for s in range(2):
        sd, si = shard_search(index["tparams"], index["tshards"][s],
                              torch.from_numpy(q), torch.from_numpy(_np(ji)),
                              ChamVSConfig(ivfpq=index["tcfg"], k=10), kk)
        assert torch.equal(si, ti[s]) and torch.equal(sd, td[s])


@pytest.mark.parametrize("kk", [5, 40])
def test_fused_scan_exact_ties(kk):
    """Duplicate code rows give exactly equal distances; the queue keeps
    them in arrival order (probe by probe, row by row), as the
    reference's lower-index-first argmin does."""
    rng = np.random.default_rng(3)
    S, nq, nprobe, nlist, cap, m, ksub = 2, 4, 3, 6, 16, 4, 16
    codes = rng.integers(0, ksub, size=(S, nlist, cap, m)).astype(np.uint8)
    codes[:, :, 8:] = codes[:, :, :8]                # rows r and r+8 tie
    codes[:, 1] = codes[:, 0]                        # lists 0 and 1 tie
    ids = np.arange(S * nlist * cap, dtype=np.int32).reshape(S, nlist, cap)
    lens = np.full((S, nlist), cap, np.int32)
    lens[1, 2] = 5
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(nq)]
                     ).astype(np.int32)
    probe[0, :2] = [0, 1]
    luts = rng.integers(0, 4, size=(nq, nprobe, m, ksub)).astype(np.float32)
    g = lambda a: jnp.asarray(a)[:, jnp.asarray(probe)]   # noqa: E731
    pd, pi = jax_fused_scan(jnp.asarray(luts), g(codes), g(ids), g(lens),
                            kk, tile_q=2, interpret=True)
    td, ti = tcs.fused_scan(torch.from_numpy(luts), torch.from_numpy(codes),
                            torch.from_numpy(ids), torch.from_numpy(lens),
                            torch.from_numpy(probe), kk)
    np.testing.assert_array_equal(ti.numpy(), _np(pi))
    np.testing.assert_array_equal(td.numpy(), _np(pd))
    d = td.numpy()
    assert ((d[..., 1:] == d[..., :-1]) & np.isfinite(d[..., 1:])).any()


def test_merges_give_exact_ids():
    rng = np.random.default_rng(4)
    S, nq, c, k = 5, 6, 7, 12
    d = np.sort(rng.integers(0, 20, size=(S, nq, c)).astype(np.float32), -1)
    i = rng.permutation(S * nq * c).astype(np.int32).reshape(S, nq, c)
    d[:, :, -1], i[:, :, -1] = np.inf, -1                 # padding
    jd, ji = jmerge.flat_merge(jnp.asarray(d), jnp.asarray(i), k)
    td, ti = tmerge.flat_merge(torch.from_numpy(d), torch.from_numpy(i), k)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    for fanout in (2, 3):
        jd, ji = jmerge.hierarchical_merge(jnp.asarray(d), jnp.asarray(i),
                                           k, fanout=fanout)
        td, ti = tmerge.hierarchical_merge(torch.from_numpy(d),
                                           torch.from_numpy(i), k,
                                           fanout=fanout)
        np.testing.assert_array_equal(ti.numpy(), _np(ji))
        np.testing.assert_array_equal(td.numpy(), _np(jd))
    jd, ji = jmerge.flat_merge(jnp.asarray(d), jnp.asarray(i), 64)
    td, ti = tmerge.flat_merge(torch.from_numpy(d), torch.from_numpy(i), 64)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))        # pads to K


def test_service_search_exact_ids(index):
    q = index["queries"]
    jcfg = JaxChamVSConfig(ivfpq=index["cfg"], nprobe=4, k=10)
    jd, ji = JaxService.local(index["params"], index["shards"], jcfg
                              ).search(jnp.asarray(q))
    tcfg = ChamVSConfig(ivfpq=index["tcfg"], nprobe=4, k=10)
    svc = RetrievalService.local(index["tparams"], index["tshards"], tcfg,
                                 ServiceConfig(max_batch=8))
    h1 = svc.submit(torch.from_numpy(q[:5]))
    h2 = svc.submit(torch.from_numpy(q[5:]))      # 12 rows: max_batch flush
    assert h1.done() and h2.done() and svc.stats.num_batches == 1
    td = torch.cat([h1.result()[0], h2.result()[0]])
    ti = torch.cat([h1._entry.result_i, h2._entry.result_i])
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_allclose(td.numpy(), _np(jd), **REL)
    assert svc.stats.scan_dispatches == 1 and svc.num_inflight == 0
    staged = RetrievalService.local(
        index["tparams"], index["tshards"],
        dataclasses.replace(tcfg, fused=False)).search(torch.from_numpy(q))
    assert torch.equal(staged[1], ti)


def test_encode_and_build_shards_identical(index):
    """With the reference's trained quantizers injected, the port encodes
    and lays out the shards exactly as the reference does."""
    vecs = index["vecs"]
    jc, ja = jivf.encode(index["params"], jnp.asarray(vecs), index["cfg"])
    tc, ta = tivf.encode(index["tparams"], torch.from_numpy(vecs),
                         index["tcfg"])
    np.testing.assert_array_equal(ta.numpy(), _np(ja))
    np.testing.assert_array_equal(tc.numpy(), _np(jc))
    shards = tivf.build_shards(index["tparams"], torch.from_numpy(vecs),
                               index["tcfg"], num_shards=2, encode_batch=500)
    for j, t in zip(index["shards"], shards):
        np.testing.assert_array_equal(t.codes.numpy(), _np(j.codes))
        np.testing.assert_array_equal(t.ids.numpy(), _np(j.ids))
        np.testing.assert_array_equal(t.list_len.numpy(), _np(j.list_len))


def test_kmeans_with_injected_init_matches_reference():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(loc=c, size=(200, 8)) for c in
                        rng.normal(scale=4, size=(6, 8))]).astype(np.float32)
    key = jax.random.PRNGKey(3)
    init = jkm._init_centroids(key, jnp.asarray(x), 10)
    jc, ja = jkm.kmeans(key, jnp.asarray(x), 10, iters=6)
    tc, ta = tkm.kmeans(torch.from_numpy(x), 10, iters=6,
                        init=torch.from_numpy(_np(init)), chunk=300)
    np.testing.assert_allclose(tc.numpy(), _np(jc), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ta.numpy(), _np(ja))
