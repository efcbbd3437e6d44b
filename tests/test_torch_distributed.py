"""The port's distributed retrieval against the JAX package, on the CPU.

The reference runs ``tests/test_distributed.py``'s search tests as one
``shard_map`` program over 8 fake CPU devices. The port runs each mesh
position as a memory-node process on the CPU, over gloo
(``repro_torch.retrieval.fabric``); the coordinator merges the nodes'
survivors. The index is built by the reference (``train_ivfpq`` /
``build_shards``) and converted leaf for leaf, and the answers are held
to the reference's ``search_single``: ids identical, distances within
1e-5 relative. One router (one set of node processes) serves every case
of a mesh shape: 4 x 2 over a 4-shard index (the query split, the
service, the gathers, the deprecated wrappers) and 2 x 4 over a 2-shard
index (the probe split).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import ivfpq as jivf
from repro.core.chamvs import ChamVSConfig as JaxChamVSConfig
from repro.core.chamvs import search_single as jax_search_single
from repro_torch import convert
from repro_torch.core import chamvs as tchamvs
from repro_torch.core.chamvs import ChamVSConfig
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.retrieval import (RetrievalService, ServiceConfig,
                                   ShardRouter)
from repro_torch.retrieval.router import place_table

REL = dict(rtol=1e-5, atol=1e-5)

# (data, model) mesh -> the reference test's index and search shapes
POOLS = {
    "4x2": dict(mesh=(4, 2), dim=64, nlist=64, m=8, list_cap=128, n=8192,
                shards=4, nprobe=16, k=20),
    "2x4": dict(mesh=(2, 4), dim=32, nlist=32, m=8, list_cap=256, n=4096,
                shards=2, nprobe=8, k=10),
}


def _np(x):
    return np.array(x)


@pytest.fixture(scope="module")
def pool(request):
    """The reference's index for this mesh shape, converted, and one
    ``ShardRouter`` over the mesh with the shards and quantizers placed.
    Closing it must leave no node process behind."""
    p = POOLS[request.param]
    key = jax.random.PRNGKey(0)
    icfg = jivf.IVFPQConfig(dim=p["dim"], nlist=p["nlist"], m=p["m"],
                            list_cap=p["list_cap"])
    vecs = jax.random.normal(key, (p["n"], p["dim"]))
    params = jivf.train_ivfpq(key, vecs[:p["n"] // 2], icfg, kmeans_iters=6)
    shards = jivf.build_shards(params, np.asarray(vecs), icfg,
                               num_shards=p["shards"])
    jcfg = JaxChamVSConfig(ivfpq=icfg, nprobe=p["nprobe"], k=p["k"],
                           backend="ref")
    tparams = convert.ivfpq_params(_np(params.coarse_centroids),
                                   _np(params.codebooks))
    tshards = convert.ivfpq_shards(
        [(_np(s.codes), _np(s.ids), _np(s.list_len)) for s in shards])
    tcfg = ChamVSConfig(ivfpq=convert.index_config(dataclasses.asdict(icfg)),
                        nprobe=p["nprobe"], k=p["k"])
    data, model = p["mesh"]
    mesh = make_mesh_for(data=data, model=model, device="cpu")
    router = ShardRouter(mesh, tcfg, db_axes=("data",), query_axis="model")
    assert router.fabric.size == data * model and all(router.fabric.alive())
    stacked = router.place_shards(tshards)
    placed = router.place_params(tparams)
    yield dict(p, mesh=mesh, router=router, stacked=stacked, placed=placed,
               params=params, shards=shards, jcfg=jcfg, tparams=tparams,
               tshards=tshards, tcfg=tcfg)
    pids = router.fabric.pids
    router.close()
    assert not any(router.fabric.alive())
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def _queries(p, nq):
    q = jax.random.normal(jax.random.PRNGKey(1), (nq, p["dim"]))
    return q, torch.from_numpy(_np(q))


def _check(p, q, dists, ids):
    d0, i0 = jax_search_single(p["params"], p["shards"], q, p["jcfg"])
    np.testing.assert_array_equal(ids.numpy(), _np(i0))
    np.testing.assert_allclose(dists.numpy(), _np(d0), **REL)


@pytest.mark.parametrize("pool", ["4x2"], indirect=True)
@pytest.mark.parametrize("placed_params", [True, False])
def test_search_matches_single(pool, placed_params):
    """The query split (16 queries over 2 columns, 4 shards) through the
    deprecated wrapper, with the quantizers placed or sent along, equals
    the reference's single-process search; one search call is one round
    trip to all 8 nodes."""
    p = pool
    q, tq = _queries(p, 16)
    with pytest.warns(DeprecationWarning, match="build_search"):
        search = tchamvs.make_distributed_search(
            p["mesh"], p["tcfg"], db_axes=("data",), query_axis="model")
    fabric = p["router"].fabric
    before = fabric.counters["search"].round_trips \
        if "search" in fabric.counters else 0
    params = p["placed"] if placed_params else p["tparams"]
    dists, ids = search(params, p["stacked"], tq)
    assert dists.shape == ids.shape == (16, p["k"])
    _check(p, q, dists, ids)
    assert fabric.counters["search"].round_trips == before + 1
    assert all(s["searches"] >= 1 for s in fabric.stats())


@pytest.mark.parametrize("pool", ["4x2"], indirect=True)
def test_router_search_matches_single(pool):
    """The same through ``ShardRouter.search``."""
    p = pool
    q, tq = _queries(p, 16)
    dists, ids = p["router"].search(p["placed"], p["stacked"], tq)
    _check(p, q, dists, ids)


@pytest.mark.parametrize("pool", ["2x4"], indirect=True)
def test_probe_split_search(pool):
    """Batch 1 on 4 columns: nprobe 8 splits 2 per column, and the merge
    spans 2 shards x 4 columns."""
    p = pool
    q, tq = _queries(p, 1)
    with pytest.warns(DeprecationWarning):
        search = tchamvs.make_distributed_search(
            p["mesh"], p["tcfg"], db_axes=("data",), query_axis="model",
            nq=1)
    dists, ids = search(p["placed"], p["stacked"], tq)
    _check(p, q, dists, ids)


@pytest.mark.parametrize("pool", ["4x2"], indirect=True)
def test_distributed_retrieval_service(pool):
    """A ``RetrievalService`` over the router: two submissions (5 rows)
    coalesce into one batch padded to 6 for the 2-column query split,
    and slice back to 5 rows equal to the reference's search."""
    p = pool
    router = p["router"]
    assert router.query_size == 2
    svc = RetrievalService.distributed(router, p["tparams"], p["tshards"],
                                       ServiceConfig(bucket_pow2=False))
    assert svc.pipeline.row_multiple == 2 and svc._bucket(5) == 6
    q, tq = _queries(p, 5)
    h1, h2 = svc.submit(tq[:2]), svc.submit(tq[2:])
    svc.flush()
    d1 = torch.cat([h1.result()[0], h2.result()[0]])
    i1 = torch.cat([h1.result()[1], h2.result()[1]])
    assert svc.stats.num_batches == 1 and svc.stats.max_coalesced == 5
    _check(p, q, d1, i1)


@pytest.mark.parametrize("pool", ["4x2"], indirect=True)
def test_distributed_gather(pool):
    """A table split over ("data", "model") (8 slices of 100 rows): ids
    at both ends and in the middle gather to ``table[ids]``, through the
    deprecated wrapper."""
    p = pool
    table = torch.arange(800, dtype=torch.int32) * 3
    placed = place_table(p["router"].fabric, p["mesh"], table,
                         ("data", "model"))
    assert placed.nloc == 100
    ids = torch.tensor([[0, 799, 400], [123, 7, 650]], dtype=torch.int32)
    with pytest.warns(DeprecationWarning, match="build_gather"):
        gather = tchamvs.make_distributed_gather(p["mesh"],
                                                 ("data", "model"))
    torch.testing.assert_close(gather(placed, ids), table[ids.long()])


@pytest.mark.parametrize("pool", ["4x2"], indirect=True)
@pytest.mark.parametrize("rows", [803, 200_003])
def test_distributed_chunk_gather(pool, rows):
    """A 2-D chunk table through ``ShardRouter.place_table`` (padded to a
    multiple of the 4 shards) gathers whole rows at both ends and at the
    slice edges. At 200 003 rows each node's slice (1.2 MB) is larger
    than a packed message, so its placement sends the tensor after the
    message's JSON."""
    p = pool
    g = torch.Generator().manual_seed(3)
    table = torch.randint(0, 1000, (rows, 6), generator=g, dtype=torch.int32)
    placed = p["router"].place_table(table)
    nloc = -(-rows // 4)
    assert placed.shape == (4 * nloc, 6) and placed.nloc == nloc
    ids = torch.tensor([[0, rows - 1, nloc], [nloc - 1, 2 * nloc,
                                              3 * nloc - 1]],
                       dtype=torch.int32)
    out = p["router"].gather(placed, ids)
    assert out.shape == (2, 3, 6)
    torch.testing.assert_close(out, table[ids.long()])


@pytest.mark.parametrize("pool", ["4x2"], indirect=True)
def test_placement_rules(pool):
    """A shard count that does not match the db axes raises, as in the
    reference; a search over shards placed on other axes raises."""
    p = pool
    with pytest.raises(ValueError, match="one shard per memory node"):
        p["router"].place_shards(p["tshards"][:2])
    with pytest.raises(ValueError, match="do not split"):
        place_table(p["router"].fabric, p["mesh"], torch.zeros(7),
                    ("data", "model"))
