"""The port's search tools against the JAX package, on the CPU:

  * ``ivfpq.exact_search`` with planted equal distances (duplicated
    vectors): ids exact (equal distances take the lower index first, as
    ``lax.top_k`` on ``-d`` orders them), distances within 1e-5
    relative (both packages take ``|q|^2 - 2 q.v + |v|^2`` in float32,
    each with its own GEMM's summation order; at the planted group,
    distance 8 out of terms near 64, the two differ by 7.6e-6);
    ``recall_at_k`` (within 1e-6: the reference averages in float32,
    the port in float64), ``merge_topk`` and ``search_shard_ref``
    against the reference's; ``IVFPQConfig.db_bytes_per_vector``;
  * ``chamvs.search_single`` against the reference's ``search_single``
    on the reference's index, converted: ids exact, distances within
    1e-5 relative, fused = staged; the memo's hits, misses and LRU
    eviction;
  * the quickstart twin: ``--device cpu`` in a subprocess, and its
    search-and-recall steps on the reference ``DatastoreBuilder``'s
    index over the twin's own database, whose R10@32 must equal the
    reference's (its builder and ``exact_search``) on the same data.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chamvs as jchamvs
from repro.core import ivfpq as jivf
from repro_torch import convert
from repro_torch.core import chamvs as tchamvs
from repro_torch.core import ivfpq as tivf
from repro_torch.retrieval.merge import flat_merge

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.array(x)


@pytest.fixture(scope="module")
def index():
    """The reference's small index (tests/test_chamvs_scan.py's shapes,
    list_cap raised to hold a 4-way stripe), converted."""
    key = jax.random.PRNGKey(0)
    icfg = jivf.IVFPQConfig(dim=32, nlist=16, m=8, list_cap=256)
    vecs = jax.random.normal(key, (2048, 32))
    params = jivf.train_ivfpq(key, vecs[:1024], icfg, kmeans_iters=4)
    shards = jivf.build_shards(params, np.asarray(vecs), icfg, num_shards=4)
    q = jax.random.normal(jax.random.PRNGKey(1), (6, 32))
    tparams = convert.ivfpq_params(_np(params.coarse_centroids),
                                   _np(params.codebooks))
    tshards = convert.ivfpq_shards(
        [(_np(s.codes), _np(s.ids), _np(s.list_len)) for s in shards])
    return dict(icfg=icfg, params=params, shards=shards, q=q,
                ticfg=convert.index_config(dataclasses.asdict(icfg)),
                tparams=tparams, tshards=tshards,
                tq=torch.from_numpy(_np(q)))


def test_exact_search_matches_jax_with_planted_ties():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((3000, 32)).astype(np.float32)
    vecs[100:112] = vecs[7]                 # 13 vectors at equal distance
    vecs[2990:] = vecs[1500]
    queries = rng.standard_normal((16, 32)).astype(np.float32)
    queries[:4] = vecs[7] + 0.5             # the tied group in every top-k
    queries[4:6] = vecs[1500] - 0.25
    d0, i0 = jivf.exact_search(jnp.asarray(vecs), jnp.asarray(queries), 20)
    d, i = tivf.exact_search(torch.from_numpy(vecs),
                             torch.from_numpy(queries), 20)
    np.testing.assert_array_equal(i.numpy(), _np(i0))
    np.testing.assert_allclose(d.numpy(), _np(d0), rtol=1e-5, atol=0)
    assert i.dtype == torch.int32
    tied = i[0].tolist()
    assert tied[:13] == [7] + list(range(100, 112))     # lower index first


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(1)
    true = np.stack([rng.permutation(500)[:10] for _ in range(24)])
    found = np.concatenate([true[:, rng.permutation(10)[:6]],
                            rng.integers(500, 900, (24, 26))], 1)
    found[::3, :4] = true[::3, :4]          # rows with more hits
    r0 = jivf.recall_at_k(jnp.asarray(found), jnp.asarray(true))
    r = tivf.recall_at_k(torch.from_numpy(found), torch.from_numpy(true))
    assert isinstance(r, float)
    assert r == pytest.approx(r0, rel=1e-6)
    assert tivf.recall_at_k(torch.from_numpy(true),
                            torch.from_numpy(true)) == 1.0


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(2)
    S, nq, kk, k = 4, 5, 7, 12
    d = np.sort(rng.integers(0, 6, (S, nq, kk)).astype(np.float32), -1)
    ids = rng.integers(0, 10_000, (S, nq, kk)).astype(np.int32)
    d[1, :, 5:] = np.inf                    # a short shard list
    ids[1, :, 5:] = -1
    d0, i0 = jivf.merge_topk(jnp.asarray(d), jnp.asarray(ids), k)
    dt, it = tivf.merge_topk(torch.from_numpy(d), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(it.numpy(), _np(i0))
    np.testing.assert_array_equal(dt.numpy(), _np(d0))
    df, i_f = flat_merge(torch.from_numpy(d), torch.from_numpy(ids), k)
    assert torch.equal(df, dt) and torch.equal(i_f, it)


def test_search_shard_ref_matches_jax(index):
    p = index
    _, probe = jivf.scan_ivf_index(p["params"], p["q"], 4)
    tprobe = torch.from_numpy(_np(probe)).int()
    for js, ts in zip(p["shards"], p["tshards"]):
        d0, i0 = jivf.search_shard_ref(p["params"], js, p["q"], probe,
                                       p["icfg"], 10)
        d, i = tivf.search_shard_ref(p["tparams"], ts, p["tq"], tprobe,
                                     p["ticfg"], 10)
        np.testing.assert_array_equal(i.numpy(), _np(i0))
        np.testing.assert_allclose(d.numpy(), _np(d0), **REL)


@pytest.mark.parametrize("fields", [dict(dim=512, nlist=256, m=32),
                                    dict(dim=64, nlist=64, m=16, nbits=4),
                                    dict(dim=1024, nlist=32768, m=64)])
def test_db_bytes_per_vector_matches_jax(fields):
    assert tivf.IVFPQConfig(**fields).db_bytes_per_vector() == \
        jivf.IVFPQConfig(**fields).db_bytes_per_vector()


@pytest.mark.parametrize("fused", [True, False])
def test_search_single_matches_jax(index, fused):
    p = index
    jcfg = jchamvs.ChamVSConfig(ivfpq=p["icfg"], nprobe=8, k=10,
                                backend="ref", fused=fused)
    tcfg = tchamvs.ChamVSConfig(ivfpq=p["ticfg"], nprobe=8, k=10,
                                fused=fused)
    d0, i0 = jchamvs.search_single(p["params"], p["shards"], p["q"], jcfg)
    d, i = tchamvs.search_single(p["tparams"], p["tshards"], p["tq"], tcfg)
    np.testing.assert_array_equal(i.numpy(), _np(i0))
    np.testing.assert_allclose(d.numpy(), _np(d0), **REL)
    other = dataclasses.replace(tcfg, fused=not fused)
    d2, i2 = tchamvs.search_single(p["tparams"], p["tshards"], p["tq"],
                                   other)
    assert torch.equal(i2, i)
    np.testing.assert_allclose(d2.numpy(), d.numpy(), **REL)


def test_search_single_memoizes_service(index):
    """The twin of tests/test_chamvs_scan.py's memo test, plus the LRU:
    repeated calls reuse one service, a new config is a new service, and
    the fifth key evicts the least recently used."""
    p = index
    cfg = tchamvs.ChamVSConfig(ivfpq=p["ticfg"], nprobe=4, k=8)
    memo = tchamvs._SERVICE_MEMO
    memo.clear()
    tchamvs.search_single(p["tparams"], p["tshards"], p["tq"], cfg)
    assert len(memo) == 1
    svc = next(iter(memo.values()))
    tchamvs.search_single(p["tparams"], p["tshards"], p["tq"][:2], cfg)
    assert len(memo) == 1 and next(iter(memo.values())) is svc
    cfgs = [dataclasses.replace(cfg, nprobe=n) for n in (4, 5, 6, 7)]
    for c in cfgs[1:]:
        tchamvs.search_single(p["tparams"], p["tshards"], p["tq"], c)
    assert len(memo) == tchamvs._SERVICE_MEMO_CAP == 4
    tchamvs.search_single(p["tparams"], p["tshards"], p["tq"], cfgs[0])
    assert next(reversed(memo.values())) is svc     # a hit refreshes it
    tchamvs.search_single(p["tparams"], p["tshards"], p["tq"],
                          dataclasses.replace(cfg, nprobe=9))
    assert len(memo) == 4
    assert all(k[-1] != cfgs[1] for k in memo)      # the LRU went
    assert any(v is svc for v in memo.values())
    other = [s._replace(ids=s.ids.clone()) for s in p["tshards"]]
    tchamvs.search_single(p["tparams"], other, p["tq"], cfg)
    assert sum(k[-1] == cfg for k in memo) == 2     # another index
    memo.clear()


def test_quickstart_twin_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "index: 64 lists, 4 memory nodes, 20 B/vector" in out.stdout
    recall = float(re.search(r"R10@32=([0-9.]+)", out.stdout).group(1))
    assert 0.0 < recall <= 1.0
    assert "the plain versions against themselves: ids identical=True" \
        in out.stdout
    # without a device argument it asks for the card, and refuses here
    refused = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(ROOT))
    assert refused.returncode != 0 and "GPU" in refused.stderr


def test_quickstart_recall_equals_the_reference_on_its_index():
    """The twin's database as numpy through the reference's
    ``DatastoreBuilder``, searched by both packages: the same ids and
    the same R10@32 (the twin's own builder draws other k-means seeds,
    so its index, and its recall, differ)."""
    from repro.serve import DatastoreBuilder as JaxBuilder
    from repro_torch.examples import quickstart

    vecs = quickstart.make_database()
    nv = vecs.numpy()
    jds = JaxBuilder(dim=64, nlist=64, m=16, list_cap=512, num_shards=4,
                     kmeans_iters=10, seed=0).build(nv, train_vectors=nv[:8192])
    jcfg = jds.search_config(nprobe=16, k=32, backend="ref")
    jq = jnp.asarray(nv[:32]) + 0.02
    _, jids = jds.retriever(jcfg).search(jq)
    _, jtrue = jivf.exact_search(jnp.asarray(nv), jq, 10)
    jrecall = float((jids[:, :, None] == jtrue[:, None, :]).any(1).mean())
    tds = convert.datastore(
        dataclasses.asdict(jds.index_cfg), _np(jds.params.coarse_centroids),
        _np(jds.params.codebooks),
        [(_np(s.codes), _np(s.ids), _np(s.list_len)) for s in jds.shards],
        num_vectors=jds.num_vectors)
    _, _, ids, recall = quickstart.search_recall(tds, vecs)
    np.testing.assert_array_equal(ids.numpy(), _np(jids))
    assert recall == pytest.approx(jrecall, abs=1e-7)


def test_id_swaps_accepts_near_ties_only():
    d = torch.tensor([[1.0, 2.0, 2.0000100, 5.0], [0.5, 0.6, 0.7, 0.8]])
    i = torch.tensor([[4, 9, 3, 1], [0, 1, 2, 3]])
    assert tivf.id_swaps(d, i, d.clone(), i.clone()) == 0
    swapped = torch.tensor([[4, 3, 9, 1], [0, 1, 2, 3]])
    assert tivf.id_swaps(d, swapped, d, i) == 2
    with pytest.raises(ValueError, match="outside a near tie"):
        tivf.id_swaps(d, torch.tensor([[9, 4, 3, 1], [0, 1, 2, 3]]), d, i)
    with pytest.raises(ValueError, match="outside a near tie"):
        tivf.id_swaps(d, torch.tensor([[4, 7, 3, 1], [0, 1, 2, 3]]), d, i)
    with pytest.raises(ValueError, match="distances differ"):
        tivf.id_swaps(d + 0.01, i, d, i)


@pytest.mark.parametrize("k", [1, 7, 40, 64])
def test_first_k_stable_equals_the_stable_sort(k):
    """``exact_search``'s selection (k-th value, then the lowest-indexed
    ties) against the first k of a stable sort, on rows full of ties."""
    from repro_torch.kernels.common import topk_smallest

    g = torch.Generator().manual_seed(k)
    d = torch.randint(0, 9, (6, 64), generator=g).float()
    d[2] = 3.0                                   # a row of one value
    cols = torch.arange(64, dtype=torch.int32).expand_as(d)
    got = tivf.first_k_stable(d, k)
    want = topk_smallest(d, cols, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
