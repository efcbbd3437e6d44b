"""The port's PQ ADC scans against the JAX package, on the CPU.

``pq_adc_topk`` (the staged per-shard scan) and ``pq_shared_scan`` take
their plain versions here; the same numpy-seeded inputs go through the
JAX wrappers with the Pallas kernels in interpret mode and with the
reference's ``ref`` backend. Row ids must be identical; distances agree
within the reference's own tolerance (1e-5 for the ADC scan, 1e-4 for
the shared scan: the JAX ``ref`` sums in XLA's order, the port in index
order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chamvs as jchamvs
from repro.core import ivfpq as jivf
from repro.kernels.pq_adc.ops import pq_adc_topk as jax_adc_topk
from repro.kernels.pq_adc.ops import pq_shared_scan as jax_shared_scan
from repro.kernels.registry import PALLAS_INTERPRET, REF
from repro_torch import convert
from repro_torch.core.chamvs import ChamVSConfig, shard_search
from repro_torch.kernels.pq_adc import ops as tpq
from repro_torch.kernels.pq_adc import ref as tref

REL = dict(rtol=1e-5, atol=1e-5)


def _both_jax(luts, codes, lens, k):
    args = (jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(lens), k)
    return [jax_adc_topk(*args, tile_n=256, spec=spec)
            for spec in (PALLAS_INTERPRET, REF)]


def _port(luts, codes, lens, k):
    return tpq.pq_adc_topk(torch.from_numpy(luts), torch.from_numpy(codes),
                           torch.from_numpy(lens), k)


@pytest.mark.parametrize("nbits,m,n", [(4, 4, 128), (8, 4, 1000),
                                       (4, 32, 128), (8, 32, 1000)])
def test_adc_topk_matches_jax(nbits, m, n):
    ksub, B, k = 1 << nbits, 3, 10
    rng = np.random.default_rng(m * n + nbits)
    luts = rng.normal(size=(B, m, ksub)).astype(np.float32)
    codes = rng.integers(0, ksub, size=(B, n, m)).astype(np.uint8)
    lens = np.array([n, max(n // 2, 1), min(k - 1, n)], np.int32)
    td, ti = _port(luts, codes, lens, k)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    for jd, ji in _both_jax(luts, codes, lens, k):
        np.testing.assert_array_equal(ti.numpy(), np.array(ji))
        np.testing.assert_allclose(td.numpy(), np.array(jd), **REL)
    assert (ti.numpy()[2, k - 1:] == -1).all()           # lens < k
    assert np.isinf(td.numpy()[2, k - 1:]).all()


def test_adc_topk_ties_go_to_the_lower_row():
    """Duplicated rows and integer LUT values give exactly equal
    distances; the lower row wins, as in the Pallas argmin and the
    stable ``lax.top_k``."""
    B, n, m, ksub, k = 4, 200, 8, 16, 40
    rng = np.random.default_rng(5)
    luts = rng.integers(0, 3, size=(B, m, ksub)).astype(np.float32)
    codes = rng.integers(0, ksub, size=(B, n, m)).astype(np.uint8)
    codes[:, 100:] = codes[:, :100]                  # rows r and r+100 tie
    lens = np.array([200, 150, 100, 0], np.int32)
    td, ti = _port(luts, codes, lens, k)
    for jd, ji in _both_jax(luts, codes, lens, k):
        np.testing.assert_array_equal(ti.numpy(), np.array(ji))
        np.testing.assert_array_equal(td.numpy(), np.array(jd))
    d = td.numpy()
    assert ((d[:, 1:] == d[:, :-1]) & np.isfinite(d[:, 1:])).any()
    assert (ti.numpy()[3] == -1).all()               # an empty entry


def test_adc_topk_bf16_luts_keep_their_dtype():
    """On the CPU the wrapper follows the JAX wrapper: bf16 LUTs give
    bf16 distances (the JAX test's bf16 tolerance)."""
    B, n, m, ksub, k = 2, 512, 8, 16, 5
    rng = np.random.default_rng(6)
    luts = rng.normal(size=(B, m, ksub)).astype(np.float32)
    codes = rng.integers(0, ksub, size=(B, n, m)).astype(np.uint8)
    lens = np.full((B,), n, np.int32)
    td, _ = tpq.pq_adc_topk(torch.from_numpy(luts).bfloat16(),
                            torch.from_numpy(codes), torch.from_numpy(lens),
                            k)
    jd, _ = jax_adc_topk(jnp.asarray(luts, jnp.bfloat16), jnp.asarray(codes),
                         jnp.asarray(lens), k, spec=PALLAS_INTERPRET)
    assert td.dtype == torch.bfloat16
    np.testing.assert_allclose(td.float().numpy(),
                               np.array(jd, np.float32), rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("q,n,m,ksub", [(4, 512, 8, 16), (16, 300, 16, 16),
                                        (2, 128, 4, 256)])
def test_shared_scan_matches_jax(q, n, m, ksub):
    rng = np.random.default_rng(q * n + m)
    luts = rng.normal(size=(q, m, ksub)).astype(np.float32)
    codes = rng.integers(0, ksub, size=(n, m)).astype(np.uint8)
    out = tpq.pq_shared_scan(torch.from_numpy(luts), torch.from_numpy(codes))
    assert out.shape == (n, q) and out.dtype == torch.float32
    for spec in (PALLAS_INTERPRET, REF):
        want = jax_shared_scan(jnp.asarray(luts), jnp.asarray(codes),
                               tile_n=128, spec=spec)
        np.testing.assert_allclose(out.numpy(), np.array(want), rtol=1e-4,
                                   atol=1e-4)
    # the shared scan is the per-entry ADC with one slab for every query
    per_q = tref.ref_adc_batch(torch.from_numpy(luts),
                               torch.from_numpy(codes).expand(q, n, m))
    assert torch.equal(out, per_q.T)


@pytest.mark.parametrize("residual", [False, True], ids=["flat", "resid"])
def test_staged_shard_search_matches_jax_kernel_leg(residual):
    """``shard_search`` follows the reference's kernel leg (LUTs ->
    gathered lists -> ``pq_adc_topk`` -> global ids -> top-kk): ids
    identical to the JAX Pallas leg (interpret) and to its ref leg."""
    rng = np.random.default_rng(7)
    D, nlist, m, cap, nq, nprobe, kk = 32, 8, 8, 96, 5, 3, 20
    icfg = jivf.IVFPQConfig(dim=D, nlist=nlist, m=m, list_cap=cap,
                            residual=residual)
    cents = rng.normal(size=(nlist, D)).astype(np.float32)
    books = rng.normal(size=(m, 256, D // m)).astype(np.float32)
    lens = rng.integers(0, cap + 1, size=(nlist,)).astype(np.int32)
    lens[0] = 0
    codes = rng.integers(0, 256, size=(nlist, cap, m)).astype(np.uint8)
    ids = np.where(np.arange(cap)[None] < lens[:, None],
                   np.arange(nlist * cap).reshape(nlist, cap),
                   -1).astype(np.int32)
    queries = rng.normal(size=(nq, D)).astype(np.float32)
    probe = np.stack([rng.permutation(nlist)[:nprobe]
                      for _ in range(nq)]).astype(np.int32)
    probe[0, 0] = 0                                  # an empty list
    jparams = jivf.IVFPQParams(jnp.asarray(cents), jnp.asarray(books))
    jshard = jivf.IVFPQShard(jnp.asarray(codes), jnp.asarray(ids),
                             jnp.asarray(lens))
    jcfg = jchamvs.ChamVSConfig(ivfpq=icfg, nprobe=nprobe, k=kk)
    tcfg = ChamVSConfig(ivfpq=convert.index_config(dataclasses.asdict(icfg)),
                        nprobe=nprobe, k=kk)
    td, ti = shard_search(convert.ivfpq_params(cents, books),
                          convert.ivfpq_shards([(codes, ids, lens)])[0],
                          torch.from_numpy(queries), torch.from_numpy(probe),
                          tcfg, kk)
    for backend in ("pallas", "ref"):
        jd, ji = jchamvs.shard_search(
            jparams, jshard, jnp.asarray(queries), jnp.asarray(probe),
            dataclasses.replace(jcfg, backend=backend), kk)
        np.testing.assert_array_equal(ti.numpy(), np.array(ji))
        np.testing.assert_allclose(td.numpy(), np.array(jd), **REL)
