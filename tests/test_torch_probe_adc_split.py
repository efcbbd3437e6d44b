"""The rules the IVF probe's and adc_scan's splits rest on, on the CPU.

The CUDA IVF probe splits the centroids between blocks; each keeps the
nprobe smallest keys (distance, centroid id) of its split, and a tree of
merging blocks (``ivf_scan.ops.merge_plan``) reduces the splits' lists
to one. The CUDA ``adc_scan`` cuts each entry's valid rows into even
chunks; each keeps the k smallest (distance, row) of its chunk, and the
entry's last block merges the chunks' lists. Here the same splits run
through the plain versions, cut anywhere (hypothesis draws the cuts,
ties included) and where the kernels cut, and the merged lists must
equal one plain scan and the JAX package's. Also here: the in-place
wrapper ``probed_adc_topk`` against the gathered ``pq_adc_topk`` and the
JAX kernel leg, and the host functions that pick the two grids.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from repro.core import ivfpq as jivf
from repro.kernels.pq_adc.ops import pq_adc_topk as jax_adc_topk
from repro.kernels.registry import PALLAS_INTERPRET, REF
from repro_torch.kernels.ivf_scan import ops as iv
from repro_torch.kernels.ivf_scan.ref import ref_ivf_scan
from repro_torch.kernels.pq_adc import ops as pq
from repro_torch.kernels.pq_adc.ref import ref_pq_adc_topk

INT_MAX = 2 ** 31 - 1


def _merge(lists, k):
    """The k smallest of several (dists, ids) lists [rows, *] by (distance,
    id), -1 ids (empty slots) last; (+inf, -1) past the candidates."""
    d = torch.cat([x[0] for x in lists], -1)
    a = torch.cat([x[1] for x in lists], -1).long()
    a = torch.where(a < 0, torch.full_like(a, INT_MAX), a)
    o = torch.sort(a, dim=-1, stable=True).indices
    d, a = torch.gather(d, -1, o), torch.gather(a, -1, o)
    o = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    d, a = torch.gather(d, -1, o), torch.gather(a, -1, o)
    if d.shape[-1] < k:
        pad = (*d.shape[:-1], k - d.shape[-1])
        d = torch.cat([d, torch.full(pad, float("inf"))], -1)
        a = torch.cat([a, torch.full(pad, INT_MAX)], -1)
    return d, torch.where(torch.isinf(d), torch.full_like(a, -1),
                          a).int()


def _tree_merge(lists, k, fan_in):
    """The kernel's merge order: groups of ``fan_in`` lists merged level by
    level until one is left."""
    while len(lists) > 1:
        lists = [_merge(lists[i:i + fan_in], k)
                 for i in range(0, len(lists), fan_in)]
    return lists[0]


# ---------------------------------------------------------------------------
# IVF probe
# ---------------------------------------------------------------------------

NQ, NLIST, D = 6, 40, 16


def _ivf_inputs(seed):
    """Small integer coordinates, so that every distance is exact in both
    packages, and every centroid twice (ids c and c + NLIST // 2): exact
    ties that a cut can separate."""
    rng = np.random.default_rng(seed)
    half = rng.integers(-3, 4, (NLIST // 2, D)).astype(np.float32)
    cents = np.concatenate([half, half])
    queries = rng.integers(-3, 4, (NQ, D)).astype(np.float32)
    return queries, cents


def _ivf_split(q, c, cuts, nprobe, fan_in):
    """Each split's plain top-nprobe with global ids, tree-merged."""
    edges = [0] + sorted(cuts) + [NLIST]
    lists = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        d, i = ref_ivf_scan(q, c[lo:hi], nprobe)
        lists.append((d, torch.where(i < 0, i, i + lo)))
    return _tree_merge(lists, nprobe, fan_in)


def _check_ivf(seed, cuts, nprobe, fan_in):
    queries, cents = _ivf_inputs(seed)
    q, c = torch.from_numpy(queries), torch.from_numpy(cents)
    got_d, got_i = _ivf_split(q, c, cuts, nprobe, fan_in)
    want_d, want_i = ref_ivf_scan(q, c, nprobe)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d, want_d)
    params = jivf.IVFPQParams(jnp.asarray(cents),
                              jnp.zeros((4, 256, D // 4), jnp.float32))
    jd, ji = jivf.scan_ivf_index(params, jnp.asarray(queries),
                                 min(nprobe, NLIST))
    keep = min(nprobe, NLIST)
    np.testing.assert_array_equal(got_i[:, :keep].numpy(), np.array(ji))
    np.testing.assert_allclose(got_d[:, :keep].numpy(), np.array(jd),
                               rtol=1e-5, atol=1e-5)
    assert (got_i[:, keep:] == -1).all()


@given(seed=st.integers(0, 2 ** 16),
       cuts=st.lists(st.integers(0, NLIST), min_size=0, max_size=6),
       nprobe=st.sampled_from([1, 4, 8, 40]),
       fan_in=st.sampled_from([2, 3, iv.FAN_IN]))
def test_ivf_split_anywhere_then_merge_equals_one_scan(seed, cuts, nprobe,
                                                       fan_in):
    _check_ivf(seed, cuts, nprobe, fan_in)


@pytest.mark.parametrize("tile_c,nprobe", [(32, 8), (32, 40), (64, 4)])
def test_ivf_kernel_split_then_merge_equals_one_scan(tile_c, nprobe):
    """The kernel's cuts (``probe_grid``): whole tiles a block; at 32
    centroids a block the ties c, c + 20 of the fixture fall in two
    splits, and nprobe 40 exceeds what a split holds."""
    _, per, splits = iv.probe_grid(NQ, NLIST, 132, tile_c)
    cuts = list(range(per, NLIST, per))
    assert len(cuts) == splits - 1
    _check_ivf(3, cuts, nprobe, iv.FAN_IN)


def test_ivf_grid_choice():
    assert iv.probe_grid(32, 256, 132) == (16, 32, 8)      # serve: 16 blocks
    assert iv.probe_grid(32, 32768, 132) == (32, 128, 256)  # SYN-512's nlist
    assert iv.probe_grid(64, 32768, 132) == (32, 256, 128)  # two query tiles
    assert iv.probe_grid(5, 7, 132) == (16, 32, 1)         # one tile
    assert iv.probe_grid(9, 300, 132, tile_c=40) == (16, 64, 5)
    assert iv.probe_grid(40, 5000, 132, tile_c=32) == (32, 32, 157)
    assert iv.merge_plan(1) == (0, 0)                      # no merge
    assert iv.merge_plan(4) == (4, 1)
    assert iv.merge_plan(8) == (10, 3)                     # 8 -> 2 -> 1
    assert iv.merge_plan(17) == (24, 8)                    # 17 -> 5 -> 2 -> 1
    assert iv.merge_plan(256) == (340, 85)                 # 256 -> 64 -> ...


# ---------------------------------------------------------------------------
# adc_scan
# ---------------------------------------------------------------------------

B, N, M, KSUB = 4, 256, 8, 16


def _adc_inputs(seed):
    """Integer LUT values (exact sums) and duplicated rows (exact ties);
    an empty entry, one shorter than k, one full."""
    rng = np.random.default_rng(seed)
    luts = rng.integers(0, 3, (B, M, KSUB)).astype(np.float32)
    codes = rng.integers(0, KSUB, (B, N, M)).astype(np.uint8)
    codes[:, N // 2:] = codes[:, :N // 2]
    lens = np.array([0, 5, rng.integers(0, N + 1), N], np.int32)
    return luts, codes, lens


def _adc_chunks(luts, codes, lens, bounds, k):
    """Each entry's rows cut at ``bounds(len)`` (a list of row edges),
    each chunk's plain top-k with the row as the id, then merged."""
    out = []
    for b in range(B):
        n = int(lens[b])
        edges = bounds(n)
        lists = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            d, i = ref_pq_adc_topk(luts[b:b + 1], codes[b:b + 1, lo:],
                                   torch.tensor([hi - lo], dtype=torch.int32),
                                   k)
            lists.append((d, torch.where(i < 0, i, i + lo)))
        out.append(_merge(lists, k))
    return (torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out]))


def _check_adc(seed, bounds, k):
    luts, codes, lens = _adc_inputs(seed)
    got_d, got_i = _adc_chunks(torch.from_numpy(luts),
                               torch.from_numpy(codes),
                               torch.from_numpy(lens), bounds, k)
    want_d, want_i = ref_pq_adc_topk(torch.from_numpy(luts),
                                     torch.from_numpy(codes),
                                     torch.from_numpy(lens), k)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    jd, ji = jax_adc_topk(jnp.asarray(luts), jnp.asarray(codes),
                          jnp.asarray(lens), k, tile_n=128,
                          spec=PALLAS_INTERPRET)
    np.testing.assert_array_equal(got_i.numpy(), np.array(ji))
    np.testing.assert_array_equal(got_d.numpy(), np.array(jd))


def _kernel_bounds(rows):
    """adc_scan's chunks: parts = ceil(len / rows) (one for an empty
    entry), chunk c = [len * c // parts, len * (c + 1) // parts)."""
    def bounds(n):
        parts = max(1, -(-n // rows))
        return [n * c // parts for c in range(parts + 1)]
    return bounds


@given(seed=st.integers(0, 2 ** 16),
       cuts=st.lists(st.integers(0, N), min_size=0, max_size=5),
       k=st.sampled_from([1, 6, 40]))
def test_adc_split_anywhere_then_merge_equals_one_scan(seed, cuts, k):
    _check_adc(seed, lambda n: [0] + sorted(min(c, n) for c in cuts) + [n],
               k)


@pytest.mark.parametrize("rows,k", [(256, 10), (60, 10), (17, 40), (1, 3)])
def test_adc_kernel_chunks_then_merge_equals_one_scan(rows, k):
    """The kernel's even chunks, from one part a list down to one row a
    part: chunks that end mid-round, an entry shorter than k, an empty
    one."""
    _check_adc(11, _kernel_bounds(rows), k)


def test_adc_kernel_chunks_are_even_and_agree_from_the_length():
    bounds = _kernel_bounds(4096)
    assert bounds(0) == [0, 0]                 # empty: one part, no rows
    assert bounds(4096) == [0, 4096]
    assert bounds(8193) == [0, 2731, 5462, 8193]
    assert bounds(14953) == [0, 3738, 7476, 11214, 14953]


def test_adc_chunk_choice():
    assert pq.adc_chunk_rows(1024, 14976, 132) == 14523    # serve: 2 a list
    assert pq.adc_chunk_rows(64, 14976, 132) == 4096       # the floor
    assert pq.adc_chunk_rows(8, 300, 132) == 300           # one chunk
    assert pq.adc_chunk_rows(4, 0, 132) == 1


# ---------------------------------------------------------------------------
# the in-place wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("residual", [False, True], ids=["flat", "resid"])
def test_probed_adc_equals_gathered_and_jax_kernel_leg(residual):
    """``probed_adc_topk`` from a shard's [nlist, cap, m] table and the
    probe ids equals ``pq_adc_topk`` over the gathered lists, and the JAX
    wrapper (Pallas in interpret mode and the ref leg) on them; the LUTs
    come in as a non-residual index's stride-0 view or one per entry."""
    rng = np.random.default_rng(21)
    nlist, cap, nq, nprobe, k = 6, 128, 3, 4, 20
    codes = rng.integers(0, KSUB, (nlist, cap, M)).astype(np.uint8)
    codes[:, cap // 2:] = codes[:, :cap // 2]             # ties
    lens = rng.integers(0, cap + 1, (nlist,)).astype(np.int32)
    lens[2] = 0
    probe = np.stack([rng.permutation(nlist)[:nprobe]
                      for _ in range(nq)]).astype(np.int32)
    probe[0, 0] = 2                                        # an empty list
    if residual:
        luts = torch.from_numpy(rng.integers(0, 3, (nq, nprobe, M, KSUB))
                                .astype(np.float32))
    else:
        luts = torch.from_numpy(rng.integers(0, 3, (nq, 1, M, KSUB))
                                .astype(np.float32)
                                ).expand(nq, nprobe, M, KSUB)
    td, ti = pq.probed_adc_topk(luts, torch.from_numpy(codes),
                                torch.from_numpy(lens),
                                torch.from_numpy(probe), k)
    assert td.shape == ti.shape == (nq, nprobe, k)
    g_luts = luts.reshape(nq * nprobe, M, KSUB).contiguous()
    g_codes = codes[probe.reshape(-1)]                     # [B, cap, M]
    g_lens = lens[probe.reshape(-1)]
    gd, gi = pq.pq_adc_topk(g_luts, torch.from_numpy(g_codes),
                            torch.from_numpy(g_lens), k)
    assert torch.equal(ti.reshape(-1, k), gi)
    assert torch.equal(td.reshape(-1, k), gd)
    for spec in (PALLAS_INTERPRET, REF):
        jd, ji = jax_adc_topk(jnp.asarray(g_luts.numpy()),
                              jnp.asarray(g_codes), jnp.asarray(g_lens), k,
                              tile_n=64, spec=spec)
        np.testing.assert_array_equal(gi.numpy(), np.array(ji))
        np.testing.assert_array_equal(gd.numpy(), np.array(jd))
    assert (ti[0, 0] == -1).all()
