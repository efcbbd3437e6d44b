"""The sharded prefill and serve steps against the port's one-position
steps (reduced models in float32 on the CPU, the port's own seeded
weights and a residual index of one shard per data coordinate), and
their parts:

  * 4 gloo ranks at 2 x 2 (Dec-S and EncDec-S at a batch of 8, Dec-S at
    a batch of 1, and at 4: the prefill's rows split over "data" where
    the caches' are not, gathered first) and 2 ranks at 1 x 2 (Dec-S at
    8: no data axis, the vocabulary and heads split in two), each rank on
    the shards
    ``put_named`` gives it (``tests/torch_serve_ranks.py``), against the
    same steps in one process: logits of the prefill and of 3 serve
    steps within 1e-5 relative / 1e-5 absolute, the caches gathered back
    within the same bound, each search's distances within 1e-5 relative
    and its ids equal but at near ties (``ivfpq.id_swaps``: the LUT
    GEMM's rounding follows the number of queries in a column), every
    rank's resident bytes below one process's;
  * the mesh search (``router.build_mesh_search``) on seeded queries
    against ``search_stacked`` over the same column's queries: ids
    exact, distances within 1e-5 relative;
  * the partial decode attention's plain version, each of M ranges of
    the cache attended with its slot offset and merged by
    ``merge_partials``, against ``ref_decode_attention`` over the whole
    cache at M 2 and 4, grouped (4:2) and not (4:4), with ragged
    positions and ranges holding no valid slot (finite, l = 0): within
    1e-6; the same over a ring cut into 2 and 4 ranges, with and without
    a window, rows whose ring has wrapped, is not yet full, or holds one
    valid slot;
  * ``update_cache`` / ``prefill_cache`` with a slot offset write only
    the rank's range, of a linear cache and of a ring (a prompt shorter
    than the ring and one that wraps it);
  * the MoE FFN with its rows split over 2 and 4 data ranks (gathered,
    routed as one batch, the rank's rows kept) equals the one-process
    FFN over the whole batch bit for bit where the capacity drops
    assignments, which routing each rank's rows alone does not;
  * the vocabulary-split kNN-LM mix and greedy argmax against the whole
    mix.
"""
import os
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import get_arch
from repro_torch.core import rag
from repro_torch.core.chamvs import stack_shards
from repro_torch.core.ivfpq import id_swaps
from repro_torch.kernels.decode_attn import ops as da
from repro_torch.kernels.decode_attn.ref import merge_partials
from repro_torch.launch import dp
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ctx as ctx_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf
from repro_torch.models.attention import prefill_cache, update_cache
from repro_torch.retrieval.service import search_stacked
from repro_torch.serve import DatastoreBuilder

TESTS = pathlib.Path(__file__).resolve().parent
REL = dict(rtol=1e-5, atol=1e-5)
S, T0, STEPS = 32, 16, 3
DB = dict(n_vectors=4096, nlist=16, nprobe=4)
MESH_CASES = [(2, 2, "dec_s", 8), (2, 2, "encdec_s", 8), (2, 2, "dec_s", 1),
              (2, 2, "dec_s", 4), (1, 2, "dec_s", 8)]


def _case(arch, B, shards, seed):
    import torch_serve_ranks
    spec = torch_serve_ranks.spec_of(arch)
    cfg = spec.model
    g = torch.Generator().manual_seed(seed)
    ccfg = specs_lib.ServeDBSpec(**DB).for_model(cfg, shards, spec.rag.k)
    vecs = torch.randn(2048, ccfg.ivfpq.dim, generator=g)
    ds = DatastoreBuilder(dim=ccfg.ivfpq.dim, nlist=DB["nlist"],
                          m=ccfg.ivfpq.m, list_cap=ccfg.ivfpq.list_cap,
                          residual=True, num_shards=shards,
                          device="cpu").build(vecs)
    shape = ((DB["n_vectors"],) if spec.rag.mode == "knnlm"
             else (DB["n_vectors"], spec.rag.chunk_len))
    enc = spec.rag.k * spec.rag.chunk_len if cfg.arch == "encdec" else 0
    pre = {"tokens": torch.randint(0, cfg.vocab_size, (B, T0), generator=g,
                                   dtype=torch.int32),
           "positions": torch.arange(T0, dtype=torch.int32)[None]
           .expand(B, T0).contiguous()}
    if enc:
        pre["enc_embeds"] = torch.randn(B, enc, cfg.d_model, generator=g)
    steps = []
    for s in range(STEPS):
        b = {"token": torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                                    dtype=torch.int32),
             "position": torch.full((B,), T0 + s, dtype=torch.int32)}
        if enc:
            b["enc_states"] = torch.randn(B, enc, cfg.d_model, generator=g)
        steps.append(b)
    return dict(
        arch=arch, params=tf.init_params(torch.Generator().manual_seed(0),
                                         cfg),
        shapes=dict(prefill=dict(seq_len=S, global_batch=B),
                    decode=dict(seq_len=S, global_batch=B)),
        db=DB, db_params=ds.params, db_shard=stack_shards(ds.shards),
        payload=torch.randint(0, cfg.vocab_size, shape, generator=g,
                              dtype=torch.int32),
        prefill=pre, steps=steps,
        queries=torch.randn(B, ccfg.ivfpq.dim, generator=g))


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """{(data, model): (cases, per-case rank-0 results)} and the one
    position's results of each case."""
    import torch_serve_ranks
    mp = pytest.MonkeyPatch()
    mp.setenv("PYTHONPATH", os.pathsep.join(
        [str(TESTS)] + [p for p in os.environ.get("PYTHONPATH", "")
                        .split(os.pathsep) if p]))
    mp.setenv("OMP_NUM_THREADS", "1")
    tmp = tmp_path_factory.mktemp("sharded_serve_port")
    out = {}
    try:
        for D, M in sorted({(d, m) for d, m, _, _ in MESH_CASES}):
            cases = [_case(a, B, D, 7 + n) for n, (d, m, a, B)
                     in enumerate(MESH_CASES) if (d, m) == (D, M)]
            d = tmp / f"m{D}x{M}"
            d.mkdir()
            torch.save(cases, d / "cases.pt")
            dp.launch(D * M, "torch_serve_ranks:run",
                      [str(d / "cases.pt"), str(d)], device="cpu",
                      timeout_s=300, model=M)
            got = torch.load(d / "result.pt", weights_only=False)
            one = Mesh(("data", "model"), (1, 1), ("cpu",))
            want = [torch_serve_ranks.run_case(dp.Group.single("cpu"), c,
                                               mesh=one) for c in cases]
            out[(D, M)] = (cases, got, want)
    finally:
        mp.undo()
    return out


def _pick(meshes, n):
    D, M, arch, B = MESH_CASES[n]
    k = [i for i, c in enumerate(MESH_CASES) if c[:2] == (D, M)].index(n)
    cases, got, want = meshes[(D, M)]
    return cases[k], got[k], want[k]


IDS = [f"{d}x{m}_{a}_b{B}" for d, m, a, B in MESH_CASES]


@pytest.mark.parametrize("n", range(len(MESH_CASES)), ids=IDS)
def test_sharded_logits_match_one_position(meshes, n):
    _, got, want = _pick(meshes, n)
    np.testing.assert_allclose(got["prefill"].numpy(),
                               want["prefill"].numpy(), **REL)
    assert len(got["serve"]) == STEPS
    for a, b in zip(got["serve"], want["serve"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **REL)


@pytest.mark.parametrize("n", range(len(MESH_CASES)), ids=IDS)
def test_sharded_caches_and_searches_match_one_position(meshes, n):
    _, got, want = _pick(meshes, n)
    a, b = tree_lib.keyed(got["caches"]), tree_lib.keyed(want["caches"])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), **REL,
                                   err_msg=k)
    assert len(got["search"]) == len(want["search"]) == STEPS
    for (d1, i1), (d2, i2) in zip(got["search"], want["search"]):
        np.testing.assert_allclose(d1.numpy(), d2.numpy(), rtol=1e-5)
        id_swaps(d1, i1, d2, i2)       # raises on anything but a near tie


@pytest.mark.parametrize("n", range(len(MESH_CASES)), ids=IDS)
def test_mesh_search_matches_search_stacked(meshes, n):
    """The seeded queries: each model column's chunk (the query split)
    or all of them (the probe split's batch of 1) through
    ``search_stacked`` over the whole stack."""
    D, M, arch, B = MESH_CASES[n]
    case, got, _ = _pick(meshes, n)
    d, i = got["queries_search"]
    if B % M:                 # the probe split: k' over shards x columns
        assert d.shape == (B, get_arch(arch).rag.k)
        return
    ccfg = specs_lib.ServeDBSpec(**DB).for_model(
        torch_serve_ranks_spec(arch), D, get_arch(arch).rag.k)
    q = case["queries"]
    parts = [search_stacked(case["db_params"], case["db_shard"], c, ccfg)
             for c in q.chunk(M)]
    d0, i0 = (torch.cat(t) for t in zip(*parts))
    assert torch.equal(i, i0)
    np.testing.assert_allclose(d.numpy(), d0.numpy(), rtol=1e-5)


def torch_serve_ranks_spec(arch):
    import torch_serve_ranks
    return torch_serve_ranks.spec_of(arch).model


@pytest.mark.parametrize("n", range(len(MESH_CASES)), ids=IDS)
def test_sharded_ranks_hold_less(meshes, n):
    D, M, _, _ = MESH_CASES[n]
    _, got, want = _pick(meshes, n)
    assert got["resident"] < want["resident"]
    st = got["stats"][-1]
    assert st["model_mb"] > 0 and (D == 1 or st["data_mb"] > 0)


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("KV", [2, 4])
def test_partial_attention_merge_equals_whole(R, KV):
    g = torch.Generator().manual_seed(R + KV)
    W, Sc, D, H = 6, 64, 16, 4
    q = torch.randn(W, 1, H, D, generator=g)
    k = torch.randn(W, Sc, KV, D, generator=g)
    v = torch.randn(W, Sc, KV, D, generator=g)
    pos = torch.tensor([0, 5, 63, 31, 32, 17])
    n = Sc // R
    parts = [da.decode_attention_partial(
        q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n], pos,
        slot_offset=r * n) for r in range(R)]
    acc, m, l = (torch.stack(t) for t in zip(*parts))
    assert bool(torch.isfinite(acc).all() and torch.isfinite(m).all())
    assert bool((l[1:, 0] == 0).all()) and bool((acc[1:, 0] == 0).all())
    out = merge_partials(acc, m, l)
    want = da.ref_decode_attention(q, k, v, pos)[:, 0]
    assert (out - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("R", [2, 4])
def test_partial_attention_ring_merge_equals_whole(R, window):
    """A ring of 16 slots cut into ``R`` ranges: rows whose ring has
    wrapped (positions 20, 37, 50), is not yet full (3, 9, 15) or holds
    one valid slot (0)."""
    g = torch.Generator().manual_seed(R + window)
    Sc, D, H, KV = 16, 16, 4, 2
    pos = torch.tensor([20, 37, 50, 3, 9, 15, 0])
    W = pos.shape[0]
    q = torch.randn(W, 1, H, D, generator=g)
    k = torch.randn(W, Sc, KV, D, generator=g)
    v = torch.randn(W, Sc, KV, D, generator=g)
    n = Sc // R
    parts = [da.decode_attention_partial(
        q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n], pos,
        slot_offset=r * n, window=window, ring_size=Sc) for r in range(R)]
    acc, m, l = (torch.stack(t) for t in zip(*parts))
    assert bool(torch.isfinite(acc).all() and torch.isfinite(m).all())
    empty = l == 0
    assert int(empty[:, -1].all(-1).sum()) == R - 1   # position 0
    assert bool((acc[empty] == 0).all())
    out = merge_partials(acc, m, l)
    want = da.ref_decode_attention(q, k, v, pos, window=window,
                                   ring=True)[:, 0]
    assert (out - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("T", [5, 23])
@pytest.mark.parametrize("R", [2, 4])
def test_ring_writers_keep_the_rank_range(R, T):
    """Each of ``R`` ranks' ranges of a ring of 8 slots, written by
    ``prefill_cache`` (a prompt of ``T``) and ``update_cache`` (two more
    steps), equals its slice of the whole ring written the same way."""
    Sc, n = 8, 8 // R
    new = torch.arange(2 * T * 2, dtype=torch.float32).view(2, T, 1, 2) + 1
    whole_k, whole_v = torch.zeros(2, Sc, 1, 2), torch.zeros(2, Sc, 1, 2)
    prefill_cache(whole_k, whole_v, new, new, ring=True)
    mine = [(torch.zeros(2, n, 1, 2), torch.zeros(2, n, 1, 2))
            for _ in range(R)]
    for r, (kc, vc) in enumerate(mine):
        prefill_cache(kc, vc, new, new, ring=True, slot_offset=r * n,
                      ring_size=Sc)
    for step in range(2):
        tok = torch.full((2, 1, 1, 2), -1.0 - step)
        pos = torch.tensor([T + step, T + 3 + step])
        update_cache(whole_k, whole_v, tok, tok, pos, ring=True)
        for r, (kc, vc) in enumerate(mine):
            update_cache(kc, vc, tok, tok, pos, ring=True, slot_offset=r * n,
                         ring_size=Sc)
    for r, (kc, vc) in enumerate(mine):
        assert torch.equal(kc, whole_k[:, r * n:(r + 1) * n])
        assert torch.equal(vc, whole_v[:, r * n:(r + 1) * n])


class _RowGroup:
    """Rank ``rank`` of ``size`` data ranks whose all-gather returns the
    whole batch (the one-process stand-in of the rows' group)."""

    def __init__(self, rank, size, whole):
        self.rank, self.size, self.whole = rank, size, whole
        self.shape = {"data": size, "model": 1}

    def over(self, axes):
        return self

    def all_gather(self, x, dim):
        n = self.whole.shape[0] // self.size
        assert torch.equal(x, self.whole[self.rank * n:(self.rank + 1) * n])
        return self.whole.clone()


@pytest.mark.parametrize("R", [2, 4])
def test_moe_rows_split_over_data_equal_the_whole_batch(R):
    import torch_serve_ranks
    cfg = torch_serve_ranks.spec_of("phi3_5_moe_42b").model
    p = tf._layer_params(cfg, "classes/global", tf.init_params(
        torch.Generator().manual_seed(1), cfg)["classes"]["global"], 0)
    g = torch.Generator().manual_seed(R)
    B, T = 8, 16
    # tokens near one point: the routing piles up on a few experts
    x = torch.randn(1, 1, cfg.d_model, generator=g) + 0.3 * torch.randn(
        B, T, cfg.d_model, generator=g)
    E, k = cfg.n_experts, cfg.top_k
    _, ids = moe_lib.route_topk(x.reshape(B * T, -1), p["router"], k)
    assert int(torch.bincount(ids.reshape(-1), minlength=E).max()) > \
        moe_lib.capacity(B * T, E, k)
    whole = tf._ffn(cfg, p, x)
    n = B // R
    parts, alone = [], []
    for r in range(R):
        rows = x[r * n:(r + 1) * n]
        with ctx_lib.activation_sharding(
                ("data",), "model", group=_RowGroup(r, R, x), specs={},
                batch=B, caches={}):
            parts.append(tf._ffn(cfg, p, rows))
        alone.append(tf._ffn(cfg, p, rows))
    assert torch.equal(torch.cat(parts), whole)
    assert not torch.equal(torch.cat(alone), whole)


def test_cache_writers_keep_the_rank_range():
    k = torch.zeros(3, 8, 1, 2)
    v = torch.zeros(3, 8, 1, 2)
    new = torch.arange(3 * 2, dtype=torch.float32).view(3, 1, 1, 2) + 1
    update_cache(k, v, new, new, torch.tensor([7, 8, 15]), slot_offset=8)
    assert torch.equal(k[0], torch.zeros(8, 1, 2))        # before the range
    assert torch.equal(k[1, 0], new[1, 0]) and torch.equal(k[2, 7],
                                                           new[2, 0])
    assert int((k != 0).sum()) == 4
    full = torch.arange(2 * 20, dtype=torch.float32).view(1, 20, 1, 2)
    kc, vc = torch.zeros(1, 8, 1, 2), torch.zeros(1, 8, 1, 2)
    prefill_cache(kc, vc, full, full, slot_offset=16)
    assert torch.equal(kc[:, :4], full[:, 16:20])
    assert bool((kc[:, 4:] == 0).all())


def test_split_knnlm_mix_and_argmax_equal_the_whole():
    g = torch.Generator().manual_seed(3)
    B, V, K, M = 4, 40, 6, 4
    logits = torch.randn(B, V, generator=g)
    dists = torch.rand(B, K, generator=g) * 10
    toks = torch.randint(0, V, (B, K), generator=g)
    toks[0, 0], dists[1, 2] = -1, float("inf")
    whole = rag.knnlm_interpolate(logits, dists, toks, 0.25, 10.0)
    cols = logits.chunk(M, -1)
    tops = torch.stack([c.amax(-1) for c in cols]).amax(0)
    sums = torch.stack([torch.exp(c - tops[:, None]).sum(-1)
                        for c in cols]).sum(0)
    parts = [rag.knnlm_interpolate(
        c, dists, toks, 0.25, 10.0, r * (V // M), lambda x: tops,
        lambda x: sums) for r, c in enumerate(cols)]
    np.testing.assert_allclose(torch.cat(parts, -1).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-6)
    from repro_torch.models import parallel
    assert torch.equal(parallel.argmax_over_model(whole),
                       whole.argmax(-1, keepdim=True).int())
