"""The rule the fused scan's split rests on, on the CPU.

The CUDA scan splits each (shard, query)'s probed rows between several
blocks, each keeping its own top-kk under the key (distance, global
arrival index = probe * cap + row), and merges the blocks' kk-lists by
that key. Here the same split runs through the plain version: each group
of rows is scanned by ``ref_chamvs_scan`` (with the global arrival index
as the id it carries), the groups' lists are merged by (distance,
arrival), and the result must equal ``ref_chamvs_scan`` over every probe,
array for array, ties included. The group boundaries are drawn by
hypothesis in arrival space, and also put where the kernel puts them (an
even share of each (shard, query)'s valid rows). Also here: the grid
choices of the two redesigned kernels, which are host arithmetic.
"""
import numpy as np
import torch
from hypothesis import given, strategies as st

from repro_torch.kernels.chamvs_scan import ops as cs
from repro_torch.kernels.chamvs_scan.ref import ref_chamvs_scan
from repro_torch.kernels.decode_attn import ops as da

S, NQ, NP, CAP, M, KSUB = 2, 3, 5, 24, 4, 8


def _inputs(seed):
    """Gathered probed lists [S, NQ, NP, CAP, M] with every row twice and
    coarse LUT values, so that equal distances are common."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, KSUB, (S, NQ, NP, CAP, M)).astype(np.uint8)
    codes[..., 1::2, :] = codes[..., 0::2, :]
    lens = rng.integers(0, CAP + 1, (S, NQ, NP)).astype(np.int32)
    luts = (np.round(rng.random((NQ, NP, M, KSUB)) * 4) / 4).astype(
        np.float32)
    gids = rng.permutation(S * NQ * NP * CAP).astype(np.int32).reshape(
        S, NQ, NP, CAP)
    return (torch.from_numpy(luts), torch.from_numpy(codes),
            torch.from_numpy(gids), torch.from_numpy(lens))


def _group_scan(luts, codes, lens, a0, a1, kk):
    """``ref_chamvs_scan`` over the rows whose arrival index lies in
    [a0, a1) ([S, NQ] each), carrying the arrival index as the id."""
    p_first = torch.arange(NP)[None, None, :] * CAP          # [1, 1, NP]
    r0 = (a0[..., None] - p_first).clamp(0, CAP)             # [S, NQ, NP]
    r1 = (a1[..., None] - p_first).clamp(0, CAP)
    rows = (r0[..., None] + torch.arange(CAP)).clamp(max=CAP - 1)
    g_codes = torch.gather(codes, 3, rows[..., None].expand(
        -1, -1, -1, -1, M).long())
    g_lens = (torch.minimum(lens, r1) - r0).clamp(min=0).int()
    arrival = (p_first[..., None] + rows).int()              # global
    return ref_chamvs_scan(luts, g_codes, arrival, g_lens, kk)


def _merge(parts, gids, kk):
    """The kk smallest of the groups' lists by (distance, arrival), with
    the arrival index mapped back to the global id (-1 past the valid)."""
    d = torch.cat([p[0] for p in parts], -1)
    a = torch.cat([p[1] for p in parts], -1).long()
    a = torch.where(a < 0, torch.full_like(a, NP * CAP), a)
    o = torch.sort(a, dim=-1, stable=True).indices
    d, a = torch.gather(d, -1, o), torch.gather(a, -1, o)
    o = torch.sort(d, dim=-1, stable=True).indices[..., :kk]
    d, a = torch.gather(d, -1, o), torch.gather(a, -1, o)
    flat = gids.reshape(S, NQ, NP * CAP)
    ids = torch.gather(flat, -1, a.clamp(max=NP * CAP - 1))
    return d, torch.where(torch.isinf(d), torch.full_like(ids, -1), ids)


def _kernel_cuts(lens, groups):
    """Where the kernel splits: group g of a (shard, query) takes its
    valid rows [total * g // groups, total * (g + 1) // groups), probe
    after probe; returned as arrival indices [groups + 1, S, NQ]."""
    pref = torch.cat([torch.zeros(S, NQ, 1, dtype=torch.long),
                      lens.long().cumsum(-1)], -1)            # [S, NQ, NP+1]
    total = pref[..., -1]
    cuts = []
    for g in range(groups + 1):
        v = total * g // groups
        p = ((pref[..., 1:] <= v[..., None]).sum(-1)).clamp(max=NP - 1)
        a = p * CAP + (v - torch.gather(pref, -1, p[..., None])[..., 0])
        cuts.append(torch.where(v >= total, torch.full_like(v, NP * CAP), a))
    return cuts


def _check(seed, cuts, kk):
    luts, codes, gids, lens = _inputs(seed)
    want_d, want_i = ref_chamvs_scan(luts, codes, gids, lens, kk)
    parts = [_group_scan(luts, codes, lens, cuts[g], cuts[g + 1], kk)
             for g in range(len(cuts) - 1)]
    got_d, got_i = _merge(parts, gids, kk)
    assert torch.equal(got_d, want_d)
    assert torch.equal(got_i, want_i)


@given(seed=st.integers(0, 2 ** 16),
       bounds=st.lists(st.integers(0, NP * CAP), min_size=0, max_size=5),
       kk=st.sampled_from([1, 5, 17, 40]))
def test_split_anywhere_then_merge_equals_one_scan(seed, bounds, kk):
    edges = [0] + sorted(bounds) + [NP * CAP]
    cuts = [torch.full((S, NQ), e, dtype=torch.long) for e in edges]
    _check(seed, cuts, kk)


@given(seed=st.integers(0, 2 ** 16), groups=st.integers(1, 7),
       kk=st.sampled_from([1, 9, 33]))
def test_kernel_split_then_merge_equals_one_scan(seed, groups, kk):
    lens = _inputs(seed)[3]
    _check(seed, _kernel_cuts(lens, groups), kk)


def test_kernel_cuts_are_even_shares_of_the_valid_rows():
    lens = torch.tensor([[[3, 0, 5, 0, 4]]]).expand(S, NQ, NP).int()
    cuts = _kernel_cuts(lens, 4)     # 12 valid rows, 3 a group: probe 0,
    # probe 2's rows 0-2, its rows 3-4 and probe 4's row 0, probe 4's rest
    assert [int(c[0, 0]) for c in cuts] == [0, 2 * CAP, 2 * CAP + 3,
                                           4 * CAP + 1, NP * CAP]


def test_scan_group_choice():
    assert cs.scan_groups(2, 32, 32, 14976, 63, 132) == 4   # the serve shape
    assert cs.scan_groups(1, 3, 2, 40, 200, 132) == 1       # tiny lists
    assert cs.scan_groups(1, 2, 64, 14976, 1792, 132) == 9  # merge-bound
    assert cs.scan_groups(2, 1024, 32, 14976, 63, 132) == 1


def test_decode_split_choice():
    assert da.pick_split(32, 8, 512, 132) == 128           # 1024 blocks
    assert da.pick_split(32, 8, 464, 132) == 128           # ragged split
    assert da.pick_split(1, 8, 512, 132) == 32             # few rows
    assert da.pick_split(32, 8, 40, 132) == 32             # one tile
    assert da.pick_split(32, 8, 512, 132, tile_n=200) == 200
    assert da.pick_split(32, 8, 512, 132, tile_n=10) == 10
